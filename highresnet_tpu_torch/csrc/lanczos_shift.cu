// Fused per-image Lanczos shift for Hopper (sm_90a), taps included.
//
// Replaces highresnet_tpu/ops/lanczos_pallas.py::_fused_shift_kernel (the
// Pallas forward behind lanczos_shift_pallas / lanczos_shift_fused)
// together with the two lanczos_kernel calls that the JAX wrapper makes
// just outside it (lanczos_pallas.py:72-73):
//
//   img   : (B, H, W) float32; image b starts img_stride floats after
//           image b - 1: H * W for a contiguous batch, 0 for one (H, W)
//           image warped B ways (read once from memory, then from L2)
//   shift : (B, 2) float32, per-image (dy, dx)
//   out   : (B, H, W) float32
//   ky, kx = lanczos_kernel(dy), lanczos_kernel(dx)   (7 taps, Lanczos-3)
//   pad  = reflect-pad(img, 3)            (np.pad "reflect": index -k -> k)
//   rows = sum_t ky[t] * pad[t : t+H, :]  (vertical pass, t = 0..6)
//   out  = sum_t kx[t] * rows[:, t : t+W] (horizontal pass)
//
// H and W must be at least 4 so that a reflect pad of 3 is defined.
//
// Bound: launch latency at the training shape. One call moves 1.2 MB each
// way at (8, 192, 192), 0.7 us at 3.35 TB/s, and does 8.3 MFLOP, 0.12 us
// at the f32 peak; a launch costs a few microseconds. So the design is one
// launch for the whole warp, taps included, where the plain route takes
// about 30 (two lanczos_kernel calls of about 15 eager ops each).
//
// Design. One block of 32 x 8 threads per (row tile, image).
// - Taps: 14 threads compute the image's raw taps into shared memory as
//   lanczos_kernel does and in its order: x = (t - 3) - d for t = 0..6;
//   pi_x = 3.14159265f * x, 1e-6 where pi_x == 0; (sin(pi_x) / pi_x) *
//   (sin(pi_x / 3) / (pi_x / 3)); then each divided by the sum of its
//   axis's 7 values, summed in order. sinf and the divisions are the IEEE
//   ones (the build uses no fast-math).
// - Load: the tile plus a 3-row halo, row by row (threadIdx.y walks rows,
//   threadIdx.x columns), as float4 where W % 4 == 0 and the image is
//   16-byte aligned, else as floats. Only the halo rows above the first
//   and below the last image row are reflected.
// - Vertical pass into a second shared buffer that holds the 3-column
//   reflected halo on each side; only halo columns are reflected.
// - Horizontal pass; each warp writes consecutive floats of one row.
// Sums run in the plain version's order, vertical first, taps t = 0..6,
// each product and sum rounded on its own (__fmul_rn, __fadd_rn, no FMA
// contraction), as PyTorch's separate multiply and add kernels do. No
// division per element and no atomics; every output element has one writer.
//
// Tile height: kTileRows rows, lowered on the host while the tile and its
// halos do not fit the 48 KiB of shared memory. On an H100 at (8, 192, 192)
// 2, 4 and 8 rows ran within 4% of each other and 16 rows (96 blocks, fewer
// than the SMs) 29% slower than 4 (PERF.md); 4 rows give 384 blocks there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 7;
constexpr int kHalf = 3;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kTileRows = 4;
constexpr int kStaticSmemBytes = 2 * 2 * kTaps * int(sizeof(float));  // raw taps, taps
// the 48 KiB a block may use without opt-in, less the static taps
constexpr int kSmemBytes = 48 * 1024 - kStaticSmemBytes;
constexpr float kPi = 3.14159265f;  // math.pi as the float32 it becomes
constexpr float kEps = 1e-6f;       // the guard at the sinc singularity

__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

__host__ __device__ inline int64_t smem_bytes(int64_t tile, int64_t w) {
  return ((tile + 2 * kHalf) * w + tile * (w + 2 * kHalf)) * int64_t(sizeof(float));
}

// lanczos_kernel's value at tap t for offset d, before normalisation.
__device__ __forceinline__ float raw_tap(int t, float d) {
  float pi_x = __fmul_rn(kPi, __fsub_rn(float(t - kHalf), d));
  if (pi_x == 0.0f) pi_x = kEps;
  const float pi_x3 = pi_x / 3.0f;
  return __fmul_rn(sinf(pi_x) / pi_x, sinf(pi_x3) / pi_x3);
}

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
lanczos_shift_kernel(const float* __restrict__ img, const float* __restrict__ shift,
                     float* __restrict__ out, int h, int w, int64_t img_stride, int tile,
                     bool vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float raw[2][kTaps];
  __shared__ float taps[2][kTaps];  // [0]: ky (rows), [1]: kx (columns)
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * tile;
  const int rows = min(tile, h - row0);
  const int wp = w + 2 * kHalf;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  float* in = smem;                           // (rows + 6) x w
  float* mid = smem + (tile + 2 * kHalf) * w;  // rows x (w + 6)
  const float* src = img + int64_t(b) * img_stride;

  if (tid < 2 * kTaps) {
    const int axis = tid / kTaps;
    raw[axis][tid - axis * kTaps] = raw_tap(tid - axis * kTaps, __ldg(shift + 2 * b + axis));
  }

  for (int r = threadIdx.y; r < rows + 2 * kHalf; r += kThreadsY) {
    int y = row0 + r - kHalf;
    if (y < 0 || y >= h) y = reflect(y, h);
    const float* line = src + int64_t(y) * w;
    float* dst = in + r * w;
    if (vec) {
      for (int c = threadIdx.x; c < w / 4; c += kThreadsX) {
        reinterpret_cast<float4*>(dst)[c] = __ldg(reinterpret_cast<const float4*>(line) + c);
      }
    } else {
      for (int c = threadIdx.x; c < w; c += kThreadsX) dst[c] = __ldg(line + c);
    }
  }
  __syncthreads();

  if (tid < 2 * kTaps) {
    const int axis = tid / kTaps;
    float sum = raw[axis][0];
#pragma unroll
    for (int t = 1; t < kTaps; ++t) sum = __fadd_rn(sum, raw[axis][t]);
    taps[axis][tid - axis * kTaps] = raw[axis][tid - axis * kTaps] / sum;
  }
  __syncthreads();

  float ty[kTaps], tx[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    ty[t] = taps[0][t];
    tx[t] = taps[1][t];
  }

  for (int r = threadIdx.y; r < rows; r += kThreadsY) {
    for (int c = threadIdx.x; c < wp; c += kThreadsX) {
      int x = c - kHalf;
      if (x < 0 || x >= w) x = reflect(x, w);
      const float* col = in + r * w + x;
      float acc = __fmul_rn(ty[0], col[0]);
#pragma unroll
      for (int t = 1; t < kTaps; ++t) acc = __fadd_rn(acc, __fmul_rn(ty[t], col[t * w]));
      mid[r * wp + c] = acc;
    }
  }
  __syncthreads();

  for (int r = threadIdx.y; r < rows; r += kThreadsY) {
    const float* m = mid + r * wp;
    float* dst = out + (int64_t(b) * h + row0 + r) * w;
    for (int c = threadIdx.x; c < w; c += kThreadsX) {
      float acc = __fmul_rn(tx[0], m[c]);
#pragma unroll
      for (int t = 1; t < kTaps; ++t) acc = __fadd_rn(acc, __fmul_rn(tx[t], m[c + t]));
      dst[c] = acc;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok), or
// cudaErrorInvalidValue for a shape the kernel does not take. All pointers
// are device pointers to float32 with contiguous rows; img_stride is the
// distance between images in floats (0: one image for the whole batch);
// the caller allocates out, contiguous.
extern "C" int hrn_lanczos_shift(const void* img, const void* shift, void* out,
                                 int64_t batch, int64_t h, int64_t w, int64_t img_stride,
                                 void* stream) {
  if (batch <= 0 || batch > 65535 || h < 4 || w < 4 || h * w > 0x7fffffff ||
      (img_stride != 0 && img_stride < h * w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t tile = h < kTileRows ? h : kTileRows;
  while (tile > 1 && smem_bytes(tile, w) > kSmemBytes) --tile;
  if (smem_bytes(tile, w) > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = w % 4 == 0 && img_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(img) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((h + tile - 1) / tile), static_cast<unsigned>(batch));
  lanczos_shift_kernel<<<grid, dim3(kThreadsX, kThreadsY), smem_bytes(tile, w),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(shift),
      static_cast<float*>(out), static_cast<int>(h), static_cast<int>(w), img_stride,
      static_cast<int>(tile), vec);
  return static_cast<int>(cudaGetLastError());
}
