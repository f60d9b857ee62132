// Fused per-image Lanczos shift for Hopper (sm_90a).
//
// Replaces highresnet_tpu/ops/lanczos_pallas.py::_fused_shift_kernel (the
// Pallas forward behind lanczos_shift_pallas / lanczos_shift_fused):
//
//   img : (B, H, W) float32, contiguous
//   ky  : (B, 7) float32, normalised Lanczos-3 taps for the row shift
//   kx  : (B, 7) float32, the same for the column shift
//   out : (B, H, W) float32
//   pad  = reflect-pad(img, 3)            (np.pad "reflect": index -k -> k)
//   rows = sum_t ky[t] * pad[t : t+H, :]  (vertical pass, t = 0..6)
//   out  = sum_t kx[t] * rows[:, t : t+W] (horizontal pass)
//
// The taps are computed outside the kernel (lanczos_kernel), as in the TPU
// kernel. H and W must be at least 4 so that a reflect pad of 3 is defined.
//
// Design. One block per (row tile, image). The block loads its tile plus a
// 3-row halo, with reflected row indices, into shared memory; runs the
// vertical pass into a second shared buffer that holds the 3-column
// reflected halo on each side (the vertical sums of the reflected columns);
// then runs the horizontal pass and writes the tile. Each image byte is read
// from device memory once per tile it touches (the halo rows twice) and
// written once. Sums run in the plain version's order, vertical first, taps
// t = 0..6, each product and sum rounded on its own (__fmul_rn, __fadd_rn,
// no FMA contraction), which is what PyTorch's separate multiply and add
// kernels do, so the kernel matches the plain version on the card.
//
// Bound: memory bandwidth (14 FLOP per pixel per pass on 8 bytes of traffic).
// At the training shape (8, 192, 192) one call moves 1.2 MB each way; the
// tile height of 8 rows gives 192 blocks there, more than the 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 7;
constexpr int kHalf = 3;
constexpr int kThreads = 256;
constexpr int kTileRows = 8;
constexpr int kSmemBytes = 48 * 1024;  // no opt-in above the default limit

__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

__host__ __device__ inline int64_t smem_bytes(int64_t tile, int64_t w) {
  return ((tile + 2 * kHalf) * w + tile * (w + 2 * kHalf)) * int64_t(sizeof(float));
}

__global__ void __launch_bounds__(kThreads)
lanczos_shift_kernel(const float* __restrict__ img, const float* __restrict__ ky,
                     const float* __restrict__ kx, float* __restrict__ out, int h,
                     int w, int tile) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * tile;
  const int rows = min(tile, h - row0);
  const int wp = w + 2 * kHalf;
  float* in = smem;                           // (rows + 6) x w
  float* mid = smem + (tile + 2 * kHalf) * w;  // rows x (w + 6)
  const float* src = img + int64_t(b) * h * w;

  float ty[kTaps], tx[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    ty[t] = __ldg(ky + b * kTaps + t);
    tx[t] = __ldg(kx + b * kTaps + t);
  }

  const int n_in = (rows + 2 * kHalf) * w;
  for (int i = threadIdx.x; i < n_in; i += kThreads) {
    const int r = i / w;
    const int c = i - r * w;
    in[i] = __ldg(src + int64_t(reflect(row0 + r - kHalf, h)) * w + c);
  }
  __syncthreads();

  const int n_mid = rows * wp;
  for (int i = threadIdx.x; i < n_mid; i += kThreads) {
    const int r = i / wp;
    const int c = reflect(i - r * wp - kHalf, w);
    float acc = __fmul_rn(ty[0], in[r * w + c]);
#pragma unroll
    for (int t = 1; t < kTaps; ++t) acc = __fadd_rn(acc, __fmul_rn(ty[t], in[(r + t) * w + c]));
    mid[i] = acc;
  }
  __syncthreads();

  float* dst = out + (int64_t(b) * h + row0) * w;
  const int n_out = rows * w;
  for (int i = threadIdx.x; i < n_out; i += kThreads) {
    const int r = i / w;
    const float* m = mid + r * wp + (i - r * w);
    float acc = __fmul_rn(tx[0], m[0]);
#pragma unroll
    for (int t = 1; t < kTaps; ++t) acc = __fadd_rn(acc, __fmul_rn(tx[t], m[t]));
    dst[i] = acc;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok), or
// cudaErrorInvalidValue for a shape the kernel does not take. All pointers
// are device pointers to contiguous float32; the caller allocates out.
extern "C" int hrn_lanczos_shift(const void* img, const void* ky, const void* kx,
                                 void* out, int64_t batch, int64_t h, int64_t w,
                                 void* stream) {
  if (batch <= 0 || batch > 65535 || h < 4 || w < 4 || h * w > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t tile = h < kTileRows ? h : kTileRows;
  while (tile > 1 && smem_bytes(tile, w) > kSmemBytes) --tile;
  if (smem_bytes(tile, w) > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((h + tile - 1) / tile), static_cast<unsigned>(batch));
  lanczos_shift_kernel<<<grid, kThreads, smem_bytes(tile, w),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(ky),
      static_cast<const float*>(kx), static_cast<float*>(out), static_cast<int>(h),
      static_cast<int>(w), static_cast<int>(tile));
  return static_cast<int>(cudaGetLastError());
}
