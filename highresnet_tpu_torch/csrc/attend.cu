// Masked multi-head attention over short sequences for Hopper (sm_90a): the
// core of TR-MISR's transformer fusion (K5). No TPU kernel stands behind it.
//
//   qkv  : (S, n, 3*h*d) float32, contiguous: sequence s, token i, then q, k
//          and v side by side, each h heads of d (the QKV projection's rows)
//   bias : (B, n) float32: 0 for a key that counts, -inf for a masked one;
//          sequence s belongs to scene s / per_scene
//   out  : (S, n, h*d) float32, the heads side by side
//   out[s, i, head] = sum_j w_j * v[s, j, head],
//     w = softmax_j(dot(q[s, i, head], k[s, j, head]) * scale + bias[scene, j])
//
// Bound: memory bandwidth. A (sequence, head) reads n rows of d floats each of
// q, k and v and writes n rows of d: 17.4 KB at n 17, d 64, against 2*n*n*d
// FMAs, about 2 a byte. At the trmisr-archive shape (8 scenes of 128 x 128
// pixels, 8 heads) one call moves 18.25 GB: 5.45 ms at 3.35 TB/s.
//
// Design. One warp per (sequence, head); the heads of a sequence are
// neighbours in the grid. The warp copies its head's q, k and v rows into
// shared memory with 16-byte asynchronous copies (cp.async: every load of the
// warp is in flight at once, and none passes through registers), rows padded
// to d + 4 floats so that lane i's reads of row i hit distinct banks. Lane i
// takes query row i (n <= 32): q in registers, then the n scores
// dot(q, k_j) * scale + bias_j, each summed over d in order in FP32 FMA (no
// tensor cores, so no TF32), their maximum, w_j = exp(s_j - max) / sum, and
// acc = sum_j w_j * v_j; k_j and v_j are read from shared memory by every lane
// at once (broadcast). The key of token 0 always counts, so no row is wholly
// masked. Each lane writes its output row back over its q row, and the warp
// stores the rows with 16-byte accesses, each head's row 4*d contiguous bytes.
// Every output element has one writer and no atomics: deterministic.
//
// Occupancy: two warps a block, at most 128 registers a thread (launch
// bounds), so 16 warps an SM where the shared memory holds them (2 * 3 * n *
// (d + 4) floats a block: 27.7 KB at n 17, d 64). Where two warps' buffers
// pass 48 KiB (n > 29 at d 64) a block holds one warp. On an H100 SXM at the
// trmisr-archive shape this took 8.04-8.11 ms a call, 68% of the bound; four
// warps a block, one warp, or 168 registers (6 or 3 blocks an SM) took
// 8.54-8.84 ms, and moving the weighted sum to a lane per output column
// (all 32 lanes busy, the weights through shared memory) 8.65-9.23 ms
// (PERF.md §6).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxTokens = 32;  // a lane per query row
constexpr int kWarps = 2;       // warps a block, where the shared memory allows
constexpr int kMinBlocks = 8;   // with kWarps: 128 registers a thread
constexpr int64_t kSmemLimit = 48 * 1024;

template <int D>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
attend_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
              float* __restrict__ out, int64_t units, int64_t per_scene, int n,
              int heads, float scale) {
  constexpr int kStride = D + 4;  // floats a staged row
  constexpr int kVec = D / 4;     // 16-byte pieces a row
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t unit = int64_t(blockIdx.x) * (blockDim.x / 32) + warp;
  if (unit >= units) return;
  const int64_t seq = unit / heads;
  const int head = int(unit - seq * heads);
  const int64_t width = int64_t(3) * heads * D;
  float* qs = reinterpret_cast<float*>(smem) + int64_t(warp) * 3 * n * kStride;
  const float* src = qkv + seq * n * width + head * D;

  // q, k, v rows of the head: part p's row r lands at qs[(p * n + r) * kStride].
  for (int p = 0; p < 3; ++p) {
    for (int t = lane; t < n * kVec; t += 32) {
      const int r = t / kVec, c = t % kVec;
      __pipeline_memcpy_async(qs + (p * n + r) * kStride + 4 * c,
                              src + r * width + p * heads * D + 4 * c, 16);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();

  if (lane < n) {
    const float* ks = qs + n * kStride;
    const float* vs = qs + 2 * n * kStride;
    const float* row_bias = bias + (seq / per_scene) * n;
    float q[D];
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const float4 x = reinterpret_cast<const float4*>(qs + lane * kStride)[c];
      q[4 * c] = x.x, q[4 * c + 1] = x.y, q[4 * c + 2] = x.z, q[4 * c + 3] = x.w;
    }
    float s[kMaxTokens];
    float top = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxTokens; ++j) {
      if (j < n) {
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const float4 k = reinterpret_cast<const float4*>(ks + j * kStride)[c];
          dot = fmaf(q[4 * c], k.x, dot);
          dot = fmaf(q[4 * c + 1], k.y, dot);
          dot = fmaf(q[4 * c + 2], k.z, dot);
          dot = fmaf(q[4 * c + 3], k.w, dot);
        }
        s[j] = dot * scale + __ldg(row_bias + j);
        top = fmaxf(top, s[j]);
      }
    }
    float total = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxTokens; ++j) {
      if (j < n) {
        s[j] = expf(s[j] - top);
        total += s[j];
      }
    }
    float acc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxTokens; ++j) {
      if (j < n) {
        const float w = s[j] / total;
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const float4 v = reinterpret_cast<const float4*>(vs + j * kStride)[c];
          acc[4 * c] = fmaf(w, v.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(w, v.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(w, v.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(w, v.w, acc[4 * c + 3]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kVec; ++c) {  // over the lane's own q row
      reinterpret_cast<float4*>(qs + lane * kStride)[c] =
          make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
    }
  }
  __syncwarp();

  float* dst = out + seq * n * (int64_t(heads) * D) + head * D;
  for (int t = lane; t < n * kVec; t += 32) {
    const int r = t / kVec, c = t % kVec;
    reinterpret_cast<float4*>(dst + r * (int64_t(heads) * D))[c] =
        reinterpret_cast<const float4*>(qs + r * kStride)[c];
  }
}

template <int D>
int launch(const float* qkv, const float* bias, float* out, int64_t sequences,
           int64_t per_scene, int n, int heads, float scale, cudaStream_t stream) {
  const int64_t units = sequences * heads;
  const int64_t warp_bytes = int64_t(3) * n * (D + 4) * int64_t(sizeof(float));
  const int warps = kWarps * warp_bytes <= kSmemLimit ? kWarps : 1;
  const int64_t blocks = (units + warps - 1) / warps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  attend_kernel<D><<<static_cast<unsigned>(blocks), warps * 32, warps * warp_bytes, stream>>>(
      qkv, bias, out, units, per_scene, n, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns a cudaError_t as an int (0 = ok). qkv,
// bias and out are 16-byte aligned device pointers, laid out as above;
// sequences = B * per_scene > 0, 1 <= n <= 32, head_dim one of 8, 16, 32, 64,
// scale = head_dim ** -0.5 as the caller rounds it to float.
extern "C" int hrn_attend(const void* qkv, const void* bias, void* out, int64_t sequences,
                          int64_t per_scene, int64_t n, int64_t heads, int64_t head_dim,
                          float scale, void* stream) {
  if (n < 1 || n > kMaxTokens || heads < 1 || sequences < 1 || per_scene < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto q = static_cast<const float*>(qkv);
  const auto b = static_cast<const float*>(bias);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int nn = static_cast<int>(n), h = static_cast<int>(heads);
  switch (head_dim) {
    case 8: return launch<8>(q, b, o, sequences, per_scene, nn, h, scale, st);
    case 16: return launch<16>(q, b, o, sequences, per_scene, nn, h, scale, st);
    case 32: return launch<32>(q, b, o, sequences, per_scene, nn, h, scale, st);
    case 64: return launch<64>(q, b, o, sequences, per_scene, nn, h, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
