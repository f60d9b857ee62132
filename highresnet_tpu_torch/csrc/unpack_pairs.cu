// Fusion-round pair unpacking (the pack's backward) for Hopper (sm_90a).
//
// Replaces highresnet_tpu/ops/fusion_pallas.py::_unpack_kernel (the Pallas
// kernel behind _pallas_unpack, called by the pack's custom-VJP backward
// _bwd) together with _bwd's zero block for a dropped odd view:
//
//   g   : (B, half, 2C, H, W), contiguous, any element type
//   out : (B, L, C, H, W), half = L / 2
//   out[b, v] = g[b, v, :C]                 for v < half
//   out[b, v] = g[b, 2*half-1-v, C:]        for half <= v < 2*half
//   out[b, v] = 0                           for v = L-1 when L is odd
//
// Design. In NCHW each output view is one contiguous C*H*W block of its
// source pair, so the unpack is K1's block copy in the other direction:
// B*L copies of block_bytes each, grid (chunk, copy), copy y = b*L + v,
// with block_copy.cuh's loop (16-byte accesses on aligned bodies, a
// bytewise tail). The dropped view's zeros are written by the kernel, not
// by a separate memset. Every output byte is written by exactly one
// thread: no atomics, bit-exact and deterministic.
//
// Bound: memory bandwidth. It reads 2*half*C*H*W*e bytes per batch item and
// writes L*C*H*W*e. At the first-round training shape (B 8, L 8, C 64,
// 64x64, f32) one call moves 67 MB each way.

#include "block_copy.cuh"

namespace {

__global__ void __launch_bounds__(hrn::kCopyThreads)
unpack_pairs_kernel(const uint8_t* __restrict__ g, uint8_t* __restrict__ out,
                    int64_t n_copies, int64_t views, int64_t half,
                    int64_t block_bytes) {
  for (int64_t copy = blockIdx.y; copy < n_copies; copy += gridDim.y) {
    const int64_t b = copy / views;
    const int64_t v = copy - b * views;
    const uint8_t* src = nullptr;  // the dropped odd view: zeros
    if (v < half) {
      src = g + ((b * half + v) * 2) * block_bytes;
    } else if (v < 2 * half) {
      src = g + ((b * half + (2 * half - 1 - v)) * 2 + 1) * block_bytes;
    }
    hrn::copy_block(src, out + copy * block_bytes, block_bytes);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// g and out are device pointers; block_bytes = C*H*W*sizeof(element), the
// size of one output view. The caller allocates out and guarantees
// batch * views > 0, block_bytes > 0.
extern "C" int hrn_unpack_pairs(const void* g, void* out, int64_t batch,
                                int64_t views, int64_t block_bytes, void* stream) {
  const int64_t half = views / 2;
  const int64_t n_copies = batch * views;
  unpack_pairs_kernel<<<hrn::copy_grid(n_copies, block_bytes), hrn::kCopyThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(g), static_cast<uint8_t*>(out), n_copies, views,
      half, block_bytes);
  return static_cast<int>(cudaGetLastError());
}
