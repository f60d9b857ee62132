// Fusion-round pair packing for Hopper (sm_90a).
//
// Replaces highresnet_tpu/ops/fusion_pallas.py::_pack_kernel (the Pallas
// forward behind pack_pairs_pallas). It computes the same permutation:
//
//   x   : (B, L, C, H, W), contiguous, any element type
//   out : (B, half, 2C, H, W), half = L / 2
//   out[b, j, :C]  = x[b, j]
//   out[b, j, C:]  = x[b, 2*half-1-j]     (an odd last view is dropped)
//
// Design. The TPU kernel existed because a 64+64 channel concat in NHWC
// crossed the 128-lane tile. In NCHW each half of an output pair is one
// contiguous C*H*W block, so the whole op is 2*B*half block copies of
// block_bytes each and the kernel never looks at the element type. Copy y
// is (b*half + j)*2 + side; the copy loop is block_copy.cuh's, shared with
// the unpack kernel. Every output byte is written by exactly one thread, so
// the result is bit-exact and deterministic.
//
// Bound: memory bandwidth. It reads 2*half*C*H*W*e bytes per batch item and
// writes the same. At the headline shape (B 8, L 16, C 64, 128x128, f32)
// one call (the first fusion round) moves 0.54 GB each way.

#include "block_copy.cuh"

namespace {

__global__ void __launch_bounds__(hrn::kCopyThreads)
pack_pairs_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                  int64_t n_copies, int64_t views, int64_t half,
                  int64_t block_bytes) {
  for (int64_t copy = blockIdx.y; copy < n_copies; copy += gridDim.y) {
    const int64_t side = copy & 1;
    const int64_t pair = copy >> 1;  // b * half + j
    const int64_t b = pair / half;
    const int64_t j = pair - b * half;
    const int64_t view = side ? (2 * half - 1 - j) : j;
    hrn::copy_block(x + (b * views + view) * block_bytes, out + copy * block_bytes,
                    block_bytes);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// x and out are device pointers; block_bytes = C*H*W*sizeof(element).
// The caller allocates out and guarantees batch * half > 0, block_bytes > 0.
extern "C" int hrn_pack_pairs(const void* x, void* out, int64_t batch,
                              int64_t views, int64_t block_bytes, void* stream) {
  const int64_t half = views / 2;
  const int64_t n_copies = 2 * batch * half;
  pack_pairs_kernel<<<hrn::copy_grid(n_copies, block_bytes), hrn::kCopyThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), n_copies, views,
      half, block_bytes);
  return static_cast<int>(cudaGetLastError());
}
