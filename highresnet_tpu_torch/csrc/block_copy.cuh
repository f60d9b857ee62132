// Typeless block copy shared by the pair pack (K1) and unpack (K2) kernels.
//
// A fusion round's pack and its inverse are, in NCHW, permutations of whole
// C*H*W blocks. A launch is a grid (chunk, copy): block (x, y) moves chunk x
// of copy y. A thread moves 16 bytes per access on an aligned body and single
// bytes on the tail; a chunk whose source or destination is not 16-byte
// aligned (odd C*H*W, odd element offsets) goes bytewise. No shared memory,
// no atomics: every output byte is written by exactly one thread.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hrn {

constexpr int kCopyThreads = 256;
constexpr int kVecPerThread = 4;
constexpr int64_t kChunkBytes = int64_t(kCopyThreads) * kVecPerThread * 16;  // 16 KiB

__host__ __device__ inline int64_t n_chunks(int64_t block_bytes) {
  return (block_bytes + kChunkBytes - 1) / kChunkBytes;
}

// Grid for n_copies copies of block_bytes each (y is capped; kernels stride).
inline dim3 copy_grid(int64_t n_copies, int64_t block_bytes) {
  const int64_t chunks = n_chunks(block_bytes);
  return dim3(static_cast<unsigned>(chunks < 0x7fffffff ? chunks : 0x7fffffff),
              static_cast<unsigned>(n_copies < 65535 ? n_copies : 65535));
}

// Copy bytes [begin, begin + len) of one block; src == nullptr writes zeros.
__device__ __forceinline__ void copy_chunk(const uint8_t* __restrict__ src,
                                           uint8_t* __restrict__ dst, int64_t len) {
  int64_t done = 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
  if ((align & 15) == 0) {
    const int64_t n_vec = len / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int64_t i = threadIdx.x + int64_t(k) * kCopyThreads;
      if (i < n_vec) d4[i] = src ? __ldg(s4 + i) : make_uint4(0, 0, 0, 0);
    }
    done = n_vec * 16;
  }
  for (int64_t i = done + threadIdx.x; i < len; i += kCopyThreads) dst[i] = src ? src[i] : 0;
}

// Each block walks its chunks of one copy: chunk x, x + gridDim.x, ...
__device__ __forceinline__ void copy_block(const uint8_t* src, uint8_t* dst,
                                           int64_t block_bytes) {
  const int64_t chunks = n_chunks(block_bytes);
  for (int64_t chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int64_t begin = chunk * kChunkBytes;
    const int64_t rest = block_bytes - begin;
    copy_chunk(src ? src + begin : nullptr, dst + begin, rest < kChunkBytes ? rest : kChunkBytes);
  }
}

}  // namespace hrn
