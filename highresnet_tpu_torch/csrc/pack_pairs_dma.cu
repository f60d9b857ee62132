// Fusion-round pair packing by bulk copies (TMA, no thread touches data), for
// Hopper (sm_90a).
//
// Replaces examples/fusion_lab4.py::pack_dma (kernel :64, pallas_call :73),
// the fusion lab's DMA variant of the pair pack. Same function as K1
// (csrc/pack_pairs.cu), in the port's NCHW layout:
//
//   x   : (B, L, C, H, W), contiguous, any element type
//   out : (B, half, 2C, H, W), half = L / 2
//   out[b, j, :C]  = x[b, j]
//   out[b, j, C:]  = x[b, 2*half-1-j]     (an odd last view is dropped)
//
// Bound: bytes. The kernel reads each paired byte once and writes it once,
// 2 * B * 2*half * C*H*W * sizeof(element) bytes at 3.35 TB/s; at the lab's
// (8, 16, 64, 128, 128) bf16 that is 0.537 GB, 0.160 ms.
//
// Design. On the TPU each grid step (b, j) starts two HBM->HBM DMA copies,
// one into each channel half of the output pair, and the core moves no
// bytes. Hopper has no global-to-global bulk copy a kernel can issue, so the
// Tensor Memory Accelerator's non-tensor-map bulk copy takes the DMA
// engine's place, staged through shared memory: cp.async.bulk brings a chunk
// of a view block into a shared-memory stage and completes a transaction
// count on the stage's mbarrier; cp.async.bulk (shared -> global, bulk
// group) writes it out. One thread per block issues every copy; no thread
// loads or stores data, and there are no atomics: every output byte is
// written by exactly one bulk store, so the result is bit-exact.
//
// A persistent grid of one block per SM walks work items, item = (copy,
// chunk), copy = (b*half + j)*2 + side, in steps of gridDim.x. A ring of
// kStages stages of kStageBytes keeps kStages - 1 loads in flight: after
// item i's store is committed, the stage of item i-1 is refilled with item
// i-1+kStages once `wait_group.read 1` says that item i-1's store has read
// it. Bulk copies need 16-byte aligned addresses and sizes that are
// multiples of 16; the wrapper (ops/fusion_dma.py) refuses any other tensor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 4;
constexpr int kStageBytes = 32 * 1024;
constexpr int kSmemBytes = kStages * kStageBytes + kStages * 8;  // ring + mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(1u) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Arm the stage's barrier for `bytes` and start the global -> shared copy.
__device__ __forceinline__ void bulk_load(uint32_t dst, const uint8_t* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared -> global copy, committed as its own bulk group.
__device__ __forceinline__ void bulk_store(uint8_t* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

struct Work {
  const uint8_t* x;
  uint8_t* out;
  int64_t views, half, block_bytes, chunks, n_items;
};

// Source, destination and size of work item `item`.
__device__ __forceinline__ void locate(const Work& w, int64_t item, const uint8_t** src,
                                      uint8_t** dst, uint32_t* bytes) {
  const int64_t copy = item / w.chunks;
  const int64_t begin = (item - copy * w.chunks) * kStageBytes;
  const int64_t side = copy & 1;
  const int64_t pair = copy >> 1;  // b * half + j
  const int64_t b = pair / w.half;
  const int64_t j = pair - b * w.half;
  const int64_t view = side ? (2 * w.half - 1 - j) : j;
  const int64_t rest = w.block_bytes - begin;
  *src = w.x + (b * w.views + view) * w.block_bytes + begin;
  *dst = w.out + copy * w.block_bytes + begin;
  *bytes = static_cast<uint32_t>(rest < kStageBytes ? rest : kStageBytes);
}

__global__ void __launch_bounds__(32) pack_pairs_dma_kernel(Work w) {
  extern __shared__ __align__(128) uint8_t smem[];
  if (threadIdx.x != 0) return;
  const uint32_t ring = smem_u32(smem);
  const uint32_t bars = ring + kStages * kStageBytes;

  // this block's items: blockIdx.x + i * gridDim.x, i < n
  const int64_t n = (w.n_items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  for (uint32_t s = 0; s < kStages; ++s) mbar_init(bars + 8 * s);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const uint8_t* src;
  uint8_t* dst;
  uint32_t bytes;
  for (uint32_t s = 0; s < kStages && s < n; ++s) {
    locate(w, blockIdx.x + int64_t(s) * gridDim.x, &src, &dst, &bytes);
    bulk_load(ring + s * kStageBytes, src, bytes, bars + 8 * s);
  }
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t s = static_cast<uint32_t>(i % kStages);
    mbar_wait(bars + 8 * s, static_cast<uint32_t>((i / kStages) & 1));
    locate(w, blockIdx.x + i * gridDim.x, &src, &dst, &bytes);
    bulk_store(dst, ring + s * kStageBytes, bytes);
    // refill the stage of item i-1 once its store (one group back) has read it
    const int64_t next = i - 1 + kStages;
    if (i >= 1 && next < n) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      const uint32_t ps = static_cast<uint32_t>(next % kStages);
      locate(w, blockIdx.x + next * gridDim.x, &src, &dst, &bytes);
      bulk_load(ring + ps * kStageBytes, src, bytes, bars + 8 * ps);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

// Launches on `stream` and returns a cudaError_t as an int (0 = ok). x and
// out are device pointers, 16-byte aligned; block_bytes = C*H*W*sizeof(element)
// is a multiple of 16. The caller allocates out and guarantees
// batch * (views / 2) > 0, block_bytes > 0.
extern "C" int hrn_pack_pairs_dma(const void* x, void* out, int64_t batch, int64_t views,
                                  int64_t block_bytes, void* stream) {
  Work w;
  w.x = static_cast<const uint8_t*>(x);
  w.out = static_cast<uint8_t*>(out);
  w.views = views;
  w.half = views / 2;
  w.block_bytes = block_bytes;
  w.chunks = (block_bytes + kStageBytes - 1) / kStageBytes;
  w.n_items = 2 * batch * w.half * w.chunks;

  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pack_pairs_dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = w.n_items < sms ? w.n_items : sms;
  pack_pairs_dma_kernel<<<static_cast<unsigned>(grid), 32, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(w);
  return static_cast<int>(cudaGetLastError());
}
