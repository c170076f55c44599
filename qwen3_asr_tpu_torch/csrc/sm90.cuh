// Hopper (sm_90a) building blocks shared by the kernels under csrc/: the
// shared-memory barrier (mbarrier) that asynchronous copies complete on,
// the one-dimensional bulk copy from device to shared memory, an
// acquire-release atomic, and the shared-memory opt-in of a launch. Raw
// PTX, no CUTLASS headers, so a source that includes this still builds in
// seconds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Called by one thread; every thread must pass a __syncthreads() after it
// before waiting on the barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival that also announces `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// that never ends (a lost copy) traps after ~2^26 polls, seconds, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 26)) asm volatile("trap;");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device memory into shared memory; completes on `bar`. Every caller reads
// its bytes once (a layer of the cache, or partials), so the copy asks L2
// to evict them first.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// Order this thread's earlier shared-memory accesses before a later
// asynchronous copy into the same bytes.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

constexpr int kMaxDevices = 64;

// Let `kernel` take up to `dynamic_bytes` of dynamic shared memory (above
// 48 KB only after this opt-in) and ask for the largest shared-memory
// carveout, so the blocks its shared memory allows are all resident. Both
// attributes hold per device: `done` marks the devices already set, so no
// later launch on one (nor a graph capture) repeats the calls. Host side;
// returns cudaError_t.
template <typename Kernel>
inline cudaError_t max_smem(Kernel kernel, int dynamic_bytes,
                            bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

// atomicAdd with acquire-release semantics at device scope.
__device__ __forceinline__ unsigned atomic_add_acq_rel(unsigned* p,
                                                       unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

}  // namespace sm90
