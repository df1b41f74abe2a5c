// Asynchronous bulk copies from device memory into shared memory that
// complete on an mbarrier, shared by the kernels that stream their operands
// through rings of shared-memory stages: gram_dual.cu (the probe's two
// tensor-core kernels) and gram_diag.cu (the weighted Gram).
//
// A 1-D cp.async.bulk copy needs 16-byte aligned source and destination
// addresses and a size that is a multiple of 16 bytes; a kernel keeps a
// plain-load path for operands that are not so.
//
// Parity waits. A stage's mbarrier completes one phase per fill. A wait on
// parity p returns once the phase of that parity has completed, so it is
// only sound while the barrier cannot be two phases past the one waited
// for: the kernel must not refill a stage before every waiter of its
// previous fill has passed its wait.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace emloco {

// A wait that lasts this long traps instead of hanging: some 10^5 times a
// whole launch of these kernels, far above what a debugging tool slows a
// sound kernel by.
constexpr unsigned long long kWaitLimitNs = 30000000000ull;  // 30 s

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :
               : "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the other threads and to the
// async proxy (then __syncthreads before any thread uses them)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :
               : "r"(smem_addr(bar))
               : "memory");
}

// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` to complete. After kWaitLimitNs it
// traps. The launch has returned long before: the trap surfaces at a later
// synchronize as a sticky cudaErrorLaunchFailure, which ends the process's
// CUDA context.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint64_t t0 = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023) == 0) {
      const uint64_t t = global_ns();
      if (t0 == 0) t0 = t;
      else if (t - t0 > kWaitLimitNs) __trap();
    }
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :
      : "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// order this thread's generic-proxy shared-memory accesses before later
// bulk copies into the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__host__ __device__ constexpr size_t round16(size_t b) {
  return (b + 15) & ~size_t(15);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace emloco
