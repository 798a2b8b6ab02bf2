// Hopper's bulk asynchronous copies (cp.async.bulk, sm_90) between device
// memory and shared memory, for the one-hot gather's forward kernel: loads
// that complete on an mbarrier in shared memory, stores tracked in bulk
// groups. Sizes and both addresses are multiples of 16 bytes.

#pragma once

#include <stdint.h>

namespace bulk {

// a block's dynamic shared memory on sm_90 beside a few static bytes (an
// mbarrier): at most 227 KB, and past 47 KB only after the kernel opts in
constexpr long long kMaxSmem = 232448 - 16;
constexpr long long kDefaultSmem = 47 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread: the barrier expects `count` arrivals a phase
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrives, and adds `bytes` to the bytes the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// device memory -> shared memory; its bytes complete on `bar`
__device__ __forceinline__ void load(uint32_t dst, const void* src,
                                     uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared memory -> device memory, in this thread's open bulk group
__device__ __forceinline__ void store(void* dst, uint32_t src,
                                      uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

// closes this thread's open bulk group
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until every bulk group this thread committed has read its shared memory
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// orders this thread's shared-memory accesses through the generic proxy
// before later ones through the async proxy (the bulk copies)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace bulk
