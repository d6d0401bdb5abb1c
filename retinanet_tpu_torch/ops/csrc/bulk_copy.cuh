// Hopper bulk copies into shared memory, completed on mbarriers (sm_90).
//
// One thread arms a barrier with the bytes it expects and starts a
// cp.async.bulk of contiguous global memory; the copy engine counts the
// bytes down on the barrier, and any thread waits on the barrier's phase.
// Used by B2 (nms.cu, its scan's ring of mask rows) and B4 (groupnorm.cu,
// its cluster path's rows of one image).
#pragma once

#include <stdint.h>

namespace bulk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: a barrier that completes a phase on one arrival (the
// arming thread's) once its expected bytes have landed.
__device__ __forceinline__ void init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// After init, before any other thread or the copy engine uses a barrier.
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's earlier generic-proxy accesses to shared memory
// before later bulk copies into it (a slot read, then refilled).
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One thread: arm ``bar`` for ``bytes`` and copy ``bytes`` (a multiple of
// 16, both addresses 16-byte aligned) from ``src`` to ``dst``.
__device__ __forceinline__ void load(void* dst, const void* src,
                                     uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until ``bar`` has completed the phase of parity ``parity``.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

}  // namespace bulk
