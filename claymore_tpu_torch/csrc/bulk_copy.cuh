// Shared-memory barriers and 1-D bulk asynchronous copies (cp.async.bulk:
// the Tensor Memory Accelerator without a tensor map) on sm_90: the ring
// stages of the transfer kernel K1 (g2p2g.cu) and of the collider grid
// kernels (grid_update.cu).  One thread arms a barrier with the bytes to
// expect and issues the copies; every thread that reads the stage waits on
// the barrier's phase.

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t s_addr(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(s_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(s_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(s_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// 1-D bulk copy global -> shared, completing on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];"
               :: "r"(s_addr(dst)), "l"(src), "r"(bytes), "r"(s_addr(bar))
               : "memory");
}

}  // namespace
