// PTX wrappers for Hopper's 1D bulk copy (cp.async.bulk, the TMA's
// non-tensor form) completing on an mbarrier in shared memory, shared by
// K1/K2 (ghost_bn.cu), which stage a slice's runs with them, and K3
// (maxpool_idx.cu), which stages a band of input rows.
//
// A bulk copy moves a multiple of 16 bytes from a global address on 16
// bytes to a shared address on 16 bytes; one thread issues it, and it
// counts its bytes against the mbarrier's expected transaction count.  The
// caller arms the barrier (bar_expect) with the bytes of every copy of the
// phase before issuing them, and the readers wait on the phase's parity.
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(b)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of copies (0: the phase completes)
__device__ __forceinline__ void bar_expect(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(b)), "r"(bytes) : "memory");
}
// waits for the phase `parity` of b to complete; a copy that never lands
// traps (a launch error) instead of hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* b, unsigned parity) {
  unsigned done = 0;
  for (unsigned tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
  }
}
// `bytes` (a multiple of 16) from global src to shared dst, both on 16
// bytes; completes on the mbarrier b
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* b) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b))
               : "memory");
}
// orders this thread's earlier generic accesses of shared memory before
// later bulk copies (the async proxy) into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace
