// Shared memory across a thread block cluster: mbarriers, cluster barriers
// and the st.async pushes of the probes that hold a field on a cluster of
// blocks (probe_diffuse.cu's stencil and products, probe_shift.cu's
// neighbour rounds).  Each source that includes this gets its own copy.
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of local shared address `addr` in block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// an mbarrier whose phase completes after one arrival (and the bytes it
// expects)
__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

// an mbarrier whose phase completes after `count` arrivals
__device__ __forceinline__ void bar_init_count(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival on this block's mbarrier at `bar`, releasing this thread's
// writes to the block
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// the one arrival of a phase, which also expects `bytes` of copies in it
// (copies may land before it: the count of bytes may run below zero)
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// waits for the phase of `parity` to complete (acquiring, at block scope,
// the writes its arrivals released); a copy or an arrival that never comes
// traps (the launch then fails) instead of hanging the card
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// a 16-byte store into block-of-the-cluster shared memory at `addr` that
// completes its bytes on that block's mbarrier at `bar` (both shared::cluster
// addresses); the complete-tx is a release at cluster scope, so no fence
__device__ __forceinline__ void st_async4(uint32_t addr, uint32_t bar, float a,
                                          float b, float c, float d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

// waits for the phase of `parity` to complete and acquires, at cluster scope,
// the writes released by its arrivals; traps rather than hang
__device__ __forceinline__ void bar_wait_cluster(uint32_t bar,
                                                 uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}

}  // namespace
