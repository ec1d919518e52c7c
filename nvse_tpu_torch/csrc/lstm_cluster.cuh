// Thread-block cluster pieces shared by the cluster kernels of csrc/
// (lstm_fused.cu, lstm_scan.cu, lstm_bwd.cu): rank and size, the cluster barrier, the
// address of a peer's shared memory, and the mbarriers on which st.async
// completes the bytes of h that the peers store.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace lstm {

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the shared::cluster address of `smem_addr` (this block's shared memory) in block `rank`
__device__ __forceinline__ unsigned cluster_map(unsigned smem_addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr), "r"(rank));
  return r;
}
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier of one arrival (this block's thread 0, which announces the bytes
// of h that the peers will store) whose phase completes when those bytes have
// landed: each peer's st.async completes its bytes on it.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
// waits for the phase of the given parity; a phase that never completes (a
// fault) traps after some seconds instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 26)) asm volatile("trap;");
  }
}
// 4 bytes into a peer's shared memory, completed on the peer's mbarrier
__device__ __forceinline__ void st_async(unsigned addr, unsigned v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   addr), "r"(v), "r"(bar) : "memory");
}
// 8 and 16 bytes (16-byte aligned), the same way
__device__ __forceinline__ void st_async2(unsigned addr, float2 v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n"
               ::"r"(addr), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async4(unsigned addr, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(addr), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(bar) : "memory");
}
__device__ __forceinline__ unsigned bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ unsigned bits(__half v) { return __half_as_ushort(v); }

}  // namespace lstm
