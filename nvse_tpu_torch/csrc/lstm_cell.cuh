// Pieces shared by the LSTM kernels of csrc/: conversions (float32, bfloat16, float16), vector and
// asynchronous copies, ldmatrix and mma.sync, a warp's reduce-scatter, the sigmoid, the per-step
// ablation variants and the card's shared-memory limit.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

namespace lstm {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);   // round to nearest even, as torch's .to(float16)
}

// 16 bytes (4 float32 or 8 bfloat16 values) from global memory through L2,
// as floats into shared memory. `__ldcg` skips L1, which is not coherent
// across SMs: the wide kernels read data that other blocks of the same
// launch wrote (16-byte aligned src and dst).
__device__ __forceinline__ void load_h16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = __ldcg(reinterpret_cast<const float4*>(src));
}
__device__ __forceinline__ void load_h16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = __ldcg(reinterpret_cast<const uint4*>(src));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.z));
  const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.w));
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, d.x, d.y);
}

// cp.async: 16 bytes from global to shared memory without a register round
// trip; bytes past src_bytes are filled with zeros (0: nothing read).
// The 16-byte form (.cg) reads through L2 only, so it sees what other blocks
// of the same launch wrote before a grid barrier.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// all but the newest N committed groups of this thread have landed
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// the same for a count known at run time (0 ... 7)
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Four 8 x 8 tiles of 16-bit values from shared memory, lane i giving the
// address of row i % 8 of tile i / 8 (16 contiguous bytes); .trans hands
// each lane a column pair instead of a row pair.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// d += a (16 x 16, row-major fragment) * b (16 x 8, column fragment) on the
// tensor cores: bfloat16 products, each exact in float32, summed in float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same with float16 products (csrc/lstm_bwd.cu's dW reduction in float16).
__device__ __forceinline__ void mma_f16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                        unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma_bf16 or mma_f16 by the 16-bit operand type T
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                      unsigned b1) {
  if constexpr (std::is_same<T, __half>::value) mma_f16(d, a, b0, b1);
  else mma_bf16(d, a, b0, b1);
}

// A float32 value v split for the float16 tensor cores at a power-of-two scale:
// v sc = hi + lo + (what is lost), hi = f16(v sc), lo = f16(v sc - hi). bfloat16
// keeps float32's exponent range, so its split (hi = bf16(v), lo = bf16(v - hi))
// needs no scale; float16's normal range is 2^-14 ... 65,504, where a gradient of
// 1e-7 is subnormal and hi + lo loses its bits. row_scale() picks sc for a row of
// values whose largest magnitude has the float32 bits m (0: all zero): sc = 2^k,
// k = 13 - exponent(m) (the largest v sc in [2^13, 2^14)), clamped to [-126, 126]
// so that sc and 1 / sc are normal float32; every |v sc| is below 2^14, and what is
// lost is at most 2^-25 absolute (half float16's least subnormal) after the scale,
// 2^-38 of the row's largest value. Returns (sc, 1 / sc).
__device__ __forceinline__ float2 row_scale(int m) {
  if (m == 0) return make_float2(1.0f, 1.0f);
  const int k = max(-126, min(126, 13 - (((m >> 23) & 0xff) - 127)));
  return make_float2(__int_as_float((k + 127) << 23), __int_as_float((127 - k) << 23));
}
__device__ __forceinline__ void split_f16(float v, float sc, __half& hi, __half& lo) {
  hi = __float2half_rn(v * sc);
  lo = __float2half_rn(v * sc - __half2float(hi));
}

// The float32 k-slices' partial sums v (N = 4 x rows values, row-major (row,
// gate or output)) summed over the M-aligned groups of lanes, M = 16 / 2 ... 1
// (csrc/lstm_scan.cu, csrc/lstm_bwd.cu): while a
// lane holds more than one row it keeps half of them (the upper half where
// lane & M) and adds the partner's half, so lane ks of the group ends with
// rows [ks rows / KS, ...) when rows >= KS; then the last row's four sums are
// added across the remaining lanes.
template <int N, int M, int NV>
__device__ __forceinline__ void reduce_scatter(float (&v)[NV], int lane) {
  if constexpr (M >= 1) {
    if constexpr (N > 4) {
      const bool up = lane & M;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      reduce_scatter<N / 2, M / 2, NV>(v, lane);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], M);
      reduce_scatter<N, M / 2, NV>(v, lane);
    }
  }
}

// 1 / (1 + e^-v), the reciprocal rounded as IEEE division rounds the quotient
__device__ __forceinline__ float sigmoid(float v) { return __frcp_rn(1.0f + expf(-v)); }

// What a step of a fused kernel computes: kFull, the production cell, or one
// of the per-step ablation variants of scripts/profile_torch_lstm_step.py
// (the TPU harness's `_variant_kernel` at one step a grid step), each of which
// drops one part of the step and keeps the launch, the step loop with its
// synchronisation and the output writes:
//   kNoInDma  every step reads x[0]: the input stays in L2, its DRAM traffic goes
//   kNoDot    gates = tile(x_t, 4) * 0.25 + b (C == H): both products go
//   kNoVpu    c = g_i + 0.5 c; h = g_f + 0.5 c: the sigmoids and tanhs go
//   kEmpty    the zero state written at every step: the floor
enum Step : int { kFull = 0, kNoInDma = 1, kNoDot = 2, kNoVpu = 3, kEmpty = 4 };

inline cudaError_t max_dynamic_smem(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace lstm
