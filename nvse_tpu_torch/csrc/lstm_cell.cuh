// Pieces shared by the LSTM kernels of csrc/.
//
// Layout of the H <= 128 kernels (lstm_fused.cu, lstm_bwd.cu, lstm_scan.cu):
// a block owns a tile of RT rows and runs 4H threads;
// thread j owns gate column j (gate order i, f, g, o). W_hh (H, 4H) sits in
// shared memory as far as it fits, rows [0, ksm), packed [ksm/4][4H][4] so
// that a thread reads 4 consecutive k of its column in one vector load; the
// remaining rows are read through L1/L2. State and every sum are float32.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace lstm {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// four consecutive elements (16-byte aligned for float, 8-byte for bf16)
__device__ __forceinline__ void load4(const float* p, float w[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float w[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
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

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

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

// Rows [0, ksm) of w_hh (H, G) into whh_s, packed [ksm/4][G][4].
template <typename T>
__device__ __forceinline__ void stage_whh(T* whh_s, const T* __restrict__ w_hh, int ksm, int G) {
  for (int i = threadIdx.x; i < ksm * G; i += blockDim.x) {
    const int k = i / G, col = i - k * G;
    whh_s[((k >> 2) * G + col) * 4 + (k & 3)] = w_hh[i];
  }
}

// W_hh[k .. k+3][j] as floats, from shared memory below ksm, else global.
template <typename T>
__device__ __forceinline__ void whh_col4(const T* whh_s, const T* __restrict__ w_hh,
                                         int ksm, int G, int k, int j, float w[4]) {
  if (k < ksm) {
    load4(whh_s + ((k >> 2) * G + j) * 4, w);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = to_f<T>(w_hh[(size_t)(k + q) * G + j]);
  }
}

// acc[r] += sum_k h_s[r * H + k] * W_hh[k][j] for the RT rows of the tile.
template <typename T, int RT>
__device__ __forceinline__ void recurrent_product(float acc[RT], const float* h_s,
                                                  const T* whh_s, const T* __restrict__ w_hh,
                                                  int ksm, int H, int G, int j) {
  for (int k = 0; k < ksm; k += 4) {
    float w[4];
    load4(whh_s + ((k >> 2) * G + j) * 4, w);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float hv[4];
      load4(h_s + r * H + k, hv);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r] = fmaf(hv[q], w[q], acc[r]);
    }
  }
  for (int k = ksm; k < H; k += 4) {
    float w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = to_f<T>(w_hh[(size_t)(k + q) * G + j]);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float hv[4];
      load4(h_s + r * H + k, hv);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r] = fmaf(hv[q], w[q], acc[r]);
    }
  }
}

// Gate activations of hidden unit u from one row's pre-activations gr[0, 4H).
struct Gates {
  float i, f, g, o;
};
__device__ __forceinline__ Gates gates_of(const float* gr, int H, int u) {
  return {sigmoid(gr[u]), sigmoid(gr[H + u]), tanhf(gr[2 * H + u]), sigmoid(gr[3 * H + u])};
}

// One cell step: c = f * c_prev + i * g; h = o * tanh(c).
__device__ __forceinline__ void cell(const float* gr, int H, int u, float c_prev,
                                     float& c, float& h) {
  const Gates a = gates_of(gr, H, u);
  c = a.f * c_prev + a.i * a.g;
  h = a.o * tanhf(c);
}

// Bytes of dynamic shared memory for `fixed` bytes of other buffers plus as
// many W_hh rows (a multiple of 4) as fit; sets ksm. Returns 0 if even the
// fixed part does not fit.
template <typename T>
inline size_t smem_with_whh(long fixed, int H, int max_smem, int* ksm) {
  const long row = (long)sizeof(T) * 4 * H;
  if (fixed > max_smem) return 0;
  int k = (int)((max_smem - fixed) / row);
  k = (k < H ? k : H) & ~3;
  *ksm = k;
  return (size_t)(fixed + k * row);
}

inline cudaError_t max_dynamic_smem(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace lstm
