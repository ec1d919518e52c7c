// Unidirectional LSTM scans over a projected input for Hopper (sm_90a).
//
// Replaces the TPU kernels of nvse_tpu/ops/pallas_lstm.py:
//   lstm_scan_kernel<.., false> <- `_lstm_kernel` / `_lstm_kernel_unrolled`
//                                  (launched by `_pallas_lstm_scan`, pallas_lstm.py:212)
//   lstm_scan_kernel<.., true>  <- `_lstm_kernel_stateful`
//                                  (launched by `_pallas_lstm_scan_stateful`, pallas_lstm.py:297)
// The unrolled TPU variants are the same functions at other unroll factors.
//
// Contract (time-major, one direction, gate order i, f, g, o):
//   gates_t = x_proj[t] + h_{t-1} @ W_hh
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g);  h_t = sigmoid(o) * tanh(c_t)
//   lstm_scan:          h_{-1} = c_{-1} = 0                  -> hs (T, R, H)
//   lstm_scan_stateful: h_{-1} = h0, c_{-1} = c0, each (R, H) -> hs, cs (T, R, H)
// Types: x_proj, W_hh, h0, c0, hs and cs are all float32 or all bfloat16; the
// state and every sum are float32. h is rounded to the weight type before the
// recurrent product (the `_hdot` rule, pallas_lstm.py:36-43), so in bfloat16
// the product sees exactly the h that was stored; c is stored rounded but
// carried in float32. (The residual-saving forward of lstm_bwd.cu does not
// round h: the two differ in bfloat16, as the TPU kernels do.)
//
// What bounds them. At the BSRNN-M shapes (H = 128) the causal time LSTM of
// an offline decode is 272 rows x 1024 steps: 36.5 GFLOP on 0.71 GB (f32),
// operations, not bytes, on CUDA cores, and above all a chain of 1024
// dependent steps of a 4-row product each. A streaming chunk is 272 rows x 80
// steps (2.9 GFLOP, 78 MB with cs): the same chain, 80 long.
//
// Design (first version: right and simple, CUDA cores in float32): the
// residual-saving forward of lstm_bwd.cu with three switches. One block per
// tile of RT rows loops over all T steps; 4H threads, thread j owns gate
// column j; W_hh in shared memory as far as it fits (lstm_cell.cuh), h and c
// in shared memory; x_proj[t + 1] is loaded into registers while step t
// computes. The switches: h is rounded as stored, the state starts from
// (h0, c0), and cs is written only by the stateful kernel. The caller picks
// RT so that the tiles fill the SMs in one wave where they can (272 rows ->
// 68 blocks of 4). wgmma, TMA and clusters are later work.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// plain C entries (lstm_scan_launch, lstm_scan_stateful_launch), loaded
// through ctypes.
#include "lstm_cell.cuh"

namespace {

using namespace lstm;

template <typename T, int RT, bool STATEFUL>
__global__ void __launch_bounds__(512, 1)
lstm_scan_kernel(const T* __restrict__ xp, const T* __restrict__ w_hh,
                 const T* __restrict__ h0, const T* __restrict__ c0,
                 T* __restrict__ hs, T* __restrict__ cs, int R, int Tn, int H, int ksm) {
  const int G = 4 * H;                 // == blockDim.x
  const int j = threadIdx.x;
  const int r0 = blockIdx.x * RT;
  const int nr = min(RT, R - r0);      // valid rows of this (maybe ragged) tile

  extern __shared__ float4 smem_f4[];
  float* h_s = reinterpret_cast<float*>(smem_f4);   // [RT][H]
  float* c_s = h_s + RT * H;                        // [RT][H]
  float* g_s = c_s + RT * H;                        // [RT][G]
  T* whh_s = reinterpret_cast<T*>(g_s + RT * G);    // [ksm/4][G][4]

  stage_whh(whh_s, w_hh, ksm, G);
  for (int p = j; p < RT * H; p += G) {
    const int r = p / H, u = p - r * H;
    float h = 0.0f, c = 0.0f;
    if (STATEFUL && r < nr) {
      h = to_f<T>(h0[(size_t)(r0 + r) * H + u]);
      c = to_f<T>(c0[(size_t)(r0 + r) * H + u]);
    }
    h_s[p] = h;
    c_s[p] = c;
  }

  float xn[RT];                        // x_proj of the next step
#pragma unroll
  for (int r = 0; r < RT; ++r) xn[r] = r < nr ? to_f<T>(xp[(size_t)(r0 + r) * G + j]) : 0.0f;
  __syncthreads();

  for (int t = 0; t < Tn; ++t) {
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = xn[r];
    if (t + 1 < Tn) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
        xn[r] = r < nr ? to_f<T>(xp[((size_t)(t + 1) * R + r0 + r) * G + j]) : 0.0f;
    }
    recurrent_product<T, RT>(acc, h_s, whh_s, w_hh, ksm, H, G, j);
#pragma unroll
    for (int r = 0; r < RT; ++r) g_s[r * G + j] = acc[r];
    __syncthreads();

    for (int p = j; p < RT * H; p += G) {
      const int r = p / H, u = p - r * H;
      float c, h;
      cell(g_s + r * G, H, u, c_s[p], c, h);
      const T hv = from_f<T>(h);
      c_s[p] = c;
      h_s[p] = to_f<T>(hv);            // h as the recurrent product sees it
      if (r < nr) {
        const size_t o = ((size_t)t * R + r0 + r) * H + u;
        hs[o] = hv;
        if (STATEFUL) cs[o] = from_f<T>(c);
      }
    }
    __syncthreads();
  }
}

template <typename T, int RT, bool STATEFUL>
int launch(const void* xp, const void* w_hh, const void* h0, const void* c0, void* hs, void* cs,
           int R, int Tn, int H, cudaStream_t stream) {
  const int G = 4 * H;
  int max_smem = 0, ksm = 0;
  cudaError_t e = max_dynamic_smem(&max_smem);
  if (e != cudaSuccess) return e;
  const long fixed = (long)sizeof(float) * (2 * RT * H + RT * G);
  const size_t smem = smem_with_whh<T>(fixed, H, max_smem, &ksm);
  if (smem == 0) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(lstm_scan_kernel<T, RT, STATEFUL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  lstm_scan_kernel<T, RT, STATEFUL><<<(R + RT - 1) / RT, G, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(w_hh), static_cast<const T*>(h0),
      static_cast<const T*>(c0), static_cast<T*>(hs), static_cast<T*>(cs), R, Tn, H, ksm);
  return cudaGetLastError();
}

template <bool STATEFUL>
int launch_any(int dtype, int rt, const void* xp, const void* w_hh, const void* h0,
               const void* c0, void* hs, void* cs, int R, int Tn, int H, void* stream) {
  if (R <= 0 || Tn <= 0 || H <= 0 || 4 * H > 512 || H % 8) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCAN(TY, RTV) return launch<TY, RTV, STATEFUL>(xp, w_hh, h0, c0, hs, cs, R, Tn, H, s)
  if (dtype == 0) {
    if (rt == 2) SCAN(float, 2);
    if (rt == 4) SCAN(float, 4);
    if (rt == 8) SCAN(float, 8);
  } else if (dtype == 1) {
    if (rt == 2) SCAN(__nv_bfloat16, 2);
    if (rt == 4) SCAN(__nv_bfloat16, 4);
    if (rt == 8) SCAN(__nv_bfloat16, 8);
  }
#undef SCAN
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x_proj (T, R, 4H), w_hh (H, 4H), h0/c0 (R, H),
// hs/cs (T, R, H), all contiguous on the current device. rt: rows per block
// (2, 4 or 8). Each entry returns the cudaError_t of the launch (0 on success).
extern "C" int lstm_scan_launch(int dtype, const void* xp, const void* w_hh, void* hs,
                                int R, int Tn, int H, int rt, void* stream) {
  return launch_any<false>(dtype, rt, xp, w_hh, nullptr, nullptr, hs, nullptr, R, Tn, H, stream);
}

extern "C" int lstm_scan_stateful_launch(int dtype, const void* xp, const void* w_hh,
                                         const void* h0, const void* c0, void* hs, void* cs,
                                         int R, int Tn, int H, int rt, void* stream) {
  return launch_any<true>(dtype, rt, xp, w_hh, h0, c0, hs, cs, R, Tn, H, stream);
}
