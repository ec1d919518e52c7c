// Fused-projection bidirectional LSTM for Hopper (sm_90a).
//
// Replaces the TPU kernel family of nvse_tpu/ops/pallas_lstm.py
// `lstm_scan_fused`: `_fused_kernel` (launched by `_pallas_lstm_fused`,
// pallas_lstm.py:815) and `_fused_kernel_unrolled` (launched by
// `_pallas_lstm_fused_unrolled`, pallas_lstm.py:727). The two are one
// function at two TPU unroll factors, so one kernel covers both.
//
// For every row r and direction d (0 forward, 1 backward), zero state:
//   gates_t = x_t @ W_ih_d + h_{t-1} @ W_hh_d + b_d   (gate order i, f, g, o)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
// The backward direction walks t = T-1 .. 0 and writes h at the original
// time index, into columns [H, 2H) of the (R, T, 2H) output. x is read
// batch-first (R, T, C); nothing is transposed or flipped in memory.
// Types: float32 or bfloat16 for x, weights and output; state and every
// sum in float32. h is rounded to the weight type before the recurrent
// product (the `_hdot` rule, pallas_lstm.py:36-43).
//
// What bounds it. At the BSRNN-M shapes (C = H = 128; R = 272 rows over
// T = 1024 steps for the time BiLSTM, R = 8192 over T = 34 for the band
// BiLSTM) one call does 2 directions x R*T x 2*(C+H)*4H = 0.146 TFLOP on
// a few hundred MB of input and output: the work is operations, not
// bytes. The time BiLSTM adds a chain of 1024 dependent steps, each a
// product of only R rows with the 128 x 512 W_hh, followed by the cell.
//
// Design (first version: right and simple, CUDA cores in float32).
// - One block per (direction, tile of RT rows); the block loops over all
//   T steps and keeps h and c in shared memory. This replaces the TPU's
//   sequential grid axis: Hopper's blocks run in no order. The tile size
//   is picked by the caller so that both directions' tiles fill the SMs
//   in one wave where they can (272 rows -> 68 blocks of 8 rows).
// - 4H threads; thread j owns gate column j, so every weight element it
//   loads feeds RT rows (RT FMAs per load), and its W_ih / W_hh column
//   reads are coalesced across the warp.
// - The input projection is hoisted out of the dependent chain: every S
//   steps the block stages x for S steps into shared memory and each
//   thread computes its column's x @ W_ih + b for RT x S (row, step)
//   pairs into registers (RT * S = 32), so W_ih is read once per S steps.
// - W_hh stays in shared memory as far as it fits (all of it in bf16 at
//   H = 128, 128 KiB, through the dynamic shared-memory attribute; 92 of
//   128 rows in float32), packed so a thread reads 4 consecutive k of its
//   column in one vector load; the remaining rows and W_ih are read
//   through L1/L2.
// - The ragged last row tile is masked at the x load and the output
//   store. wgmma, TMA and thread-block clusters are later work.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library
// with a plain C entry, `lstm_fused_launch`, loaded through ctypes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

template <typename T, int RT>
__global__ void __launch_bounds__(512, 1)
lstm_fused_kernel(const T* __restrict__ x,
                  const T* __restrict__ w_ih_f, const T* __restrict__ w_ih_b,
                  const T* __restrict__ b_f, const T* __restrict__ b_b,
                  const T* __restrict__ w_hh_f, const T* __restrict__ w_hh_b,
                  T* __restrict__ out, int R, int Tn, int C, int H, int ksm) {
  constexpr int S = 32 / RT;           // steps per staged x chunk
  const int G = 4 * H;                 // == blockDim.x
  const int j = threadIdx.x;           // gate column owned by this thread
  const int dir = blockIdx.y;
  const int r0 = blockIdx.x * RT;
  const int nr = min(RT, R - r0);      // valid rows of this (maybe ragged) tile
  const T* __restrict__ w_ih = dir ? w_ih_b : w_ih_f;
  const T* __restrict__ w_hh = dir ? w_hh_b : w_hh_f;
  const float bias = to_f<T>(dir ? b_b[j] : b_f[j]);

  extern __shared__ float4 smem_f4[];
  float* h_s = reinterpret_cast<float*>(smem_f4);   // [RT][H]
  float* c_s = h_s + RT * H;                        // [RT][H]
  float* g_s = c_s + RT * H;                        // [RT][G]
  float* x_s = g_s + RT * G;                        // [RT][S][C]
  T* whh_s = reinterpret_cast<T*>(x_s + RT * S * C); // [ksm/4][G][4]

  for (int i = j; i < ksm * G; i += G) {
    const int k = i / G, col = i - k * G;
    whh_s[((k >> 2) * G + col) * 4 + (k & 3)] = w_hh[i];
  }
  for (int i = j; i < RT * H; i += G) { h_s[i] = 0.0f; c_s[i] = 0.0f; }
  __syncthreads();

  for (int n0 = 0; n0 < Tn; n0 += S) {
    const int ns = min(S, Tn - n0);
    // stage x for processing steps n0 .. n0+ns-1 (zeros past the end)
    for (int i = j; i < RT * S * C; i += G) {
      const int k = i % C, rs = i / C, s = rs % S, r = rs / S;
      float v = 0.0f;
      if (r < nr && s < ns) {
        const int t = dir ? (Tn - 1 - (n0 + s)) : (n0 + s);
        v = to_f<T>(x[((size_t)(r0 + r) * Tn + t) * C + k]);
      }
      x_s[i] = v;
    }
    __syncthreads();

    // input projection of the chunk for this thread's column
    float xg[RT][S];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int s = 0; s < S; ++s) xg[r][s] = bias;
    for (int k = 0; k < C; k += 4) {
      float w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = to_f<T>(w_ih[(size_t)(k + q) * G + j]);
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float xv[4];
          load4(x_s + (r * S + s) * C + k, xv);
#pragma unroll
          for (int q = 0; q < 4; ++q) xg[r][s] = fmaf(xv[q], w[q], xg[r][s]);
        }
    }

#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s < ns) {  // uniform across the block
        float acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = xg[r][s];
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
#pragma unroll
        for (int r = 0; r < RT; ++r) g_s[r * G + j] = acc[r];
        __syncthreads();

        const int n = n0 + s;
        const int t = dir ? (Tn - 1 - n) : n;
        for (int p = j; p < RT * H; p += G) {
          const int r = p / H, u = p - r * H;
          const float* gr = g_s + r * G;
          const float ig = sigmoid(gr[u]);
          const float fg = sigmoid(gr[H + u]);
          const float gg = tanhf(gr[2 * H + u]);
          const float og = sigmoid(gr[3 * H + u]);
          const float c = fg * c_s[p] + ig * gg;
          const T hv = from_f<T>(og * tanhf(c));
          c_s[p] = c;
          h_s[p] = to_f<T>(hv);  // h as the recurrent product sees it
          if (r < nr) out[((size_t)(r0 + r) * Tn + t) * (2 * H) + dir * H + u] = hv;
        }
        __syncthreads();
      }
    }
  }
}

template <typename T, int RT>
int launch(const void* x, const void* w_ih_f, const void* w_ih_b, const void* b_f,
           const void* b_b, const void* w_hh_f, const void* w_hh_b, void* out,
           int R, int Tn, int C, int H, cudaStream_t stream) {
  constexpr int S = 32 / RT;
  const int G = 4 * H;
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const long fixed = (long)sizeof(float) * (2 * RT * H + RT * G + RT * S * C);
  const long row = (long)sizeof(T) * G;   // one W_hh row in shared memory
  if (fixed > max_smem) return cudaErrorInvalidValue;
  int ksm = (int)((max_smem - fixed) / row);
  ksm = (ksm < H ? ksm : H) & ~3;
  const size_t smem = (size_t)(fixed + ksm * row);
  e = cudaFuncSetAttribute(lstm_fused_kernel<T, RT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((R + RT - 1) / RT, 2);
  lstm_fused_kernel<T, RT><<<grid, G, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_ih_f), static_cast<const T*>(w_ih_b),
      static_cast<const T*>(b_f), static_cast<const T*>(b_b),
      static_cast<const T*>(w_hh_f), static_cast<const T*>(w_hh_b),
      static_cast<T*>(out), R, Tn, C, H, ksm);
  return cudaGetLastError();
}

template <typename T>
int launch_rt(int rt, const void* x, const void* w_ih_f, const void* w_ih_b, const void* b_f,
              const void* b_b, const void* w_hh_f, const void* w_hh_b, void* out,
              int R, int Tn, int C, int H, cudaStream_t stream) {
  switch (rt) {
    case 2: return launch<T, 2>(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b, out, R, Tn, C, H, stream);
    case 4: return launch<T, 4>(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b, out, R, Tn, C, H, stream);
    case 8: return launch<T, 8>(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b, out, R, Tn, C, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x (R, T, C), w_ih (C, 4H), b (4H), w_hh (H, 4H),
// out (R, T, 2H), all contiguous on the current device. rt: rows per block
// (2, 4 or 8). Returns the cudaError_t of the launch (0 on success).
extern "C" int lstm_fused_launch(int dtype, const void* x, const void* w_ih_f,
                                 const void* w_ih_b, const void* b_f, const void* b_b,
                                 const void* w_hh_f, const void* w_hh_b, void* out,
                                 int R, int Tn, int C, int H, int rt, void* stream) {
  if (H <= 0 || 4 * H > 512 || H % 8 || C <= 0 || C % 4) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rt<float>(rt, x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b, out, R, Tn, C, H, s);
  if (dtype == 1)
    return launch_rt<__nv_bfloat16>(rt, x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b, out, R, Tn, C, H, s);
  return cudaErrorInvalidValue;
}
