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
// The per-step ablation variants of the TPU harness `build` / `_variant_kernel`
// (scripts/profile_lstm_step.py:99 / :44) are this kernel with a compile-time
// STEP (lstm_cell.cuh; kFull is the kernel above), launched for one direction
// on a grid (tiles, 1) at 8 rows a block, the tile of a decode's shapes, behind
// scripts/profile_torch_lstm_step.py.
//
// The cell, the W_hh packing and the recurrent product are shared with
// lstm_bwd.cu through lstm_cell.cuh. Built with nvcc by
// nvse_tpu_torch/ops/_build.py into a shared library with plain C entries,
// `lstm_fused_launch` and `lstm_step_variant_launch`, loaded through ctypes.
#include "lstm_cell.cuh"

namespace {

using namespace lstm;

template <typename T, int RT, int STEP = kFull>
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

  stage_whh(whh_s, w_hh, ksm, G);
  for (int i = j; i < RT * H; i += G) { h_s[i] = 0.0f; c_s[i] = 0.0f; }
  __syncthreads();

  for (int n0 = 0; n0 < Tn; n0 += S) {
    const int ns = min(S, Tn - n0);
    float xg[RT][S];
    if (STEP != kEmpty) {
      // stage x for processing steps n0 .. n0+ns-1 (zeros past the end)
      for (int i = j; i < RT * S * C; i += G) {
        const int k = i % C, rs = i / C, s = rs % S, r = rs / S;
        float v = 0.0f;
        if (r < nr && s < ns) {
          const int t = STEP == kNoInDma ? 0 : dir ? (Tn - 1 - (n0 + s)) : (n0 + s);
          v = to_f<T>(x[((size_t)(r0 + r) * Tn + t) * C + k]);
        }
        x_s[i] = v;
      }
      __syncthreads();

      // input projection of the chunk for this thread's column
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int s = 0; s < S; ++s)  // kNoDot: tile(x_t, 4) * 0.25 + b (C == H)
          xg[r][s] = STEP == kNoDot ? 0.25f * x_s[(r * S + s) * C + j % H] + bias : bias;
      for (int k = 0; STEP != kNoDot && k < C; k += 4) {
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
    }

#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s < ns) {  // uniform across the block
        if (STEP != kEmpty) {
          float acc[RT];
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] = xg[r][s];
          if (STEP != kNoDot) recurrent_product<T, RT>(acc, h_s, whh_s, w_hh, ksm, H, G, j);
#pragma unroll
          for (int r = 0; r < RT; ++r) g_s[r * G + j] = acc[r];
        }
        __syncthreads();

        const int n = n0 + s;
        const int t = dir ? (Tn - 1 - n) : n;
        for (int p = j; p < RT * H; p += G) {
          const int r = p / H, u = p - r * H;
          if (STEP == kEmpty) {      // the zero state, written
            if (r < nr) out[((size_t)(r0 + r) * Tn + t) * (2 * H) + dir * H + u] = from_f<T>(h_s[p]);
            continue;
          }
          float c, h;
          if (STEP == kNoVpu) {
            c = g_s[r * G + u] + 0.5f * c_s[p];
            h = g_s[r * G + H + u] + 0.5f * c;
          } else {
            cell(g_s + r * G, H, u, c_s[p], c, h);
          }
          const T hv = from_f<T>(h);
          c_s[p] = c;
          h_s[p] = to_f<T>(hv);  // h as the recurrent product sees it
          if (r < nr) out[((size_t)(r0 + r) * Tn + t) * (2 * H) + dir * H + u] = hv;
        }
        __syncthreads();
      }
    }
  }
}

template <typename T, int RT, int STEP = kFull>
int launch(const void* x, const void* w_ih_f, const void* w_ih_b, const void* b_f,
           const void* b_b, const void* w_hh_f, const void* w_hh_b, void* out,
           int R, int Tn, int C, int H, cudaStream_t stream, int dirs = 2) {
  constexpr int S = 32 / RT;
  const int G = 4 * H;
  int max_smem = 0, ksm = 0;
  cudaError_t e = max_dynamic_smem(&max_smem);
  if (e != cudaSuccess) return e;
  const long fixed = (long)sizeof(float) * (2 * RT * H + RT * G + RT * S * C);
  const size_t smem = smem_with_whh<T>(fixed, H, max_smem, &ksm);
  if (smem == 0) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(lstm_fused_kernel<T, RT, STEP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((R + RT - 1) / RT, dirs);
  lstm_fused_kernel<T, RT, STEP><<<grid, G, smem, stream>>>(
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

template <typename T>
int launch_step(int step, const void* x, const void* w_ih, const void* b, const void* w_hh,
                void* out, int R, int Tn, int C, int H, cudaStream_t stream) {
#define STEP_LAUNCH(ST) \
  return launch<T, 8, ST>(x, w_ih, w_ih, b, b, w_hh, w_hh, out, R, Tn, C, H, stream, 1)
  switch (step) {
    case kFull: STEP_LAUNCH(kFull);
    case kNoInDma: STEP_LAUNCH(kNoInDma);
    case kNoDot: STEP_LAUNCH(kNoDot);
    case kNoVpu: STEP_LAUNCH(kNoVpu);
    case kEmpty: STEP_LAUNCH(kEmpty);
    default: return cudaErrorInvalidValue;
  }
#undef STEP_LAUNCH
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

// The per-step ablation: one direction (the forward one) of the kernel above
// at 8 rows a block, with step = lstm::Step (0 kFull, the production kernel,
// ... 4 kEmpty). x (R, T, C), w_ih (C, 4H), b (4H), w_hh (H, 4H), out (R, T, 2H)
// (columns [0, H) written); kNoDot needs C == H.
extern "C" int lstm_step_variant_launch(int dtype, int step, const void* x, const void* w_ih,
                                        const void* b, const void* w_hh, void* out, int R,
                                        int Tn, int C, int H, void* stream) {
  if (H <= 0 || 4 * H > 512 || H % 8 || C <= 0 || C % 4 || (step == lstm::kNoDot && C != H))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_step<float>(step, x, w_ih, b, w_hh, out, R, Tn, C, H, s);
  if (dtype == 1) return launch_step<__nv_bfloat16>(step, x, w_ih, b, w_hh, out, R, Tn, C, H, s);
  return cudaErrorInvalidValue;
}
