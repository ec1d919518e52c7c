// Residual-saving LSTM forward and reverse-time LSTM backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of nvse_tpu/ops/pallas_lstm_bwd.py:
//   lstm_fwd_hc_kernel <- `_fwd_kernel_hc` / `_fwd_kernel_hc_unrolled`
//                         (launched by `lstm_fwd_hc`, pallas_lstm_bwd.py:181)
//   lstm_bwd_kernel    <- `_bwd_kernel` / `_bwd_kernel_unrolled`
//   lstm_dw_mma_kernel / lstm_dw_fma_kernel (bfloat16 / float32)
//                         (both launched by `lstm_bwd`, pallas_lstm_bwd.py:339;
//                         dW_hh is summed there inside the kernel body)
// The unrolled TPU variants are the same functions at other unroll factors.
//
// Contract (time-major, one direction, zero initial state, gate order i,f,g,o):
//   forward:  gates_t = x_proj[t] + h_{t-1} @ W_hh
//             c_t = f * c_{t-1} + i * g;  h_t = o * tanh(c_t)       -> hs, cs (T, R, H)
//   backward: dh = dhs[t] + dh_carry;  dc = dc_carry + dh * o * (1 - tanh(c_t)^2)
//             dgates = [dc*g*i*(1-i), dc*c_{t-1}*f*(1-f), dc*i*(1-g^2), dh*tanh(c_t)*o*(1-o)]
//             dx_proj[t] = dgates;  dh_carry = dgates @ W_hh^T;  dc_carry = dc * f
//             dW_hh = sum_{t, r} h_{t-1}^T dgates                    (the dW kernels)
// with h_{-1} = c_{-1} = 0 read as zeros at t = 0 (no shifted copies in memory).
// Types follow the TPU residual kernels: x_proj, W_hh, hs, cs, dhs and dx_proj
// are all float32 or all bfloat16. The forward state is float32 and the product
// multiplies the float32 h (h is not rounded to the weight type, unlike the
// inference kernel; pallas_lstm_bwd.py:148); hs and cs are stored in the
// x_proj type. The backward reads h_{t-1}, c_t and c_{t-1} as stored, sums
// both products in float32, keeps the carries in float32 and stores dx_proj in
// the x_proj type. dW sums the stored dx_proj in float32; the splits of the
// rows add their sums into one float32 dW, and the caller casts once.
//
// What bounds them. At the BSRNN-M training shapes (H = 128; 544 rows x 65
// steps for the time BiLSTM, 1040 rows x 34 steps for the band BiLSTM, i.e.
// 35,360 (row, step) pairs per direction) the forward does 4.6 GFLOP per call
// on ~110 MB (f32), the backward 3x that on ~220 MB: operations, not bytes,
// on CUDA cores. Each is also a chain of T dependent steps.
//
// Design (first version: right and simple, CUDA cores in float32).
// - lstm_fwd_hc_kernel is the inference kernel (lstm_fused.cu) without the
//   input projection: one block per tile of RT rows loops over all T steps,
//   4H threads, thread j owns gate column j, W_hh in shared memory as far as
//   it fits (lstm_cell.cuh), h and c in shared memory. x_proj[t + 1] is
//   loaded into registers while step t computes.
// - lstm_bwd_kernel: the same tiling walking t = T-1 .. 0.
//   * The gate recompute x_proj[t] + h_{t-1} @ W_hh reads the SAVED h_{t-1},
//     not the backward carry, so it is hoisted out of the dependent chain:
//     every S steps the block stages h_{t-1} for S steps in shared memory
//     and thread j computes its column for RT x S (row, step) pairs into
//     registers (RT * S = 32), reading W_hh once per chunk.
//   * The chain per step is then: gates to shared memory | cell backward by
//     (row, unit) pairs, dgates to shared memory and dx_proj | dh_carry =
//     dgates @ W_hh^T | next step, three barriers.
//   * dgates @ W_hh^T needs W_hh by rows. With the packed layout a float4
//     holds W_hh[4q .. 4q+3][j], so thread (q, js) owns hidden units 4q..4q+3
//     and the slice j = js, js+16, ...; the 16 lanes of a quad sit in one
//     half-warp on consecutive j (no bank conflicts on the float4 reads, the
//     dgates reads broadcast to the two quads) and their partial sums are
//     added with warp shuffles.
//   * dc_carry stays in registers (each thread owns the same pairs every
//     step); dh_carry in shared memory.
// - The dW kernels: dW_hh is (H, 4H) = 256 KiB in float32, which fits
//   neither a block's shared memory nor its registers, so it is a second
//   kernel (also that of the wide recurrence of csrc/lstm_bwd_wide.cu, up
//   to H = 768): a GEMM over the T*R rows of [h_{t-1} | dx_proj], 128 x 128
//   output tiles, split over the rows so that the grid fills the card; the
//   splits add their sums into the float32 (H, 4H) with atomics (in an order
//   that varies from run to run; a single split stores).
//   At BSRNN-L's training shapes it is 18.5 GFLOP on 90 MB (bf16): bound by
//   operations in float32 (0.28 ms), by bytes in bfloat16 (0.027 ms).
//   bfloat16 runs on the tensor cores (mma.sync m16n8k16, float32 sums, each
//   product exact), float32 on CUDA cores with 8 x 8 outputs a thread; both
//   stage the rows with cp.async into a ring, the next chunks' copies in
//   flight while the current one is multiplied.
// wgmma, TMA and clusters are later work for the recurrences.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// plain C entries (lstm_fwd_hc_launch, lstm_bwd_launch, lstm_dw_launch,
// lstm_dw_blocks_per_sm), loaded through ctypes.
#include <type_traits>

#include "lstm_cell.cuh"

namespace {

using namespace lstm;

template <typename T, int RT>
__global__ void __launch_bounds__(512, 1)
lstm_fwd_hc_kernel(const T* __restrict__ xp, const T* __restrict__ w_hh,
                   T* __restrict__ hs, T* __restrict__ cs, int R, int Tn, int H, int ksm) {
  const int G = 4 * H;                 // == blockDim.x
  const int j = threadIdx.x;
  const int r0 = blockIdx.x * RT;
  const int nr = min(RT, R - r0);

  extern __shared__ float4 smem_f4[];
  float* h_s = reinterpret_cast<float*>(smem_f4);   // [RT][H]
  float* c_s = h_s + RT * H;                        // [RT][H]
  float* g_s = c_s + RT * H;                        // [RT][G]
  T* whh_s = reinterpret_cast<T*>(g_s + RT * G);    // [ksm/4][G][4]

  stage_whh(whh_s, w_hh, ksm, G);
  for (int i = j; i < RT * H; i += G) { h_s[i] = 0.0f; c_s[i] = 0.0f; }

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
      c_s[p] = c;
      h_s[p] = h;                      // the state stays float32
      if (r < nr) {
        const size_t o = ((size_t)t * R + r0 + r) * H + u;
        hs[o] = from_f<T>(h);
        cs[o] = from_f<T>(c);
      }
    }
    __syncthreads();
  }
}

template <typename T, int RT>
__global__ void __launch_bounds__(512, 1)
lstm_bwd_kernel(const T* __restrict__ xp, const T* __restrict__ hs, const T* __restrict__ cs,
                const T* __restrict__ dhs, const T* __restrict__ w_hh, T* __restrict__ dx,
                int R, int Tn, int H, int ksm) {
  constexpr int S = 32 / RT;           // steps per hoisted recompute chunk
  constexpr int PP = (RT + 3) / 4;     // (row, unit) pairs per thread: RT*H / 4H
  const int G = 4 * H;                 // == blockDim.x
  const int j = threadIdx.x;
  const int r0 = blockIdx.x * RT;
  const int nr = min(RT, R - r0);

  extern __shared__ float4 smem_f4[];
  float* hp_s = reinterpret_cast<float*>(smem_f4);  // [RT][S][H] h_{t-1} of the chunk
  float* g_s = hp_s + RT * S * H;                   // [RT][G] gate pre-activations
  float* dg_s = g_s + RT * G;                       // [RT][G] dgates
  float* dh_s = dg_s + RT * G;                      // [RT][H] dh carry
  T* whh_s = reinterpret_cast<T*>(dh_s + RT * H);   // [ksm/4][G][4]

  stage_whh(whh_s, w_hh, ksm, G);
  for (int i = j; i < RT * H; i += G) dh_s[i] = 0.0f;
  float dcc[PP];                       // dc carry of this thread's pairs
#pragma unroll
  for (int m = 0; m < PP; ++m) dcc[m] = 0.0f;

  // dgates @ W_hh^T mapping: quad q = hidden units 4q..4q+3, slice js of j
  const int q = j >> 4, js = j & 15;

  for (int n0 = 0; n0 < Tn; n0 += S) {
    const int ns = min(S, Tn - n0);
    // stage h_{t-1} for t = Tn-1-(n0+s); zeros at t = 0, past the chunk, ragged rows
    for (int i = j; i < RT * S * H; i += G) {
      const int k = i % H, rs = i / H, s = rs % S, r = rs / S;
      const int t = Tn - 1 - (n0 + s);
      float v = 0.0f;
      if (r < nr && s < ns && t > 0) v = to_f<T>(hs[((size_t)(t - 1) * R + r0 + r) * H + k]);
      hp_s[i] = v;
    }
    __syncthreads();

    // recompute of the chunk's gate pre-activations for column j
    float xg[RT][S];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int t = Tn - 1 - (n0 + s);
        xg[r][s] = (r < nr && s < ns) ? to_f<T>(xp[((size_t)t * R + r0 + r) * G + j]) : 0.0f;
      }
    for (int k = 0; k < H; k += 4) {
      float w[4];
      whh_col4(whh_s, w_hh, ksm, G, k, j, w);
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float hv[4];
          load4(hp_s + (r * S + s) * H + k, hv);
#pragma unroll
          for (int e = 0; e < 4; ++e) xg[r][s] = fmaf(hv[e], w[e], xg[r][s]);
        }
    }

#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s < ns) {  // uniform across the block
        const int t = Tn - 1 - (n0 + s);
        // this thread's saved values for the cell backward, loaded before the barrier
        float cv[PP], cpv[PP], dhv[PP];
#pragma unroll
        for (int m = 0; m < PP; ++m) {
          const int p = j + m * G, r = p / H, u = p - r * H;
          cv[m] = cpv[m] = dhv[m] = 0.0f;
          if (p < RT * H && r < nr) {
            const size_t o = ((size_t)t * R + r0 + r) * H + u;
            cv[m] = to_f<T>(cs[o]);
            dhv[m] = to_f<T>(dhs[o]);
            if (t > 0) cpv[m] = to_f<T>(cs[o - (size_t)R * H]);
          }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) g_s[r * G + j] = xg[r][s];
        __syncthreads();

        // cell backward for this thread's (row, unit) pairs
#pragma unroll
        for (int m = 0; m < PP; ++m) {
          const int p = j + m * G;
          if (p < RT * H) {
            const int r = p / H, u = p - r * H;
            const Gates a = gates_of(g_s + r * G, H, u);
            const float tc = tanhf(cv[m]);
            const float dh = dhv[m] + dh_s[p];
            const float dc = dcc[m] + dh * a.o * (1.0f - tc * tc);
            const float dgi = dc * a.g * a.i * (1.0f - a.i);
            const float dgf = dc * cpv[m] * a.f * (1.0f - a.f);
            const float dgg = dc * a.i * (1.0f - a.g * a.g);
            const float dgo = dh * tc * a.o * (1.0f - a.o);
            float* dgr = dg_s + r * G;
            dgr[u] = dgi;
            dgr[H + u] = dgf;
            dgr[2 * H + u] = dgg;
            dgr[3 * H + u] = dgo;
            dcc[m] = dc * a.f;
            if (r < nr) {
              T* dxr = dx + ((size_t)t * R + r0 + r) * G;
              dxr[u] = from_f<T>(dgi);
              dxr[H + u] = from_f<T>(dgf);
              dxr[2 * H + u] = from_f<T>(dgg);
              dxr[3 * H + u] = from_f<T>(dgo);
            }
          }
        }
        __syncthreads();

        // dh_carry[r][4q .. 4q+3] = sum_j dgates[r][j] * W_hh[4q .. 4q+3][j]
        float acc[RT][4];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
        for (int jj = js; jj < G; jj += 16) {
          float w[4];
          whh_col4(whh_s, w_hh, ksm, G, 4 * q, jj, w);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float d = dg_s[r * G + jj];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(d, w[e], acc[r][e]);
          }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = acc[r][e];
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
            if (((r * 4 + e) & 15) == js) dh_s[r * H + 4 * q + e] = v;
          }
        __syncthreads();
      }
    }
  }
}

// The dW_hh reduction: dw[m][j] += sum over the rows n of the block's split
// of h_{t-1}[n][m] * dx[n][j], n = t * R + r over all T*R rows; h_{t-1}
// of row n is hs row n - R (zero for n < R), read so by the tile loader. A
// GEMM (H x T*R) . (T*R x 4H) whose operands are both MN-major: a row n of hs
// is contiguous along m, one of dx along j. The split over n, its rows and
// the tiles below are the plan of ops/lstm.py `dw_plan`, which mirrors them.
namespace dw {
constexpr int THREADS = 256, BM = 128, BN = 128;   // output tile (m, j)
// bfloat16: tensor cores, 32 rows n a stage in a ring of 4; rows padded by
// 16 bytes so that ldmatrix's 8 rows of a tile fall in distinct banks
constexpr int MMA_BK = 32, MMA_STAGES = 4, MMA_PITCH = BM + 8;
// float32: CUDA cores, 8 rows n a stage in a ring of 3
constexpr int FMA_BK = 8, FMA_STAGES = 3;

// a block's sum into dw: stored where one split covers the rows
// (gridDim.z == 1), else added with an atomic
__device__ __forceinline__ void add_out(float* dst, float v) {
  if (gridDim.z == 1) *dst = v;
  else atomicAdd(dst, v);
}
template <typename T> constexpr int smem_bytes();
template <> constexpr int smem_bytes<__nv_bfloat16>() {
  return MMA_STAGES * MMA_BK * 2 * MMA_PITCH * 2;
}
template <> constexpr int smem_bytes<float>() { return FMA_STAGES * FMA_BK * (BM + BN) * 4; }
}  // namespace dw

// bfloat16: a block owns a 128 x 128 tile of (m, j) and the split's rows;
// 8 warps as 2 (m) x 4 (j), 64 x 32 outputs each, as 4 x 4 mma.sync
// m16n8k16 tiles with float32 sums in registers. Both operands come through
// ldmatrix.trans (A's rows n are contiguous along m, B's along j). The
// stages are filled by cp.async, three chunks of 32 rows in flight ahead of
// the one being multiplied.
__global__ void __launch_bounds__(dw::THREADS)
lstm_dw_mma_kernel(const __nv_bfloat16* __restrict__ hs, const __nv_bfloat16* __restrict__ dx,
                   float* __restrict__ dw, int R, int N, int H, int rows_per_split) {
  using namespace dw;
  constexpr int STAGE = 2 * MMA_BK * MMA_PITCH;       // A then B, bf16 elements
  const int G = 4 * H;
  const int m0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int n_begin = blockIdx.z * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);
  const int nk = (n_end - n_begin + MMA_BK - 1) / MMA_BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  extern __shared__ float4 smem_f4[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_f4);

  auto fetch = [&](int c) {                           // chunk c into its stage, one group
    if (c < nk) {
      __nv_bfloat16* a_s = sm + (c % MMA_STAGES) * STAGE;
      __nv_bfloat16* b_s = a_s + MMA_BK * MMA_PITCH;
      const int n0 = n_begin + c * MMA_BK;
      for (int i = tid; i < MMA_BK * (BM / 8); i += THREADS) {
        const int nn = i / (BM / 8), q = (i % (BM / 8)) * 8, n = n0 + nn;
        const bool va = n < n_end && n >= R && m0 + q < H;
        cp_async16(a_s + nn * MMA_PITCH + q, va ? hs + (size_t)(n - R) * H + m0 + q : hs,
                   va ? 16 : 0);
        const bool vb = n < n_end && j0 + q < G;
        cp_async16(b_s + nn * MMA_PITCH + q, vb ? dx + (size_t)n * G + j0 + q : dx,
                   vb ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[4][4][4] = {};
  for (int c = 0; c < MMA_STAGES - 1; ++c) fetch(c);
  const int mat = lane >> 3, r8 = lane & 7;
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<MMA_STAGES - 2>();                  // chunk c has landed (this thread's part)
    __syncthreads();                                  // ... every thread's; stage c - 1 is free
    fetch(c + MMA_STAGES - 1);
    const __nv_bfloat16* a_s = sm + (c % MMA_STAGES) * STAGE;
    const __nv_bfloat16* b_s = a_s + MMA_BK * MMA_PITCH;
#pragma unroll
    for (int ks = 0; ks < MMA_BK; ks += 16) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)                  // tiles (m 0-7 | 8-15) x (k 0-7 | 8-15)
        ldsm_x4_trans(af[mt], a_s + (ks + (mat >> 1) * 8 + r8) * MMA_PITCH + wm * 64 + mt * 16 +
                                  (mat & 1) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {                // (k 0-7 | 8-15) x (j 0-7 | 8-15)
        unsigned t[4];
        ldsm_x4_trans(t, b_s + (ks + (mat & 1) * 8 + r8) * MMA_PITCH + wn * 32 + np * 16 +
                             (mat >> 1) * 8);
        bf[2 * np][0] = t[0];
        bf[2 * np][1] = t[1];
        bf[2 * np + 1][0] = t[2];
        bf[2 * np + 1][1] = t[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
  const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int m = m0 + wm * 64 + mt * 16 + g, j = j0 + wn * 32 + nt * 8 + q2;
      if (j >= G) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (m + 8 * h < H) {
          float* o = dw + (size_t)(m + 8 * h) * G + j;
          add_out(o, acc[mt][nt][2 * h]);
          add_out(o + 1, acc[mt][nt][2 * h + 1]);
        }
    }
}

// float32 (true float32: no TF32): the same tile on CUDA cores; 16 x 16
// threads with 8 x 8 outputs each, at m = 4 ty + (0..3, 64..67) and j = 4 tx
// + (0..3, 64..67), so that a warp's float4 reads of a staged row are
// contiguous. Per row n a thread reads 4 float4 for 64 FMAs (a warp 384
// distinct bytes for 2048 FMAs, 0.19 B an FMA). Stages by cp.async, two
// chunks of 8 rows in flight ahead.
__global__ void __launch_bounds__(dw::THREADS)
lstm_dw_fma_kernel(const float* __restrict__ hs, const float* __restrict__ dx,
                   float* __restrict__ dw, int R, int N, int H, int rows_per_split) {
  using namespace dw;
  constexpr int STAGE = FMA_BK * (BM + BN);           // A [FMA_BK][BM] then B [FMA_BK][BN]
  const int G = 4 * H;
  const int m0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int n_begin = blockIdx.z * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);
  const int nk = (n_end - n_begin + FMA_BK - 1) / FMA_BK;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);

  auto fetch = [&](int c) {
    if (c < nk) {
      float* a_s = sm + (c % FMA_STAGES) * STAGE;
      float* b_s = a_s + FMA_BK * BM;
      const int n0 = n_begin + c * FMA_BK;
      for (int i = tid; i < FMA_BK * (BM / 4); i += THREADS) {
        const int nn = i / (BM / 4), q = (i % (BM / 4)) * 4, n = n0 + nn;
        const bool va = n < n_end && n >= R && m0 + q < H;
        cp_async16(a_s + nn * BM + q, va ? hs + (size_t)(n - R) * H + m0 + q : hs, va ? 16 : 0);
        const bool vb = n < n_end && j0 + q < G;
        cp_async16(b_s + nn * BN + q, vb ? dx + (size_t)n * G + j0 + q : dx, vb ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[8][8] = {};
  for (int c = 0; c < FMA_STAGES - 1; ++c) fetch(c);
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<FMA_STAGES - 2>();
    __syncthreads();
    fetch(c + FMA_STAGES - 1);
    const float* a_s = sm + (c % FMA_STAGES) * STAGE;
    const float* b_s = a_s + FMA_BK * BM;
#pragma unroll
    for (int nn = 0; nn < FMA_BK; ++nn) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + nn * BM + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a_s + nn * BM + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + nn * BN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(b_s + nn * BN + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int y = 0; y < 8; ++y)
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[y][x] = fmaf(av[y], bv[x], acc[y][x]);
    }
  }
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    const int m = m0 + (y >> 2) * 64 + ty * 4 + (y & 3);
    if (m >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h * 64 + tx * 4;
      if (j < G)
#pragma unroll
        for (int e = 0; e < 4; ++e) add_out(dw + (size_t)m * G + j + e, acc[y][4 * h + e]);
    }
  }
}

template <typename T, int RT>
int launch_fwd_hc(const void* xp, const void* w_hh, void* hs, void* cs, int R, int Tn, int H,
                  cudaStream_t stream) {
  const int G = 4 * H;
  int max_smem = 0, ksm = 0;
  cudaError_t e = max_dynamic_smem(&max_smem);
  if (e != cudaSuccess) return e;
  const long fixed = (long)sizeof(float) * (2 * RT * H + RT * G);
  const size_t smem = smem_with_whh<T>(fixed, H, max_smem, &ksm);
  if (smem == 0) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(lstm_fwd_hc_kernel<T, RT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  lstm_fwd_hc_kernel<T, RT><<<(R + RT - 1) / RT, G, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(w_hh), static_cast<T*>(hs),
      static_cast<T*>(cs), R, Tn, H, ksm);
  return cudaGetLastError();
}

template <typename T, int RT>
int launch_bwd(const void* xp, const void* hs, const void* cs, const void* dhs,
               const void* w_hh, void* dx, int R, int Tn, int H, cudaStream_t stream) {
  constexpr int S = 32 / RT;
  const int G = 4 * H;
  int max_smem = 0, ksm = 0;
  cudaError_t e = max_dynamic_smem(&max_smem);
  if (e != cudaSuccess) return e;
  const long fixed = (long)sizeof(float) * (RT * S * H + 2 * RT * G + RT * H);
  const size_t smem = smem_with_whh<T>(fixed, H, max_smem, &ksm);
  if (smem == 0) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(lstm_bwd_kernel<T, RT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  lstm_bwd_kernel<T, RT><<<(R + RT - 1) / RT, G, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(hs), static_cast<const T*>(cs),
      static_cast<const T*>(dhs), static_cast<const T*>(w_hh), static_cast<T*>(dx),
      R, Tn, H, ksm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dw_set_smem() {
  if constexpr (std::is_same_v<T, float>)
    return cudaFuncSetAttribute(lstm_dw_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                dw::smem_bytes<T>());
  else
    return cudaFuncSetAttribute(lstm_dw_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                dw::smem_bytes<T>());
}

// The plan (nsplit splits of rows_per_split rows, smem bytes) comes from the
// caller; it must cover every row exactly once and match this build's tiles.
template <typename T>
int launch_dw(const void* hs, const void* dx, float* dw, int R, int Tn, int H, int nsplit,
              int rows_per_split, int smem, cudaStream_t stream) {
  const long N = (long)R * Tn;
  if (smem != dw::smem_bytes<T>() || rows_per_split <= 0 || (long)nsplit * rows_per_split < N ||
      (long)(nsplit - 1) * rows_per_split >= N)
    return cudaErrorInvalidValue;
  cudaError_t e = dw_set_smem<T>();
  if (e != cudaSuccess) return e;
  const int G = 4 * H;
  const dim3 grid((G + dw::BN - 1) / dw::BN, (H + dw::BM - 1) / dw::BM, nsplit);
  if constexpr (std::is_same_v<T, float>)
    lstm_dw_fma_kernel<<<grid, dw::THREADS, smem, stream>>>(
        static_cast<const float*>(hs), static_cast<const float*>(dx), dw, R, (int)N, H,
        rows_per_split);
  else
    lstm_dw_mma_kernel<<<grid, dw::THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(hs), static_cast<const __nv_bfloat16*>(dx), dw,
        R, (int)N, H, rows_per_split);
  return cudaGetLastError();
}

template <typename T>
int dw_blocks_per_sm(int* blocks) {
  cudaError_t e = dw_set_smem<T>();
  if (e != cudaSuccess) return e;
  if constexpr (std::is_same_v<T, float>)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lstm_dw_fma_kernel, dw::THREADS,
                                                         dw::smem_bytes<T>());
  else
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lstm_dw_mma_kernel, dw::THREADS,
                                                         dw::smem_bytes<T>());
}

// the recurrences run one thread per gate column (4H <= 512); the dW
// reduction is tiled and takes the wide kernels' H <= 768 (csrc/lstm_bwd_wide.cu)
bool bad_shape(int R, int Tn, int H, int max_h = 128) {
  return R <= 0 || Tn <= 0 || H <= 0 || H > max_h || H % 8;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x_proj (T, R, 4H), w_hh (H, 4H), hs/cs (T, R, H),
// all contiguous on the current device. rt: rows per block (2, 4 or 8).
// Each entry returns the cudaError_t of the launch (0 on success).
extern "C" int lstm_fwd_hc_launch(int dtype, const void* xp, const void* w_hh, void* hs,
                                  void* cs, int R, int Tn, int H, int rt, void* stream) {
  if (bad_shape(R, Tn, H)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD(TY, RTV) return launch_fwd_hc<TY, RTV>(xp, w_hh, hs, cs, R, Tn, H, s)
  if (dtype == 0) {
    if (rt == 2) FWD(float, 2);
    if (rt == 4) FWD(float, 4);
    if (rt == 8) FWD(float, 8);
  } else if (dtype == 1) {
    if (rt == 2) FWD(__nv_bfloat16, 2);
    if (rt == 4) FWD(__nv_bfloat16, 4);
    if (rt == 8) FWD(__nv_bfloat16, 8);
  }
#undef FWD
  return cudaErrorInvalidValue;
}

// x_proj (T, R, 4H), hs/cs/dhs (T, R, H), w_hh (H, 4H) -> dx_proj (T, R, 4H).
extern "C" int lstm_bwd_launch(int dtype, const void* xp, const void* hs, const void* cs,
                               const void* dhs, const void* w_hh, void* dx, int R, int Tn,
                               int H, int rt, void* stream) {
  if (bad_shape(R, Tn, H)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD(TY, RTV) return launch_bwd<TY, RTV>(xp, hs, cs, dhs, w_hh, dx, R, Tn, H, s)
  if (dtype == 0) {
    if (rt == 2) BWD(float, 2);
    if (rt == 4) BWD(float, 4);
    if (rt == 8) BWD(float, 8);
  } else if (dtype == 1) {
    if (rt == 2) BWD(__nv_bfloat16, 2);
    if (rt == 4) BWD(__nv_bfloat16, 4);
    if (rt == 8) BWD(__nv_bfloat16, 8);
  }
#undef BWD
  return cudaErrorInvalidValue;
}

// hs (T, R, H), dx_proj (T, R, 4H) -> dw float32 (H, 4H): split s sums rows
// [s * rows_per_split, (s + 1) * rows_per_split) of the T*R rows and adds them
// into dw, which the caller zeroes when nsplit > 1 (one split stores); smem is
// the plan's dynamic shared memory (ops/lstm.py `dw_plan`), checked against
// this build's. All 16-byte aligned.
extern "C" int lstm_dw_launch(int dtype, const void* hs, const void* dx, void* dw, int R,
                              int Tn, int H, int nsplit, int rows_per_split, int smem,
                              void* stream) {
  if (bad_shape(R, Tn, H, 768) || nsplit <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  if (dtype == 0) return launch_dw<float>(hs, dx, out, R, Tn, H, nsplit, rows_per_split, smem, s);
  if (dtype == 1)
    return launch_dw<__nv_bfloat16>(hs, dx, out, R, Tn, H, nsplit, rows_per_split, smem, s);
  return cudaErrorInvalidValue;
}

// Blocks of the dW kernel for `dtype` that one SM holds at once (the plan's
// blocks_per_sm), into *blocks.
extern "C" int lstm_dw_blocks_per_sm(int dtype, int* blocks) {
  if (dtype == 0) return dw_blocks_per_sm<float>(blocks);
  if (dtype == 1) return dw_blocks_per_sm<__nv_bfloat16>(blocks);
  return cudaErrorInvalidValue;
}
