// Residual-saving LSTM forward and reverse-time LSTM backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of nvse_tpu/ops/pallas_lstm_bwd.py:
//   lstm_fwd_hc_kernel <- `_fwd_kernel_hc` / `_fwd_kernel_hc_unrolled`
//                         (launched by `lstm_fwd_hc`, pallas_lstm_bwd.py:181)
//   lstm_bwd_kernel    <- `_bwd_kernel` / `_bwd_kernel_unrolled`
//   lstm_dw_kernel        (both launched by `lstm_bwd`, pallas_lstm_bwd.py:339;
//                         dW_hh is summed there inside the kernel body)
// The unrolled TPU variants are the same functions at other unroll factors.
//
// Contract (time-major, one direction, zero initial state, gate order i,f,g,o):
//   forward:  gates_t = x_proj[t] + h_{t-1} @ W_hh
//             c_t = f * c_{t-1} + i * g;  h_t = o * tanh(c_t)       -> hs, cs (T, R, H)
//   backward: dh = dhs[t] + dh_carry;  dc = dc_carry + dh * o * (1 - tanh(c_t)^2)
//             dgates = [dc*g*i*(1-i), dc*c_{t-1}*f*(1-f), dc*i*(1-g^2), dh*tanh(c_t)*o*(1-o)]
//             dx_proj[t] = dgates;  dh_carry = dgates @ W_hh^T;  dc_carry = dc * f
//             dW_hh = sum_{t, r} h_{t-1}^T dgates                    (lstm_dw_kernel)
// with h_{-1} = c_{-1} = 0 read as zeros at t = 0 (no shifted copies in memory).
// Types follow the TPU residual kernels: x_proj, W_hh, hs, cs, dhs and dx_proj
// are all float32 or all bfloat16. The forward state is float32 and the product
// multiplies the float32 h (h is not rounded to the weight type, unlike the
// inference kernel; pallas_lstm_bwd.py:148); hs and cs are stored in the
// x_proj type. The backward reads h_{t-1}, c_t and c_{t-1} as stored, sums
// both products in float32, keeps the carries in float32 and stores dx_proj in
// the x_proj type. dW sums the stored dx_proj in float32 into per-split
// partials; the caller adds the partials and casts once.
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
// - lstm_dw_kernel: dW_hh is (H, 4H) = 256 KiB in float32, which fits
//   neither a block's shared memory nor its registers, so it is a second
//   kernel (also that of the wide recurrence of csrc/lstm_wide.cu, up to
//   H = 768): a tiled reduction over the T*R rows of [h_{t-1} | dx_proj]
//   (64 x 64 output tiles, 4 x 4 per thread, 16 rows staged per pass),
//   split over the rows so that the grid fills the card; each split writes
//   float32 partials (nsplit, H, 4H).
// wgmma, TMA and clusters are later work.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// plain C entries (lstm_fwd_hc_launch, lstm_bwd_launch, lstm_dw_launch),
// loaded through ctypes.
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

// partial[split][k][j] = sum over rows n of this split of h_{t-1}[n][k] * dx[n][j],
// n = t * R + r over all T*R rows; h_{t-1} of row n is hs row n - R (zero for n < R).
constexpr int DW_TK = 64, DW_TJ = 64, DW_NB = 16;

template <typename T>
__global__ void __launch_bounds__(256)
lstm_dw_kernel(const T* __restrict__ hs, const T* __restrict__ dx, float* __restrict__ partial,
               int R, int N, int H, int rows_per_split) {
  const int G = 4 * H;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;           // 16 x 16 threads, 4 x 4 outputs each
  const int j0 = blockIdx.x * DW_TJ, k0 = blockIdx.y * DW_TK;
  const int n_begin = blockIdx.z * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);

  __shared__ float4 a_s4[DW_NB * DW_TK / 4];         // [NB][TK] h_{t-1}
  __shared__ float4 b_s4[DW_NB * DW_TJ / 4];         // [NB][TJ] dx
  float* a_s = reinterpret_cast<float*>(a_s4);
  float* b_s = reinterpret_cast<float*>(b_s4);

  float acc[4][4] = {};
  for (int n0 = n_begin; n0 < n_end; n0 += DW_NB) {
    for (int i = tid; i < DW_NB * DW_TK; i += 256) {
      const int nn = i / DW_TK, kk = i - nn * DW_TK;
      const int n = n0 + nn, k = k0 + kk;
      a_s[i] = (n < n_end && n >= R && k < H) ? to_f<T>(hs[(size_t)(n - R) * H + k]) : 0.0f;
    }
    for (int i = tid; i < DW_NB * DW_TJ; i += 256) {
      const int nn = i / DW_TJ, jj = i - nn * DW_TJ;
      const int n = n0 + nn, jc = j0 + jj;
      b_s[i] = (n < n_end && jc < G) ? to_f<T>(dx[(size_t)n * G + jc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < DW_NB; ++nn) {
      float a[4], b[4];
      load4(a_s + nn * DW_TK + ty * 4, a);
      load4(b_s + nn * DW_TJ + tx * 4, b);
#pragma unroll
      for (int y = 0; y < 4; ++y)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[y][x] = fmaf(a[y], b[x], acc[y][x]);
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.z * H * G;
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const int k = k0 + ty * 4 + y;
    if (k >= H) continue;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int jc = j0 + tx * 4 + x;
      if (jc < G) out[(size_t)k * G + jc] = acc[y][x];
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
int launch_dw(const void* hs, const void* dx, float* partial, int R, int Tn, int H, int nsplit,
              cudaStream_t stream) {
  const int G = 4 * H;
  const int N = R * Tn;
  const int per = (N + nsplit - 1) / nsplit;
  const dim3 grid((G + DW_TJ - 1) / DW_TJ, (H + DW_TK - 1) / DW_TK, nsplit);
  lstm_dw_kernel<T><<<grid, 256, 0, stream>>>(static_cast<const T*>(hs),
                                              static_cast<const T*>(dx), partial, R, N, H, per);
  return cudaGetLastError();
}

// the recurrences run one thread per gate column (4H <= 512); the dW
// reduction is tiled and takes the wide kernels' H <= 768 (csrc/lstm_wide.cu)
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

// hs (T, R, H), dx_proj (T, R, 4H) -> float32 partial (nsplit, H, 4H).
extern "C" int lstm_dw_launch(int dtype, const void* hs, const void* dx, void* partial, int R,
                              int Tn, int H, int nsplit, void* stream) {
  if (bad_shape(R, Tn, H, 768) || nsplit <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(partial);
  if (dtype == 0) return launch_dw<float>(hs, dx, out, R, Tn, H, nsplit, s);
  if (dtype == 1) return launch_dw<__nv_bfloat16>(hs, dx, out, R, Tn, H, nsplit, s);
  return cudaErrorInvalidValue;
}
