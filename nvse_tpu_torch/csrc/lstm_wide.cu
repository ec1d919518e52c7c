// Residual-saving LSTM forward and reverse-time LSTM backward for wide hidden
// sizes (128 < H <= 768) and few rows, for Hopper (sm_90a).
//
// Replaces, at those sizes, the TPU kernels of nvse_tpu/ops/pallas_lstm_bwd.py:
//   lstm_fwd_hc_wide_kernel <- `_fwd_kernel_hc` / `_fwd_kernel_hc_unrolled`
//                              (launched by `lstm_fwd_hc`, pallas_lstm_bwd.py:181)
//   lstm_bwd_wide_kernel    <- `_bwd_kernel` / `_bwd_kernel_unrolled`, the
//                              reverse-time recurrence (launched by `lstm_bwd`,
//                              pallas_lstm_bwd.py:339)
// dW_hh is lstm_dw_kernel of csrc/lstm_bwd.cu, which is tiled and takes any H;
// csrc/lstm_bwd.cu's recurrences (one thread per gate column) stop at H = 128.
//
// Contract: that of csrc/lstm_bwd.cu (time-major, one scan, zero initial
// state, gate order i, f, g, o):
//   forward:  gates_t = x_proj[t] + h_{t-1} @ W_hh
//             c_t = f * c_{t-1} + i * g;  h_t = o * tanh(c_t)       -> hs, cs (T, R, H)
//   backward: dh = dhs[t] + dh_carry;  dc = dc_carry + dh * o * (1 - tanh(c_t)^2)
//             dgates = [dc*g*i*(1-i), dc*c_{t-1}*f*(1-f), dc*i*(1-g^2), dh*tanh(c_t)*o*(1-o)]
//             dx_proj[t] = dgates;  dh_carry = dgates @ W_hh^T;  dc_carry = dc * f
// x_proj, W_hh, hs, cs, dhs and dx_proj are all float32 or all bfloat16. The
// forward's state is float32 and its product multiplies the float32 h, not h
// rounded to the weight type (pallas_lstm_bwd.py:148); hs and cs are stored in
// the x_proj type. The backward reads h_{t-1}, c_t and c_{t-1} as stored, sums
// both products in float32, keeps the carries in float32 and stores dx_proj in
// the x_proj type.
//
// What bounds them. GCRN training: T = 65 steps over R = 16 rows (the batch)
// at H = 448, four scans a step. A forward scan is 1.67 GFLOP on 4.7 MB (f32),
// the backward twice the operations: 0.025 and 0.05 ms of the f32 peak. In
// fact each is a chain of 65 dependent steps, each a (16, 448) @ (448, 1792)
// product against a W_hh of 3.2 MB (f32) that no block's shared memory holds,
// so a step's latency (grid barrier, exchange through L2) bounds them.
//
// Design: csrc/lstm_bidir2.cu's layout. The hidden units are spread over the
// card: a block owns U hidden units (U = 8 at H = 448: 56 blocks), keeps the
// (H, 4U) column slice of W_hh for its units' four gates in shared memory
// (float32, row stride 4U + 1) for the whole scan, and one cooperative grid
// barrier separates the steps. The launcher picks the smallest U whose grid is
// co-resident and otherwise returns cudaErrorCooperativeLaunchTooLarge: a
// launch error, never a hang. Inside a block: 512 threads as KS k-slices x
// 32-padded gate columns for the product over the 8 rows of a row tile (h
// broadcast from shared memory as float4), partial sums meeting in shared
// memory, one thread per (row, unit) for the cell. More rows run as row tiles.
// - Forward: the cell of (row, unit) stays in its block (c in a float32
//   scratch only that thread touches). The unrounded h goes to a float32
//   exchange buffer (2, R, H), double-buffered by step parity: every block
//   reads all of h_{t-1} from slot (t - 1) & 1 through L2 and writes its units
//   of h_t to slot t & 1, which no block reads before the next barrier.
// - Backward: per step, the block recomputes its units' gates from the saved
//   h_{t-1} (the same product as the forward, off the dependent chain: it
//   reads hs, not the carry), runs the cell backward for its (row, unit) pairs
//   (dc carried in a float32 scratch), writes dx_proj, and then, instead of
//   publishing its 4U dgates columns for every block to read all 4H, computes
//   its share of the next carry with the same W_hh slice: part[b][r][k] =
//   sum over its columns j of dgates[r][j] * W_hh[k][j], for all k < H. After
//   the barrier each block sums the shares of its own units over the blocks.
//   Per block and step that is R x H floats written and R x H read, against R
//   x 4H read for the dgates exchange, and one W_hh slice instead of two. The
//   shares are double-buffered by step parity as the forward's h.
// CUDA cores in float32; tensor cores, both scans of a GCRN pair in one launch
// and a cheaper barrier are later work.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// plain C entries (lstm_fwd_hc_wide_launch, lstm_bwd_wide_launch), loaded
// through ctypes.
#include <cooperative_groups.h>

#include "lstm_cell.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace lstm;

constexpr int RT = 8;          // rows per tile (accumulators per thread)
constexpr int THREADS = 512;
constexpr int UNITS[] = {8, 12, 16, 24, 32};   // units per block, tried in order

// A block's share of one scan: U hidden units and their NC = 4U gate columns
// (column = gate * U + unit); the W_hh slice is (H, NC) float32 with row stride
// NCS = NC + 1 (odd, so that lanes reading down a column hit distinct banks);
// the product runs as KS k-slices of NCP (NC padded to a warp) columns.
struct Slice {
  int U, NC, NCS, NCP, KS;
  __host__ __device__ explicit Slice(int u)
      : U(u), NC(4 * u), NCS(4 * u + 1), NCP((4 * u + 31) & ~31),
        KS(THREADS / ((4 * u + 31) & ~31)) {}
};

// dynamic shared memory of one block in floats: h tile, product partial sums,
// (backward: dgates tile, carry partial sums,) W_hh slice
inline size_t smem_floats(int H, int U, bool bwd) {
  const Slice s(U);
  size_t n = (size_t)RT * H + (size_t)s.KS * RT * s.NC + (size_t)H * s.NCS;
  if (bwd) n += (size_t)s.NC * RT + (size_t)(THREADS / (RT * U)) * RT * U;
  return n;
}

// columns of units [u0, u0 + U) of w (H, 4H) into w_s (H, NCS) as float32
template <typename T>
__device__ __forceinline__ void stage_slice(float* w_s, const T* __restrict__ w, int H, int u0,
                                            const Slice& s) {
  const int G = 4 * H;
  for (int i = threadIdx.x; i < H * s.NC; i += blockDim.x) {
    const int k = i / s.NC, col = i - k * s.NC;
    const int q = col / s.U, unit = u0 + col - q * s.U;
    w_s[k * s.NCS + col] = unit < H ? to_f<T>(w[(size_t)k * G + q * H + unit]) : 0.0f;
  }
}

// rows r0 .. r0 + RT of src (R, H) into h_s (RT, H) as float32, zeros past R
template <typename T>
__device__ __forceinline__ void stage_rows(float* h_s, const T* src, int R, int H, int r0) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = H / VEC;
  for (int i = threadIdx.x; i < RT * per_row; i += blockDim.x) {
    const int rr = i / per_row, k = (i - rr * per_row) * VEC;
    float* dst = h_s + rr * H + k;
    if (r0 + rr < R) {
      load_h16(src + (size_t)(r0 + rr) * H + k, dst);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[e] = 0.0f;
    }
  }
}

// p_s[ks][r][col] = sum over k-slice ks of h_s[r][k] * w_s[k][col], for the
// RT rows of the tile
__device__ __forceinline__ void slice_product(const float* h_s, const float* w_s, float* p_s,
                                              int H, const Slice& s) {
  const int pks = threadIdx.x / s.NCP, pc = threadIdx.x - pks * s.NCP;
  if (pks >= s.KS || pc >= s.NC) return;
  const int kc0 = pks * (H / 4) / s.KS, kc1 = (pks + 1) * (H / 4) / s.KS;
  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.0f;
  for (int kc = kc0; kc < kc1; ++kc) {
    const int k = kc * 4;
    float wv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) wv[e] = w_s[(k + e) * s.NCS + pc];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float4 hv = *reinterpret_cast<const float4*>(h_s + r * H + k);
      acc[r] = fmaf(hv.x, wv[0], acc[r]);
      acc[r] = fmaf(hv.y, wv[1], acc[r]);
      acc[r] = fmaf(hv.z, wv[2], acc[r]);
      acc[r] = fmaf(hv.w, wv[3], acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) p_s[(pks * RT + r) * s.NC + pc] = acc[r];
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_hc_wide_kernel(const T* __restrict__ xp, const T* __restrict__ w, T* __restrict__ hs,
                        T* __restrict__ cs, float* hx, float* c_state, int R, int Tn, int H,
                        int U) {
  cg::grid_group grid = cg::this_grid();
  const Slice s(U);
  const int G = 4 * H, u0 = blockIdx.x * U, tid = threadIdx.x;

  extern __shared__ float4 smem_f4[];
  float* h_s = reinterpret_cast<float*>(smem_f4);     // [RT][H] h_{t-1} of the tile
  float* p_s = h_s + RT * H;                          // [KS][RT][NC]
  float* w_s = p_s + s.KS * RT * s.NC;                // [H][NCS]
  stage_slice(w_s, w, H, u0, s);

  // cell role: (row cr of the tile, unit cu of the block)
  const int cr = tid / U, cu = tid - cr * U, unit = u0 + cu;
  const bool cell_thread = tid < RT * U && unit < H;
  __syncthreads();

  for (int t = 0; t < Tn; ++t) {
    const float* h_prev = hx + (size_t)((t + 1) & 1) * R * H;   // slot (t - 1) & 1
    float* h_out = hx + (size_t)(t & 1) * R * H;
    for (int r0 = 0; r0 < R; r0 += RT) {
      const int row = r0 + cr;
      const bool cell_on = cell_thread && row < R;
      float xg[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c_prev = 0.0f;
      if (cell_on) {
        const T* x = xp + ((size_t)t * R + row) * G + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) xg[q] = to_f<T>(x[q * H]);
        if (t > 0) c_prev = c_state[(size_t)row * H + unit];
      }
      if (t > 0) {                       // h_{-1} = 0: the first step has no product
        stage_rows(h_s, h_prev, R, H, r0);
        __syncthreads();
        slice_product(h_s, w_s, p_s, H, s);
        __syncthreads();
      }
      if (cell_on) {
        if (t > 0) {
          for (int k = 0; k < s.KS; ++k) {
            const float* p = p_s + (k * RT + cr) * s.NC + cu;
#pragma unroll
            for (int q = 0; q < 4; ++q) xg[q] += p[q * U];
          }
        }
        const float c = sigmoid(xg[1]) * c_prev + sigmoid(xg[0]) * tanhf(xg[2]);
        const float h = sigmoid(xg[3]) * tanhf(c);
        const size_t o = ((size_t)t * R + row) * H + unit;
        hs[o] = from_f<T>(h);
        cs[o] = from_f<T>(c);
        h_out[(size_t)row * H + unit] = h;        // unrounded, for the next step's product
        c_state[(size_t)row * H + unit] = c;
      }
      // the next tile's h_s and p_s writes sit behind its own barriers
    }
    if (t + 1 < Tn) {
      __threadfence();                   // h_t visible to every block before the barrier
      grid.sync();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_wide_kernel(const T* __restrict__ xp, const T* __restrict__ hs, const T* __restrict__ cs,
                     const T* __restrict__ dhs, const T* __restrict__ w, T* __restrict__ dx,
                     float* part, float* dc_state, int R, int Tn, int H, int U) {
  cg::grid_group grid = cg::this_grid();
  const Slice s(U);
  const int G = 4 * H, nb = gridDim.x, blk = blockIdx.x, u0 = blk * U, tid = threadIdx.x;
  const int NO = RT * U;                 // (row, unit) pairs of a tile
  const int NS = THREADS / NO;           // slices of the carry's sum over blocks

  extern __shared__ float4 smem_f4[];
  float* h_s = reinterpret_cast<float*>(smem_f4);     // [RT][H] saved h_{t-1} of the tile
  float* p_s = h_s + RT * H;                          // [KS][RT][NC]
  float* dg_s = p_s + s.KS * RT * s.NC;               // [NC][RT] dgates of the tile
  float* red_s = dg_s + s.NC * RT;                    // [NS][NO] carry partial sums
  float* w_s = red_s + NS * NO;                       // [H][NCS]
  stage_slice(w_s, w, H, u0, s);

  const int cr = tid / U, cu = tid - cr * U, unit = u0 + cu;   // cell role (tid < NO)
  const int ro = tid % NO, rs = tid / NO;                      // carry-sum role
  __syncthreads();

  for (int t = Tn - 1; t >= 0; --t) {
    const bool has_carry = t + 1 < Tn;
    const float* carry = part + (size_t)((t + 1) & 1) * nb * R * H;   // written at step t + 1
    float* share = part + (size_t)(t & 1) * nb * R * H;
    for (int r0 = 0; r0 < R; r0 += RT) {
      const int row = r0 + cr;
      const bool cell_on = tid < NO && unit < H && row < R;
      float xg[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c = 0.0f, c_prev = 0.0f, dh = 0.0f, dcc = 0.0f;
      if (cell_on) {                     // this pair's saved values, loaded early
        const size_t o = ((size_t)t * R + row) * H + unit;
        const T* x = xp + ((size_t)t * R + row) * G + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) xg[q] = to_f<T>(x[q * H]);
        c = to_f<T>(cs[o]);
        if (t > 0) c_prev = to_f<T>(cs[o - (size_t)R * H]);
        dh = to_f<T>(dhs[o]);
        if (has_carry) dcc = dc_state[(size_t)row * H + unit];
      }
      if (has_carry && rs < NS) {        // dh_carry of the tile's pairs: sum of the blocks' shares
        const int rrow = r0 + ro / U, runit = u0 + ro % U;
        float sum = 0.0f;
        if (rrow < R && runit < H) {
          for (int b = rs; b < nb; b += NS)
            sum += __ldcg(carry + ((size_t)b * R + rrow) * H + runit);
        }
        red_s[rs * NO + ro] = sum;
      }
      if (t > 0) stage_rows(h_s, hs + (size_t)(t - 1) * R * H, R, H, r0);
      __syncthreads();
      if (t > 0) {                       // gate recompute from the saved h_{t-1}
        slice_product(h_s, w_s, p_s, H, s);
        __syncthreads();
      }

      if (tid < NO) {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // zero columns for units past H, rows past R
        if (cell_on) {
          if (t > 0) {
            for (int k = 0; k < s.KS; ++k) {
              const float* p = p_s + (k * RT + cr) * s.NC + cu;
#pragma unroll
              for (int q = 0; q < 4; ++q) xg[q] += p[q * U];
            }
          }
          if (has_carry) {
            for (int k = 0; k < NS; ++k) dh += red_s[k * NO + tid];
          }
          const float gi = sigmoid(xg[0]), gf = sigmoid(xg[1]), gg = tanhf(xg[2]),
                      go = sigmoid(xg[3]);
          const float tc = tanhf(c);
          const float dc = dcc + dh * go * (1.0f - tc * tc);
          d[0] = dc * gg * gi * (1.0f - gi);
          d[1] = dc * c_prev * gf * (1.0f - gf);
          d[2] = dc * gi * (1.0f - gg * gg);
          d[3] = dh * tc * go * (1.0f - go);
          dc_state[(size_t)row * H + unit] = dc * gf;
          T* dxr = dx + ((size_t)t * R + row) * G + unit;
#pragma unroll
          for (int q = 0; q < 4; ++q) dxr[q * H] = from_f<T>(d[q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) dg_s[(q * U + cu) * RT + cr] = d[q];
      }
      __syncthreads();

      if (t > 0) {   // this block's share of dh_{t-1}: dgates of its columns @ W_hh[:, columns]^T
        for (int k = tid; k < H; k += THREADS) {
          float acc[RT];
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] = 0.0f;
          const float* wk = w_s + k * s.NCS;
          for (int col = 0; col < s.NC; ++col) {
            const float wv = wk[col];
            const float4 a = *reinterpret_cast<const float4*>(dg_s + col * RT);
            const float4 b = *reinterpret_cast<const float4*>(dg_s + col * RT + 4);
            acc[0] = fmaf(a.x, wv, acc[0]);
            acc[1] = fmaf(a.y, wv, acc[1]);
            acc[2] = fmaf(a.z, wv, acc[2]);
            acc[3] = fmaf(a.w, wv, acc[3]);
            acc[4] = fmaf(b.x, wv, acc[4]);
            acc[5] = fmaf(b.y, wv, acc[5]);
            acc[6] = fmaf(b.z, wv, acc[6]);
            acc[7] = fmaf(b.w, wv, acc[7]);
          }
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            if (r0 + r < R) share[((size_t)blk * R + r0 + r) * H + k] = acc[r];
          }
        }
      }
      // the next tile's shared-memory writes sit behind its own barriers
    }
    if (t > 0) {
      __threadfence();                   // the shares visible to every block before the barrier
      grid.sync();
    }
  }
}

// The smallest U of UNITS whose grid of ceil(H / U) blocks fits this device at
// once; sets *U and *smem (bytes). cudaErrorCooperativeLaunchTooLarge if none.
template <typename K>
cudaError_t pick_units(K kernel, int H, bool bwd, int* U, size_t* smem) {
  int dev = 0, n_sm = 0, max_smem = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if ((e = max_dynamic_smem(&max_smem)) != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  for (int u : UNITS) {
    const size_t bytes = sizeof(float) * smem_floats(H, u, bwd);
    if (bytes > (size_t)max_smem) continue;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes);
    if (e != cudaSuccess) return e;
    if ((H + u - 1) / u > per_sm * n_sm) continue;
    *U = u;
    *smem = bytes;
    return cudaSuccess;
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

template <typename T>
int launch_fwd(const void* xp, const void* w_hh, void* hs, void* cs, float* hx, float* c_state,
               int R, int Tn, int H, cudaStream_t stream) {
  int U = 0;
  size_t smem = 0;
  cudaError_t e = pick_units(lstm_fwd_hc_wide_kernel<T>, H, false, &U, &smem);
  if (e != cudaSuccess) return e;
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(w_hh);
  T* h = static_cast<T*>(hs);
  T* c = static_cast<T*>(cs);
  void* args[] = {&x, &w, &h, &c, &hx, &c_state, &R, &Tn, &H, &U};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lstm_fwd_hc_wide_kernel<T>),
                                  dim3((H + U - 1) / U), dim3(THREADS), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* xp, const void* hs, const void* cs, const void* dhs, const void* w_hh,
               void* dx, float* part, float* dc_state, int R, int Tn, int H, cudaStream_t stream) {
  int U = 0;
  size_t smem = 0;
  cudaError_t e = pick_units(lstm_bwd_wide_kernel<T>, H, true, &U, &smem);
  if (e != cudaSuccess) return e;
  const T* x = static_cast<const T*>(xp);
  const T* h = static_cast<const T*>(hs);
  const T* c = static_cast<const T*>(cs);
  const T* d = static_cast<const T*>(dhs);
  const T* w = static_cast<const T*>(w_hh);
  T* out = static_cast<T*>(dx);
  void* args[] = {&x, &h, &c, &d, &w, &out, &part, &dc_state, &R, &Tn, &H, &U};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lstm_bwd_wide_kernel<T>),
                                  dim3((H + U - 1) / U), dim3(THREADS), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

bool bad_shape(int R, int Tn, int H) { return R <= 0 || Tn <= 0 || H <= 0 || H % 8; }

}  // namespace

// dtype: 0 float32, 1 bfloat16. x_proj (T, R, 4H), w_hh (H, 4H) -> hs, cs (T, R, H);
// hx float32 (2, R, H) and c_state float32 (R, H) scratch; all contiguous on the
// current device, H % 8 == 0. Returns the cudaError_t of the launch (0 on
// success; cudaErrorCooperativeLaunchTooLarge when no split of the hidden units
// makes a grid that is co-resident on this device).
extern "C" int lstm_fwd_hc_wide_launch(int dtype, const void* xp, const void* w_hh, void* hs,
                                       void* cs, void* hx, void* c_state, int R, int Tn, int H,
                                       void* stream) {
  if (bad_shape(R, Tn, H)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* x = static_cast<float*>(hx);
  float* c = static_cast<float*>(c_state);
  if (dtype == 0) return launch_fwd<float>(xp, w_hh, hs, cs, x, c, R, Tn, H, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(xp, w_hh, hs, cs, x, c, R, Tn, H, s);
  return cudaErrorInvalidValue;
}

// x_proj (T, R, 4H), hs/cs/dhs (T, R, H), w_hh (H, 4H) -> dx_proj (T, R, 4H);
// part float32 (2, ceil(H / 8), R, H) and dc_state float32 (R, H) scratch.
extern "C" int lstm_bwd_wide_launch(int dtype, const void* xp, const void* hs, const void* cs,
                                    const void* dhs, const void* w_hh, void* dx, void* part,
                                    void* dc_state, int R, int Tn, int H, void* stream) {
  if (bad_shape(R, Tn, H)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* d = static_cast<float*>(dc_state);
  if (dtype == 0) return launch_bwd<float>(xp, hs, cs, dhs, w_hh, dx, p, d, R, Tn, H, s);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(xp, hs, cs, dhs, w_hh, dx, p, d, R, Tn, H, s);
  return cudaErrorInvalidValue;
}
