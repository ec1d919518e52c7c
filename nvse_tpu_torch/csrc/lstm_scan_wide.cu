// The wide forward LSTM scans (128 < H <= 768) for Hopper (sm_90a): the
// residual-saving forward of the training route and the inference scans, one
// kernel template with four compile-time modes.
//
// Replaces, at those sizes, the TPU kernels
//   kFwdHc     <- `_fwd_kernel_hc` / `_fwd_kernel_hc_unrolled` of
//                 nvse_tpu/ops/pallas_lstm_bwd.py (launched by `lstm_fwd_hc`,
//                 pallas_lstm_bwd.py:181)
//   kScan      <- `_lstm_kernel` / `_lstm_kernel_unrolled` of nvse_tpu/ops/pallas_lstm.py
//                 (launched by `_pallas_lstm_scan`, pallas_lstm.py:212)
//   kStateful  <- `_lstm_kernel_stateful` (launched by `_pallas_lstm_scan_stateful`,
//                 pallas_lstm.py:297)
//   kScanBidir <- `_make_bidir_kernel`, the two-direction scan over stacked rows
//                 (launched by `_pallas_lstm_scan_bidir`, pallas_lstm.py:427), and,
//                 with a pointer for each direction, `_dualdot_kernel` (launched by
//                 `_pallas_lstm_scan_bidir2`, pallas_lstm.py:499) where ops/lstm.py
//                 `bidir2_plan` takes no cluster of csrc/lstm_bidir2.cu
// csrc/lstm_scan.cu takes H <= 128 (its kFwdHc too).
//
// Contract, per row (gate order i, f, g, o), time-major:
//   gates_t = x_proj[t] + h_{t-1} @ W_hh
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g);  h_t = sigmoid(o) * tanh(c_t)
// kFwdHc:     x_proj (T, R, 4H), zero state -> hs, cs (T, R, H). The product
//             multiplies the unrounded float32 h, not h rounded to the weight
//             type (pallas_lstm_bwd.py:147-160).
// kScan:      x_proj (T, R, 4H), zero state -> hs (T, R, H).
// kStateful:  the same from the caller's (h0, c0), each (R, H) -> hs and cs.
// kScanBidir: x_proj (T, 2R, 4H), zero state -> hs (T, 2R, H); rows [d R, d R + R)
//             scan with w_hh[d], both directions forward in time (the TPU
//             kernel's block-diagonal product, which doubles the FLOPs, is not
//             carried over). With two pointers (lstm_scan_bidir2): x_proj and
//             hs of each direction (T, R, ...) in their own tensors.
// The inference modes round h to the weight type as stored and the product
// reads it back rounded (the `_hdot` rule, pallas_lstm.py:36-43). Every tensor
// is float32 or every tensor bfloat16; c and every sum are float32, hs and cs
// are stored in the x_proj type; the nonlinearities are exact (expf, tanhf).
//
// What bounds it. BSRNN-L (H = 256) runs kFwdHc at 544 rows x 65 steps (the
// time BiLSTM) and 1040 x 34 (the band BiLSTM), 32 launches a training step:
// 18.5 GFLOP a launch, 0.28 ms at the float32 peak and 0.02 ms at the bfloat16
// tensor-core peak; and kScan at 272 rows x 1024 steps (the causal decode's
// time LSTM): 146 GFLOP, 2.2 ms of the float32 peak, 0.15 ms of bfloat16's. Each
// is a chain of T dependent steps, and each step needs the whole of h_{t-1}
// of its rows; W_hh of one direction is 1 MB in float32 at H = 256, more than
// any block's shared memory.
//
// Design: the layout of csrc/lstm_bwd_wide.cu, which recomputes exactly this
// product in the backward. A block owns one (direction, row group, slice of U
// hidden units) for the whole launch, and the plan (ops/lstm.py
// `scan_wide_plan`) takes as many row groups of H / U blocks as the card holds
// at once. One cooperative grid barrier separates the steps, so a grid that
// cannot be co-resident is a launch error, never a hang. The block keeps the
// (H, 4U) column slice of W_hh for its units' four gates in shared memory. At
// each step it runs its group's rows in tiles of TM:
// - h_{t-1} of the tile's rows staged by cp.async.cg (through L2: L1 is not
//   coherent across SMs) from hs[t - 1] itself (the caller's h0 at the first
//   step of kStateful). kFwdHc in float32 reads the same (hs is the float32
//   h); in bfloat16 hs[t - 1] is hi = bf16(h) and a second plane lo = bf16(h -
//   hi), written beside it into a scratch by step parity, makes h = hi + lo to
//   about 2^-17 of h: two mma on the same W_hh fragment, the split of the
//   backward's carry (csrc/lstm_bwd_wide.cu); float16 (this mode only) the same
//   with f16 planes and products: h is in (-1, 1), so no scale is needed;
// - the tile's columns of x_proj for the next tile (or the next step's first)
//   prefetched by cp.async while this one runs: they are off the dependent
//   chain;
// - the product, h_{t-1} @ W_hh[:, its columns], float32 sums: bfloat16 on the
//   tensor cores (mma.sync m16n8k16, the slice [column][k] read through
//   ldmatrix), float32 as true float32 FMAs on the CUDA cores (no TF32: the
//   tile's rows dealt to the warps in turn and broadcast, the lanes over the
//   columns, the slice [k][column] with an odd pitch; the 8-row instance instead
//   splits k over the warps and a lane takes 8 rows x 8 columns);
// - the cell of each (row, unit) by one thread, c carried in a float32 scratch
//   that only that thread touches, hs (and cs, and the lo plane) written.
// The first step of a zero-state scan has no product (h_{-1} = 0).
// kScanBidir runs both directions' blocks in one launch where they are
// co-resident, else one launch a direction (the plan says which).
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// plain C entries (lstm_fwd_hc_wide_launch, lstm_scan_wide_launch,
// lstm_scan_stateful_wide_launch, lstm_scan_bidir_wide_launch,
// lstm_scan_bidir2_wide_launch, lstm_scan_wide_blocks_per_sm), loaded through ctypes.
#include <cooperative_groups.h>

#include <type_traits>

#include "lstm_cell.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace lstm;

constexpr int THREADS = 256;

enum Mode : int { kScan = 1, kStateful = 2, kScanBidir = 3, kFwdHc = 4 };

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// h reaches the product as two 16-bit planes, hi + lo (h is in (-1, 1): float16
// needs no scale)
template <typename T, int MODE>
constexpr bool kSplit = sizeof(T) == 2 && MODE == kFwdHc;

// The layout of one instance (T, MODE, U units, TM rows a tile); ops/lstm.py
// `_scan_wide_smem` mirrors it. bfloat16: w [4U][KP] (k padded to 16, rows 16
// bytes longer), h [planes][TM][KP] (two planes for kFwdHc), g float32
// [TM][4U + 8]; float32: w [H][4U + 1], h [TM][H + 4], g [TM][4U + 4]; then the x
// ring [2][TM][4U] in the input type.
template <typename T> struct Lay;
template <> struct Lay<__nv_bfloat16> {
  __host__ __device__ static int kp(int H) { return round_up(H, 16) + 8; }
  __host__ __device__ static long w(int U, int H) { return 4L * U * kp(H) * 2; }
  __host__ __device__ static long h(int TM, int H, int planes) { return (long)planes * TM * kp(H) * 2; }
  __host__ __device__ static int gp(int U) { return 4 * U + 8; }
};
template <> struct Lay<__half> : Lay<__nv_bfloat16> {};   // kFwdHc in float16
template <> struct Lay<float> {
  __host__ __device__ static int kp(int H) { return H + 4; }
  __host__ __device__ static long w(int U, int H) { return (long)H * (4 * U + 1) * 4; }
  __host__ __device__ static long h(int TM, int H, int) { return (long)TM * (H + 4) * 4; }
  __host__ __device__ static int gp(int U) { return 4 * U + 4; }
};

template <typename T, int MODE>
__host__ __device__ long smem_bytes(int U, int TM, int H) {
  using L = Lay<T>;
  const long g = (long)TM * L::gp(U) * 4, x = 2L * TM * 4 * U * (long)sizeof(T);
  // each part 16-byte aligned
  return round_up((int)L::w(U, H), 16) + round_up((int)L::h(TM, H, kSplit<T, MODE> ? 2 : 1), 16) +
         round_up((int)g, 16) + round_up((int)x, 16);
}

struct Args {
  const void* xp;         // (Tn, Rt, 4H)
  const void* xp2;        // kScanBidir with two pointers: direction 1's x_proj (Tn, R, 4H)
  const void* w_hh[2];    // (H, 4H) of each direction (one but for kScanBidir)
  const void* h0;         // kStateful: (R, H)
  const void* c0;         // kStateful: (R, H)
  void* hs;               // (Tn, Rt, H)
  void* hs2;              // kScanBidir with two pointers: direction 1's hs (Tn, R, H)
  void* cs;               // kFwdHc, kStateful: (Tn, Rt, H)
  void* lo;               // kFwdHc in 16 bits: (2, Rt, H) scratch, h - hi by step parity
  float* c_state;         // float32 (Rt, H) scratch: the c of each (row, unit)
  int R;                  // rows of one direction
  int Rt;                 // rows of x_proj and hs: R, or 2R for kScanBidir
  int Tn, H;
  int groups;             // row groups a direction (balanced: R * g / groups)
  int dir0;               // the first direction this launch runs
};

// float32 product of one warp: g[r * gstride + 32 i] = sum over k of h[8 r][k] *
// w[k][32 i] for its NR rows (8 apart in the tile) and NPL columns a lane; h rows
// of pitch kp, w of pitch wp (the lane's first column at w[0]). NR is a template
// argument so that the row loop is straight-line code: the loads of a k-step
// are issued before its FMAs.
template <int NR, int NPL>
__device__ __forceinline__ void fma_rows(const float* h, int kp, const float* w, int wp, int H,
                                         float* g, int gstride) {
  float acc[NR][NPL];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int i = 0; i < NPL; ++i) acc[r][i] = 0.0f;
  for (int k = 0; k < H; k += 4) {
    float wv[4][NPL];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < NPL; ++i) wv[e][i] = w[(k + e) * wp + 32 * i];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float4 hv = *reinterpret_cast<const float4*>(h + r * 8 * kp + k);
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        float s = acc[r][i];
        s = fmaf(hv.x, wv[0][i], s);
        s = fmaf(hv.y, wv[1][i], s);
        s = fmaf(hv.z, wv[2][i], s);
        s = fmaf(hv.w, wv[3][i], s);
        acc[r][i] = s;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int i = 0; i < NPL; ++i) g[r * gstride + 32 * i] = acc[r][i];
}

// fma_rows<nr> for a warp's run-time row count nr in [N, MAX] (none for nr < 1)
template <int N, int MAX, int NPL>
__device__ __forceinline__ void fma_rows_upto(int nr, const float* h, int kp, const float* w,
                                              int wp, int H, float* g, int gstride) {
  if constexpr (N <= MAX) {
    if (nr == N) return fma_rows<N, NPL>(h, kp, w, wp, H, g, gstride);
    fma_rows_upto<N + 1, MAX, NPL>(nr, h, kp, w, wp, H, g, gstride);
  }
}

template <typename T, int MODE, int U, int TM>
__global__ void __launch_bounds__(THREADS, 1) lstm_scan_wide_kernel(const Args a) {
  constexpr bool BF = sizeof(T) == 2;             // bfloat16 or float16: the tensor cores
  constexpr bool SPLIT = kSplit<T, MODE>;
  constexpr bool STATEFUL = MODE == kStateful;
  constexpr bool WRITE_C = MODE == kStateful || MODE == kFwdHc;
  constexpr int NC = 4 * U;                        // the block's gate columns
  constexpr int E = 16 / sizeof(T);                // values a 16-byte copy
  using L = Lay<T>;
  cg::grid_group grid = cg::this_grid();
  const int H = a.H, G = 4 * H, R = a.R, Rt = a.Rt, Tn = a.Tn;
  const int nbg = H / U;                           // blocks of a row group
  const int si = blockIdx.x % nbg, rest = blockIdx.x / nbg;
  const int gi = rest % a.groups, dir = a.dir0 + rest / a.groups;
  const int u0 = si * U;
  const int glo = (int)((long long)R * gi / a.groups);
  const bool two = a.xp2 != nullptr;               // each direction in its own tensors
  const int grow0 = (two ? 0 : dir * R) + glo;     // the group's first row of x_proj / hs
  const int crow0 = dir * R + glo;                 // ... of c_state
  const int grows = (int)((long long)R * (gi + 1) / a.groups) - glo;
  const int ntile = (grows + TM - 1) / TM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* xp = static_cast<const T*>(two && dir ? a.xp2 : a.xp);
  const T* w = static_cast<const T*>(a.w_hh[dir]);
  T* hs = static_cast<T*>(two && dir ? a.hs2 : a.hs);   // read back at the next step: no __restrict__
  T* cs = static_cast<T*>(a.cs);

  const int KP = L::kp(H);                         // pitch of an h row
  const int WP = BF ? KP : NC + 1;                 // pitch of a slice row
  const int GP = L::gp(U);                         // pitch of a g row
  extern __shared__ float4 smem_f4[];
  char* base = reinterpret_cast<char*>(smem_f4);
  T* w_s = reinterpret_cast<T*>(base);
  base += round_up((int)L::w(U, H), 16);
  T* h_s = reinterpret_cast<T*>(base);
  base += round_up((int)L::h(TM, H, SPLIT ? 2 : 1), 16);
  float* g_s = reinterpret_cast<float*>(base);
  base += round_up(TM * GP * 4, 16);
  T* x_s = reinterpret_cast<T*>(base);             // [2][TM][NC]: column q U + unit of gate q

  // the slice: bfloat16 [column = 4 unit + gate][k] (zeros past H in k), float32
  // [k][column]; the h tile's pad of k zeroed (cp.async writes [0, H) only)
  for (int i = tid; i < (BF ? NC * KP : H * NC); i += THREADS) {
    int col, k;
    if (BF) { col = i / KP; k = i - col * KP; }
    else { k = i / NC; col = i - k * NC; }
    const int unit = u0 + col / 4, gate = col & 3;
    const T v = k < H ? w[(size_t)k * G + gate * H + unit] : from_f<T>(0.0f);
    w_s[BF ? col * WP + k : k * WP + col] = v;
  }
  for (int i = tid; i < (SPLIT ? 2 : 1) * TM * KP; i += THREADS) h_s[i] = from_f<T>(0.0f);

  auto tile_r0 = [&](int p) { return (int)((long long)grows * p / ntile); };
  // x_proj[t] of tile p's rows, this block's columns (four runs of U at q H + u0)
  // into ring slot `slot`
  auto load_x = [&](int t, int p, int slot) {
    constexpr int CH = U / E;                      // 16-byte copies a run
    const int r0 = tile_r0(p), np = tile_r0(p + 1) - r0;
    const T* src = xp + ((size_t)t * Rt + grow0 + r0) * G + u0;
    T* dst = x_s + slot * TM * NC;
    for (int i = tid; i < np * 4 * CH; i += THREADS) {
      const int r = i / (4 * CH), rem = i - r * 4 * CH, q = rem / CH, c = rem - q * CH;
      cp_async16(dst + r * NC + q * U + c * E, src + (size_t)r * G + q * H + c * E, 16);
    }
  };
  load_x(0, 0, 0);
  cp_async_commit();
  __syncthreads();

  int slot = 0;
  for (int t = 0; t < Tn; ++t) {
    const bool product = t > 0 || STATEFUL;        // h_{-1} = 0 without a state
    for (int p = 0; p < ntile; ++p) {
      const int r0 = tile_r0(p), np = tile_r0(p + 1) - r0;
      const int row0 = grow0 + r0;                 // the tile's first row
      // 1. h_{t-1} of the tile's rows into h_s (and the lo plane), through L2
      if (product) {
        const T* src = t == 0 ? static_cast<const T*>(a.h0) + (size_t)row0 * H
                              : hs + ((size_t)(t - 1) * Rt + row0) * H;
        const T* lsrc =
            SPLIT ? static_cast<const T*>(a.lo) + ((size_t)((t - 1) & 1) * Rt + row0) * H : nullptr;
        for (int i = tid; i < np * (H / E); i += THREADS) {
          const int r = i / (H / E), k = (i - r * (H / E)) * E;
          cp_async16(h_s + r * KP + k, src + (size_t)r * H + k, 16);
          if constexpr (SPLIT) cp_async16(h_s + (TM + r) * KP + k, lsrc + (size_t)r * H + k, 16);
        }
      }
      cp_async_commit();
      // 2. the next tile's x_proj (or the next step's first tile's) into the other slot
      const bool last = p + 1 == ntile;
      if (!last || t + 1 < Tn) load_x(last ? t + 1 : t, last ? 0 : p + 1, slot ^ 1);
      cp_async_commit();
      cp_async_wait<1>();                          // this tile's h and x have landed
      __syncthreads();
      // 3. the product into g_s [row][column] (float32 sums)
      if (product) {
        if constexpr (BF) {
          // warp (wm, wn): m16 tile wm of MT; n16 pairs [wn PPW, wn PPW + PPW) of the 4U columns
          constexpr int MT = TM / 16, NW = 8 / MT, NP = NC / 16;
          constexpr int PPW = NP >= NW ? NP / NW : 1, NT = 2 * PPW;
          const int wm = warp % MT, wn = warp / MT;
          if (wm * 16 < np && wn * PPW < NP) {
            float acc[NT][4];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
            const int mat = lane >> 3, r8 = lane & 7;
            const T* arow = h_s + (wm * 16 + (lane & 15)) * KP + (lane >> 4) * 8;
            for (int k = 0; k < H; k += 16) {
              unsigned af[4], al[4];
              ldsm_x4(af, arow + k);
              if constexpr (SPLIT) ldsm_x4(al, arow + TM * KP + k);
#pragma unroll
              for (int pp = 0; pp < PPW; ++pp) {     // (cols 0-7 | 8-15) x (k 0-7 | 8-15)
                unsigned tq[4];
                ldsm_x4(tq, w_s + (size_t)((wn * PPW + pp) * 16 + (mat >> 1) * 8 + r8) * WP +
                                k + (mat & 1) * 8);
                mma16<T>(acc[2 * pp], af, tq[0], tq[1]);
                mma16<T>(acc[2 * pp + 1], af, tq[2], tq[3]);
                if constexpr (SPLIT) {
                  mma16<T>(acc[2 * pp], al, tq[0], tq[1]);
                  mma16<T>(acc[2 * pp + 1], al, tq[2], tq[3]);
                }
              }
            }
            const int rr = wm * 16 + (lane >> 2);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int col = (wn * NT + nt) * 8 + 2 * (lane & 3);
              *reinterpret_cast<float2*>(g_s + rr * GP + col) = make_float2(acc[nt][0], acc[nt][1]);
              *reinterpret_cast<float2*>(g_s + (rr + 8) * GP + col) =
                  make_float2(acc[nt][2], acc[nt][3]);
            }
          }
        } else if constexpr (TM == 8) {
          // few rows (the 8-row instance, H >= 512): warp w takes the k-slice
          // [w KW, w KW + KW) of all 8 rows; lane (c, kq) of 8 x 4 the columns
          // 8 c ... 8 c + 7 (NC = 64) at every fourth k of the slice, from kq: a
          // k step is 8 loads of h (4 words a load) and 8 of the slice for 64 FMAs a
          // lane. The 4 kq lanes' sums meet by shuffles, then the 8 slices' in the h
          // tile's memory once every warp has read it
          static_assert(NC == 64, "the 8-row product takes 16-unit slices");
          const float* hf = reinterpret_cast<const float*>(h_s);
          const float* wf = reinterpret_cast<const float*>(w_s);
          const int c8 = lane & 7, kq = lane >> 3;
          const int KW = (H + 8 * 4 - 1) / (8 * 4) * 4;
          float acc[8][8];
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[r][i] = 0.0f;
          const int kend = min(H, warp * KW + KW);
#pragma unroll 2
          for (int k = warp * KW + kq; k < kend; k += 4) {
            float hv[8], wv[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) hv[r] = hf[r * KP + k];
#pragma unroll
            for (int i = 0; i < 8; ++i) wv[i] = wf[k * WP + 8 * c8 + i];
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(hv[r], wv[i], acc[r][i]);
          }
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], 8);
              acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], 16);
            }
          __syncthreads();                           // every warp done with the h tile
          float* part = reinterpret_cast<float*>(h_s);   // [8 slices][8 rows][NC]
#pragma unroll
          for (int r = 0; r < 8; ++r)
            if ((r >> 1) == kq) {                    // lane kq writes rows 2 kq, 2 kq + 1
#pragma unroll
              for (int i = 0; i < 8; ++i) part[(warp * 8 + r) * NC + 8 * c8 + i] = acc[r][i];
            }
          __syncthreads();
          for (int o = tid; o < np * NC; o += THREADS) {
            const int r = o / NC, col = o - r * NC;
            float sum = 0.0f;
#pragma unroll
            for (int w8 = 0; w8 < 8; ++w8) sum += part[(w8 * 8 + r) * NC + col];
            g_s[r * GP + col] = sum;
          }
        } else {
          // warp: the tile's rows warp, warp + 8, ... (nr of them, so that a ragged
          // tile keeps every warp busy); lane: columns lane + 32 i
          const int nr = (np - warp + 7) / 8;
          fma_rows_upto<1, TM / 8, NC / 32>(nr, reinterpret_cast<const float*>(h_s) + warp * KP, KP,
                                           reinterpret_cast<const float*>(w_s) + lane, WP, H,
                                           g_s + warp * GP + lane, 8 * GP);
        }
      }
      __syncthreads();
      // 4. the cell of each (row, unit) of the tile
      const T* xt = x_s + slot * TM * NC;
      for (int c = tid; c < np * U; c += THREADS) {
        const int r = c / U, ul = c - r * U, row = row0 + r, unit = u0 + ul;
        const float4 gv = product ? *reinterpret_cast<const float4*>(g_s + r * GP + 4 * ul)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float z[4] = {to_f<T>(xt[r * NC + ul]) + gv.x, to_f<T>(xt[r * NC + U + ul]) + gv.y,
                            to_f<T>(xt[r * NC + 2 * U + ul]) + gv.z,
                            to_f<T>(xt[r * NC + 3 * U + ul]) + gv.w};
        float* cp = a.c_state + (size_t)(crow0 + r0 + r) * H + unit;
        float c_prev = 0.0f;
        if (t > 0) c_prev = __ldcg(cp);
        else if (STATEFUL) c_prev = to_f<T>(static_cast<const T*>(a.c0)[(size_t)row * H + unit]);
        const float cn = sigmoid(z[1]) * c_prev + sigmoid(z[0]) * tanhf(z[2]);
        const float h = sigmoid(z[3]) * tanhf(cn);
        const size_t o = ((size_t)t * Rt + row) * H + unit;
        const T hv = from_f<T>(h);
        hs[o] = hv;
        if (WRITE_C) cs[o] = from_f<T>(cn);
        if constexpr (SPLIT)
          static_cast<T*>(a.lo)[(size_t)(t & 1) * Rt * H + (size_t)row * H + unit] =
              from_f<T>(h - to_f<T>(hv));
        if (t + 1 < Tn) __stcg(cp, cn);
      }
      slot ^= 1;
      __syncthreads();                             // the next tile overwrites x_s, g_s
    }
    if (t + 1 < Tn) {
      __threadfence();                             // h_t visible to every block before the barrier
      grid.sync();
    }
  }
}

// the instances (dtype, U, TM); ops/lstm.py `_SCAN_WIDE` mirrors them (float32's
// (16, 8), with its own product over k-slices, only lstm_scan_bidir2 takes, at
// H >= 512: at H = 768 its 48-block groups put both directions' blocks on the card
// in one launch, with 8 rows a group)
template <int MODE, typename F>
int with_instance(int dtype, int U, int TM, F&& f) {
  using bf = __nv_bfloat16;
  using std::integral_constant;
#define SCAN_INST(TY, UU, MM)                                                      \
  if (U == UU && TM == MM)                                                         \
    return f((TY*)nullptr, integral_constant<int, UU>{}, integral_constant<int, MM>{});
  if constexpr (MODE == kFwdHc) {                  // float16: the training forward only
    if (dtype == 2) {
      SCAN_INST(__half, 32, 64) SCAN_INST(__half, 32, 32) SCAN_INST(__half, 16, 64)
      SCAN_INST(__half, 16, 32) SCAN_INST(__half, 8, 64) SCAN_INST(__half, 8, 32)
      return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    SCAN_INST(bf, 32, 64) SCAN_INST(bf, 32, 32) SCAN_INST(bf, 16, 64) SCAN_INST(bf, 16, 32)
    SCAN_INST(bf, 8, 64) SCAN_INST(bf, 8, 32)
  } else if (dtype == 0) {
    SCAN_INST(float, 16, 64) SCAN_INST(float, 16, 32) SCAN_INST(float, 8, 64)
    SCAN_INST(float, 8, 32) SCAN_INST(float, 16, 8)
  }
#undef SCAN_INST
  return cudaErrorInvalidValue;
}

template <int MODE>
int launch(int dtype, Args a, int units, int tile_rows, int ndir, int smem, void* stream) {
  if (a.R <= 0 || a.Tn <= 0 || a.H <= 0 || a.H % 8 || a.H > 768 || units <= 0 || a.H % units ||
      a.groups < 1 || a.groups > a.R)
    return cudaErrorInvalidValue;
  return with_instance<MODE>(dtype, units, tile_rows, [&](auto* ty, auto uu, auto mm) {
    using T = std::remove_pointer_t<decltype(ty)>;
    constexpr int U = decltype(uu)::value, TM = decltype(mm)::value;
    if (smem != smem_bytes<T, MODE>(U, TM, a.H)) return (int)cudaErrorInvalidValue;
    if (TM == 8 && a.H < 512) return (int)cudaErrorInvalidValue;   // the slices' sums fit the h tile
    auto kernel = lstm_scan_wide_kernel<T, MODE, U, TM>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {&a};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(ndir * a.groups * (a.H / U)), dim3(THREADS), args, smem,
                                    static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  });
}

template <int MODE>
int blocks_per_sm(int dtype, int units, int tile_rows, int smem, int* blocks) {
  return with_instance<MODE>(dtype, units, tile_rows, [&](auto* ty, auto uu, auto mm) {
    using T = std::remove_pointer_t<decltype(ty)>;
    auto kernel = lstm_scan_wide_kernel<T, MODE, decltype(uu)::value, decltype(mm)::value>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, smem);
  });
}

Args make_args(const void* xp, const void* w0, const void* w1, void* hs, void* c_state, int R,
               int Rt, int Tn, int H, int groups) {
  Args a{};
  a.xp = xp;
  a.w_hh[0] = w0;
  a.w_hh[1] = w1;
  a.hs = hs;
  a.c_state = static_cast<float*>(c_state);
  a.R = R;
  a.Rt = Rt;
  a.Tn = Tn;
  a.H = H;
  a.groups = groups;
  return a;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Every tensor contiguous and 16-byte aligned on
// the current device, H % 8 == 0, units dividing H; c_state a float32 (rows, H)
// scratch. The plan (units, tile rows, row groups a direction, directions a
// launch, smem bytes) is ops/lstm.py `scan_wide_plan`'s. Each entry returns the
// cudaError_t of its launch (0 on success; cudaErrorCooperativeLaunchTooLarge
// when the grid is not co-resident).

// x_proj (T, R, 4H), w_hh (H, 4H) -> hs, cs (T, R, H); lo a (2, R, H) scratch in
// the 16-bit types (unused in float32). dtype 2 (float16) takes this entry only.
extern "C" int lstm_fwd_hc_wide_launch(int dtype, const void* xp, const void* w_hh, void* hs,
                                       void* cs, void* lo, void* c_state, int R, int Tn, int H,
                                       int units, int tile_rows, int groups, int smem,
                                       void* stream) {
  Args a = make_args(xp, w_hh, w_hh, hs, c_state, R, R, Tn, H, groups);
  a.cs = cs;
  a.lo = lo;
  if ((dtype == 1 || dtype == 2) && !lo) return cudaErrorInvalidValue;
  return launch<kFwdHc>(dtype, a, units, tile_rows, 1, smem, stream);
}

// x_proj (T, R, 4H), w_hh (H, 4H) -> hs (T, R, H).
extern "C" int lstm_scan_wide_launch(int dtype, const void* xp, const void* w_hh, void* hs,
                                     void* c_state, int R, int Tn, int H, int units,
                                     int tile_rows, int groups, int smem, void* stream) {
  return launch<kScan>(dtype, make_args(xp, w_hh, w_hh, hs, c_state, R, R, Tn, H, groups), units,
                       tile_rows, 1, smem, stream);
}

// + h0 / c0 (R, H) -> hs and cs (T, R, H).
extern "C" int lstm_scan_stateful_wide_launch(int dtype, const void* xp, const void* w_hh,
                                              const void* h0, const void* c0, void* hs, void* cs,
                                              void* c_state, int R, int Tn, int H, int units,
                                              int tile_rows, int groups, int smem,
                                              void* stream) {
  Args a = make_args(xp, w_hh, w_hh, hs, c_state, R, R, Tn, H, groups);
  a.h0 = h0;
  a.c0 = c0;
  a.cs = cs;
  return launch<kStateful>(dtype, a, units, tile_rows, 1, smem, stream);
}

// x_proj (T, 2B, 4H), w_f / w_b the two halves of w_stack (each (H, 4H)) -> hs
// (T, 2B, H); c_state (2B, H). launch_dirs 2: both directions in one launch;
// 1: one launch a direction (their blocks are not co-resident).
extern "C" int lstm_scan_bidir_wide_launch(int dtype, const void* xp, const void* w_f,
                                           const void* w_b, void* hs, void* c_state, int B,
                                           int Tn, int H, int units, int tile_rows, int groups,
                                           int launch_dirs, int smem, void* stream) {
  Args a = make_args(xp, w_f, w_b, hs, c_state, B, 2 * B, Tn, H, groups);
  if (launch_dirs == 2) return launch<kScanBidir>(dtype, a, units, tile_rows, 2, smem, stream);
  if (launch_dirs != 1) return cudaErrorInvalidValue;
  for (a.dir0 = 0; a.dir0 < 2; ++a.dir0) {
    const int err = launch<kScanBidir>(dtype, a, units, tile_rows, 1, smem, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The two scans of lstm_scan_bidir2 in mode kScanBidir, each direction in its own
// tensors: xa / xb (T, R, 4H), wa / wb (H, 4H) -> ha / hb (T, R, H); c_state
// (2R, H); the plan as lstm_scan_bidir_wide_launch's at B = R.
extern "C" int lstm_scan_bidir2_wide_launch(int dtype, const void* xa, const void* xb,
                                            const void* wa, const void* wb, void* ha, void* hb,
                                            void* c_state, int R, int Tn, int H, int units,
                                            int tile_rows, int groups, int launch_dirs, int smem,
                                            void* stream) {
  Args a = make_args(xa, wa, wb, ha, c_state, R, R, Tn, H, groups);
  a.xp2 = xb;
  a.hs2 = hb;
  if (!xb || !hb) return cudaErrorInvalidValue;
  if (launch_dirs == 2) return launch<kScanBidir>(dtype, a, units, tile_rows, 2, smem, stream);
  if (launch_dirs != 1) return cudaErrorInvalidValue;
  for (a.dir0 = 0; a.dir0 < 2; ++a.dir0) {
    const int err = launch<kScanBidir>(dtype, a, units, tile_rows, 1, smem, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Blocks of the instance (dtype, mode 1-4 as `Mode`, units, tile rows) with smem
// bytes that an SM holds at once, into *blocks (the plan's co-residency).
extern "C" int lstm_scan_wide_blocks_per_sm(int dtype, int mode, int units, int tile_rows,
                                            int smem, int* blocks) {
  switch (mode) {
    case kScan: return blocks_per_sm<kScan>(dtype, units, tile_rows, smem, blocks);
    case kStateful: return blocks_per_sm<kStateful>(dtype, units, tile_rows, smem, blocks);
    case kScanBidir: return blocks_per_sm<kScanBidir>(dtype, units, tile_rows, smem, blocks);
    case kFwdHc: return blocks_per_sm<kFwdHc>(dtype, units, tile_rows, smem, blocks);
    default: return cudaErrorInvalidValue;
  }
}
