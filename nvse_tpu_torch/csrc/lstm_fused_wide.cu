// Fused-projection bidirectional LSTM for wide hidden sizes (128 < H), for
// Hopper (sm_90a).
//
// Replaces, at those sizes, the TPU kernel family of nvse_tpu/ops/pallas_lstm.py
// `lstm_scan_fused`: `_fused_kernel` (launched by `_pallas_lstm_fused`,
// pallas_lstm.py:815) and `_fused_kernel_unrolled` (launched by
// `_pallas_lstm_fused_unrolled`, pallas_lstm.py:727), one function at two TPU
// unroll factors. csrc/lstm_fused.cu (clusters of H / U blocks) takes H <= 128.
// At the same sizes it also holds the per-step ablation variants of the TPU
// harness `build` / `_variant_kernel` (scripts/profile_lstm_step.py:99 / :44):
// this kernel with a compile-time STEP (lstm_cell.cuh), launched for one
// direction, behind scripts/profile_torch_lstm_step.py.
//
// Contract: that of csrc/lstm_fused.cu. x (R, T, C) -> out (R, T, 2H), both
// directions in one launch, zero state, gates_t = x_t @ W_ih + b + h_{t-1} @ W_hh
// computed inside the kernel at each step and accumulated in float32 from the
// input-type values; the backward direction at its original time index; h
// rounded to the weight type as stored and read back rounded by the recurrent
// product (the `_hdot` rule, pallas_lstm.py:36-43); c carried in float32;
// float32 or bfloat16.
//
// What bounds it. BSRNN-L (C = H = 256) at a B = 8 x 1024 decode runs it at
// 272 rows x 1024 steps (the time BiLSTM) and 8192 x 34 (the band BiLSTM):
// each 584 GFLOP, operations, not bytes (8.7 ms at the float32 peak, 0.59 ms
// at the bfloat16 tensor-core peak). The time BiLSTM is besides a chain of
// 1024 dependent steps. W_ih and W_hh of one direction are 1 MB in float32:
// no block's shared memory holds them.
//
// Design. A block owns one (direction, row group, slice of U hidden units) and
// keeps the [W_ih; W_hh] column slice of its units' four gates in shared
// memory for the whole launch, in the input type, columns unit-major (column
// = 4 unit + gate). The caller's plan (ops/lstm.py `fused_wide_plan`) names
// the instance (U and the rows of a tile), the row groups (as many as are
// co-resident), the k-chunk of a stage and the stages of the ring; the
// wider the slice, the fewer blocks stage each row (H / U a step). At every
// step a block runs its group's rows as tiles; a tile's product runs over
// k-chunks of [x_t | h_{t-1}] staged by cp.async (.cg: through L2, which
// holds the h_{t-1} that other blocks wrote) into the ring, the next chunk in
// flight while one is multiplied, and the first chunks of the next step's x
// in flight across the grid barrier. Each chunk waits at a block barrier, so
// few large chunks beat many small ones (scripts/bench_torch_fused_plan.py
// times every plan). One cooperative grid
// barrier separates the steps, so a grid that cannot be co-resident is a
// launch error, never a hang.
// - bfloat16 (U = 32, 16 or 8; tiles of 64 rows, 128 at U = 8): the product
//   runs on the tensor cores, mma.sync m16n8k16 with float32 sums (each bf16
//   x bf16 product exact; only the order of the sums differs from the plain
//   version); 8 warps tile (rows x 4U columns), the row operand through
//   ldmatrix from its row-major stage, the weight operand through ldmatrix
//   from the [column][k] slice. A lane's C fragment holds two gates of one
//   (row, unit) for two rows; one shuffle with the neighbouring lane gathers
//   the four gates of one (row, unit) per lane.
// - float32 (true float32: no TF32; U = 16 in tiles of 256, 128 or 32 rows, or
//   U = 8 in tiles of 128): CUDA-core FMAs; a thread owns RM rows x UT units,
//   all four gates of each in registers, and per 4 k reads RM row float4 and
//   4 UT weight float4 for 16 RM UT FMAs: 8 rows x 2 units in the 256-row
//   tile (1 B an FMA, against 3 in the kernel it replaces), 1 unit in the
//   smaller tiles of 16 units, so that a small group's rows spread over the
//   threads. Rows past the tile's are skipped a warp at a time.
// The cell of (row, unit) runs where its four gates are, adds b, reads and
// writes its float32 c in a scratch that only that thread touches, and writes
// h rounded into the output.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// plain C entries (lstm_fused_wide_launch, lstm_step_variant_wide_launch,
// lstm_fused_wide_blocks_per_sm), loaded through ctypes.
#include <cooperative_groups.h>

#include <type_traits>

#include "lstm_cell.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace lstm;

constexpr int THREADS = 256;

// the plan's constants; ops/lstm.py `_FUSED_TILE` mirrors them. The k-chunk of
// a stage (KC) and the ring's stages come from the plan at run time.
constexpr int MAX_STAGES = 8;
template <typename T> struct Cfg;   // the pad of a staged row
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int PAD = 8;        // 16 bytes a staged row: ldmatrix rows in distinct banks
};
template <> struct Cfg<float> {
  static constexpr int PAD = 4;        // float4 reads of 8 consecutive rows in distinct banks
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// dynamic shared memory of the kernel at (U, C, H) with a ring of `stages`
// tiles of `rows` x kc: the weight slice, b, the ring
template <typename T>
constexpr long smem_bytes(int U, int rows, int C, int H, int kc, int stages) {
  using K = Cfg<T>;
  const long kw = round_up(C, kc) + round_up(H, kc);
  const long w = std::is_same<T, float>::value ? kw * 4 * U * 4 : 4L * U * (kw + 8) * 2;
  return w + 4L * U * 4 + (long)stages * rows * (kc + K::PAD) * sizeof(T);
}

struct Args {
  const void* x;          // (R, Tn, C)
  const void* w_ih[2];    // (C, 4H) of each direction
  const void* b[2];       // (4H) of each direction
  const void* w_hh[2];    // (H, 4H) of each direction
  void* out;              // (R, Tn, 2H)
  float* c_state;         // float32 (directions, R, H) scratch
  int R, Tn, C, H;
  int groups;             // row groups (the plan's)
  int kc;                 // k values a staged chunk (the plan's: 32 ... 256, a multiple of 32)
  int stages;             // stages of the ring (the plan's, 2 ... MAX_STAGES)
};

// acc[i][j][gate] += sum over 32 k of a_s[i * TY + ty][k] * w[k][(tx + j TX) * 4 + gate],
// for the first A of the thread's RM rows (A: the rows of the warp that are in
// the tile) and its UT units
template <int A, int RM, int UT, int TX, int TY, int NC>
__device__ __forceinline__ void fma32(float (&acc)[RM][UT][4], const float* a_s, int pitch,
                                      const float* w, int tx, int ty) {
#pragma unroll
  for (int k = 0; k < 32; k += 4) {
    float4 av[A];
#pragma unroll
    for (int i = 0; i < A; ++i)
      av[i] = *reinterpret_cast<const float4*>(a_s + (i * TY + ty) * pitch + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 wv[UT];
#pragma unroll
      for (int j = 0; j < UT; ++j)
        wv[j] = *reinterpret_cast<const float4*>(w + (k + e) * NC + (tx + j * TX) * 4);
#pragma unroll
      for (int i = 0; i < A; ++i) {
        const float v = e == 0 ? av[i].x : e == 1 ? av[i].y : e == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < UT; ++j) {
          acc[i][j][0] = fmaf(v, wv[j].x, acc[i][j][0]);
          acc[i][j][1] = fmaf(v, wv[j].y, acc[i][j][1]);
          acc[i][j][2] = fmaf(v, wv[j].z, acc[i][j][2]);
          acc[i][j][3] = fmaf(v, wv[j].w, acc[i][j][3]);
        }
      }
    }
  }
}

// fma32 over a chunk of kc k for the act (warp-uniform) rows of the thread
// that are in the tile
template <int RM, int UT, int TX, int TY, int NC>
__device__ __forceinline__ void fma_chunk(float (&acc)[RM][UT][4], const float* a_s, int pitch,
                                          const float* w, int kc, int act, int tx, int ty) {
  for (int k = 0; k < kc; k += 32) {
    const float* a = a_s + k;
    const float* wk = w + (size_t)k * NC;
    switch (act) {
      case 1: fma32<1, RM, UT, TX, TY, NC>(acc, a, pitch, wk, tx, ty); break;
      case 2: fma32<(RM > 2 ? 2 : RM), RM, UT, TX, TY, NC>(acc, a, pitch, wk, tx, ty); break;
      case 3: fma32<(RM > 3 ? 3 : RM), RM, UT, TX, TY, NC>(acc, a, pitch, wk, tx, ty); break;
      case 4: fma32<(RM > 4 ? 4 : RM), RM, UT, TX, TY, NC>(acc, a, pitch, wk, tx, ty); break;
      case 5: case 6: fma32<(RM > 6 ? 6 : RM), RM, UT, TX, TY, NC>(acc, a, pitch, wk, tx, ty); break;
      default: fma32<RM, RM, UT, TX, TY, NC>(acc, a, pitch, wk, tx, ty); break;
    }
  }
}

template <typename T, int U, int BMR, int STEP>
__global__ void __launch_bounds__(THREADS, 1) lstm_fused_wide_kernel(const Args a) {
  using K = Cfg<T>;
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  constexpr int NC = 4 * U;
  constexpr int E = 16 / sizeof(T);                // elements of a 16-byte copy
  const int S = a.stages, KC = a.kc, PITCH = KC + K::PAD;
  cg::grid_group grid = cg::this_grid();
  const int H = a.H, R = a.R, Tn = a.Tn, C = a.C, G = 4 * H;
  const int CP = round_up(C, KC), HP = round_up(H, KC), NXC = CP / KC, NHC = HP / KC;
  const int KP = CP + HP + 8;                      // bf16 slice row: [x | h | 16 unread bytes]
  const int ns = H / U;
  const int slice = blockIdx.x % ns, rest = blockIdx.x / ns;
  const int grp = rest % a.groups, dir = rest / a.groups;
  const int u0 = slice * U;
  const int gr0 = (int)((long)R * grp / a.groups);
  const int gr = (int)((long)R * (grp + 1) / a.groups) - gr0;
  const int n_tile = (gr + BMR - 1) / BMR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* xin = static_cast<const T*>(a.x);
  const T* w_ih = static_cast<const T*>(a.w_ih[dir]);
  const T* w_hh = static_cast<const T*>(a.w_hh[dir]);
  T* out = static_cast<T*>(a.out);                 // read back at the next step: no __restrict__
  float* cst = a.c_state + (size_t)dir * R * H;

  extern __shared__ float4 smem_f4[];
  T* w_s = reinterpret_cast<T*>(smem_f4);          // bf16 [NC][KP]; float32 [CP + HP][NC]
  const long w_elems = BF ? (long)NC * KP : (long)(CP + HP) * NC;
  float* b_s = reinterpret_cast<float*>(w_s + w_elems);
  T* ring = reinterpret_cast<T*>(b_s + NC);        // [S][BMR][PITCH]

  auto tile_of = [&](int p, int& row0, int& np) {  // the balanced row tiles of the group
    const int pr0 = (int)((long)gr * p / n_tile);
    np = (int)((long)gr * (p + 1) / n_tile) - pr0;
    row0 = gr0 + pr0;
  };
  auto step_time = [&](int n) { return dir ? Tn - 1 - n : n; };
  auto chunks = [&](int n) { return NXC + (n > 0 && STEP != kNoDot ? NHC : 0); };

  if (STEP == kEmpty) {                            // the zero state, written at every step
    for (int n = 0; n < Tn; ++n) {
      const int t = step_time(n);
      for (int i = tid; i < gr * U; i += THREADS) {
        const int row = gr0 + i / U, unit = u0 + i % U;
        out[((size_t)row * Tn + t) * 2 * H + (size_t)dir * H + unit] = from_f<T>(0.0f);
      }
      if (n + 1 < Tn) {
        __threadfence();
        grid.sync();
      }
    }
    return;
  }

  // the weight slice and b, once
  for (int i = tid; i < (CP + HP) * NC; i += THREADS) {
    const int k = i / NC, col = i - k * NC;
    const size_t src = (size_t)(col & 3) * H + u0 + (col >> 2);
    T v = from_f<T>(0.0f);
    if (k < C) v = w_ih[(size_t)k * G + src];
    else if (k >= CP && k < CP + H) v = w_hh[(size_t)(k - CP) * G + src];
    if (BF) w_s[(size_t)col * KP + k] = v;
    else w_s[i] = v;
  }
  if (tid < NC)
    b_s[tid] = to_f<T>(static_cast<const T*>(a.b[dir])[(size_t)(tid & 3) * H + u0 + (tid >> 2)]);

  // chunk i of step n (tile i / chunks, then x chunks before h chunks) into
  // stage i % S, as one cp.async group (empty past the step's chunks): 16-byte
  // copies, zero-filled past the tile's rows and the chunk's k; bfloat16 rows
  // of x that are not 16-byte aligned (C % 8 == 4) go through registers
  const bool x16 = (C * sizeof(T)) % 16 == 0;
  auto fetch = [&](int n, int i) {
    const int nch = chunks(n);
    if (i < n_tile * nch) {
      const int p = i / nch, c = i - p * nch;
      int row0, np;
      tile_of(p, row0, np);
      T* dst = ring + (size_t)(i % S) * BMR * PITCH;
      const T* src;
      size_t stride;
      int valid;
      if (c < NXC) {
        const int t_in = STEP == kNoInDma ? 0 : step_time(n);
        src = xin + ((size_t)row0 * Tn + t_in) * C + c * KC;
        stride = (size_t)Tn * C;
        valid = min(KC, C - c * KC);
      } else {
        const int tp = dir ? step_time(n) + 1 : step_time(n) - 1;
        src = out + ((size_t)row0 * Tn + tp) * 2 * H + (size_t)dir * H + (c - NXC) * KC;
        stride = (size_t)Tn * 2 * H;
        valid = min(KC, H - (c - NXC) * KC);
      }
      if (c < NXC && !x16) {
        for (int q = tid; q < BMR * (KC / 4); q += THREADS) {
          const int r = q / (KC / 4), kk = (q - r * (KC / 4)) * 4;
          uint2 v = make_uint2(0, 0);
          if (r < np && kk < valid) v = *reinterpret_cast<const uint2*>(src + r * stride + kk);
          *reinterpret_cast<uint2*>(dst + r * PITCH + kk) = v;
        }
      } else {
        for (int q = tid; q < BMR * (KC / E); q += THREADS) {
          const int r = q / (KC / E), kk = (q - r * (KC / E)) * E;
          const int nb = r < np ? max(0, min(E, valid - kk)) * (int)sizeof(T) : 0;
          cp_async16(dst + r * PITCH + kk, nb ? src + r * stride + kk : xin, nb);
        }
      }
    }
    cp_async_commit();
  };

  // bfloat16 warp tiling: WN warps over the 4U columns (32 each), WM over the rows
  constexpr int WN = BF ? U / 8 : 1, WM = 8 / WN, MT = BF ? BMR / (16 * WM) : 1;
  const int wm = warp / WN, wn = warp % WN;
  // float32 thread tiling: units tx + j TX (j < UT), rows i * TY + ty (i < RM);
  // one unit a thread where 16 units share a tile of at most 128 rows (a
  // small group's rows spread over more threads), else two
  constexpr int UT = !BF && U == 16 && BMR <= 128 ? 1 : 2;
  constexpr int TX = U / UT, TY = THREADS / TX, RM = BF ? 1 : BMR / TY;
  const int tx = tid % TX, ty = tid / TX, ty_w = (warp * 32) / TX;

  // the (row in the tile, unit in the slice) of the thread's pair (i, j):
  // bfloat16, the cell of m16n8 tile (i, j) that the lane gathers; float32,
  // row i * TY + ty and unit tx + j TX
  const int odd = lane & 1;
  auto pair_row = [&](int i) {
    return BF ? (wm * MT + i) * 16 + (lane >> 2) + odd * 8 : i * TY + ty;
  };
  auto pair_unit = [&](int j) { return BF ? wn * 8 + j * 2 + ((lane & 3) >> 1) : tx + j * TX; };
  constexpr int PI = BF ? MT : RM, PJ = BF ? 4 : UT;

  float acc[PI][PJ][4];
  // c_{t-1} of the thread's pairs in the tile, loaded with its first chunk
  float c_prev[PI][PJ];
  auto load_c = [&](int n, int row0, int np) {
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int lr = pair_row(i);
        c_prev[i][j] = n > 0 && lr < np ? cst[(size_t)(row0 + lr) * H + u0 + pair_unit(j)] : 0.0f;
      }
  };
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  };

  // the cell of (row, unit) from its four gate sums g and its c_{t-1}
  auto cell_out = [&](int n, int row, int ul, float (&g)[4], float c_prev) {
    const int unit = u0 + ul, t = step_time(n);
#pragma unroll
    for (int q = 0; q < 4; ++q) g[q] += b_s[ul * 4 + q];
    if (STEP == kNoDot) {                          // gates = tile(x_t, 4) * 0.25 + b (C == H)
      const float v = 0.25f * to_f<T>(xin[((size_t)row * Tn + t) * C + unit]);
#pragma unroll
      for (int q = 0; q < 4; ++q) g[q] = v + b_s[ul * 4 + q];
    }
    float c, h;
    if (STEP == kNoVpu) {
      // the g and o sums feed nothing here: the zero term keeps their FMAs,
      // which the compiler would drop, so that only the transcendentals go
      c = g[0] + 0.5f * c_prev;
      h = g[1] + 0.5f * c + 0.0f * (g[2] + g[3]);
    } else {
      c = sigmoid(g[1]) * c_prev + sigmoid(g[0]) * tanhf(g[2]);
      h = sigmoid(g[3]) * tanhf(c);
    }
    out[((size_t)row * Tn + t) * 2 * H + (size_t)dir * H + unit] = from_f<T>(h);
    cst[(size_t)row * H + unit] = c;
  };

  for (int s = 0; s < S - 1; ++s) fetch(0, s);
  for (int n = 0; n < Tn; ++n) {
    const int nch = chunks(n), total = n_tile * nch;
    zero();
    for (int i = 0; i < total; ++i) {
      cp_async_wait_dyn(S - 2);                    // chunk i has landed (this thread's copies)
      __syncthreads();                             // ... every thread's; stage i - 1 is free
      fetch(n, i + S - 1);
      const int p = i / nch, c = i - p * nch;
      int row0, np;
      tile_of(p, row0, np);
      if (c == 0) load_c(n, row0, np);
      const T* a_s = ring + (size_t)(i % S) * BMR * PITCH;
      const int kw0 = c < NXC ? c * KC : CP + (c - NXC) * KC;   // the chunk's rows of the slice
      if constexpr (STEP != kNoDot) {
        if constexpr (BF) {
          const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
          for (int ks = 0; ks < KC; ks += 16) {
            unsigned bfr[4][2];
#pragma unroll
            for (int np2 = 0; np2 < 2; ++np2) {    // (cols 0-7 | 8-15) x (k 0-7 | 8-15)
              unsigned tq[4];
              ldsm_x4(tq, w_s + (size_t)(wn * 32 + np2 * 16 + (mat >> 1) * 8 + r8) * KP + kw0 +
                              ks + (mat & 1) * 8);
              bfr[2 * np2][0] = tq[0];
              bfr[2 * np2][1] = tq[1];
              bfr[2 * np2 + 1][0] = tq[2];
              bfr[2 * np2 + 1][1] = tq[3];
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const int m0 = (wm * MT + mt) * 16;
              if (m0 >= np) continue;              // warp-uniform: no row of this tile
              unsigned af[4];
              ldsm_x4(af, a_s + (m0 + (lane & 15)) * PITCH + ks + (lane >> 4) * 8);
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af, bfr[nt][0], bfr[nt][1]);
            }
          }
        } else {
          const float* a_f = reinterpret_cast<const float*>(a_s);
          const float* w_f = reinterpret_cast<const float*>(w_s) + (size_t)kw0 * NC;
          const int act = max(0, min(RM, (np - ty_w + TY - 1) / TY));   // warp-uniform
          if constexpr (!BF)
            if (act > 0) fma_chunk<RM, UT, TX, TY, NC>(acc, a_f, PITCH, w_f, KC, act, tx, ty);
        }
      }
      if (c == nch - 1) {                          // the tile's cells
        if constexpr (BF) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int m0 = (wm * MT + mt) * 16;
            if (m0 >= np) continue;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              float* d = acc[mt][nt];
              // even lanes hold gates (i, f), odd ones (g, o), of rows r and r + 8
              const float r0 = __shfl_xor_sync(0xffffffffu, odd ? d[0] : d[2], 1);
              const float r1 = __shfl_xor_sync(0xffffffffu, odd ? d[1] : d[3], 1);
              float g[4];
              if (odd) { g[0] = r0; g[1] = r1; g[2] = d[2]; g[3] = d[3]; }
              else { g[0] = d[0]; g[1] = d[1]; g[2] = r0; g[3] = r1; }
              const int lr = pair_row(mt);
              if (lr < np) cell_out(n, row0 + lr, pair_unit(nt), g, c_prev[mt][nt]);
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const int lr = pair_row(i);
            if (lr >= np) continue;
#pragma unroll
            for (int j = 0; j < PJ; ++j) {
              float g[4] = {acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]};
              cell_out(n, row0 + lr, pair_unit(j), g, c_prev[i][j]);
            }
          }
        }
        zero();
      }
    }
    if (n + 1 < Tn) {
      __syncthreads();                             // every thread is done with the ring
      // the next step's leading x chunks need no h_t: in flight across the barrier
      const int nch1 = chunks(n + 1);
      int s = 0;
      for (; s < S - 1 && s % nch1 < NXC; ++s) fetch(n + 1, s);
      __threadfence();                             // h_t visible to every block before the barrier
      grid.sync();
      for (; s < S - 1; ++s) fetch(n + 1, s);
    }
  }
}

template <typename T, int U, int BMR, int STEP>
cudaError_t set_smem(int smem) {
  return cudaFuncSetAttribute(lstm_fused_wide_kernel<T, U, BMR, STEP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int U, int BMR, int STEP>
int blocks_per_sm(int C, int H, int kc, int stages, int* blocks) {
  const int smem = (int)smem_bytes<T>(U, BMR, C, H, kc, stages);
  cudaError_t e = set_smem<T, U, BMR, STEP>(smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, lstm_fused_wide_kernel<T, U, BMR, STEP>, THREADS, smem);
}

// Launches ndir directions (2: the BiLSTM; 1: the forward one, the step
// ablation, at the row groups of a two-direction launch) with the caller's
// plan: U units a block, a.groups row groups, a ring of a.stages chunks of
// a.kc k, smem bytes
// (checked against this build's). cudaErrorCooperativeLaunchTooLarge when the
// card cannot hold the grid at once.
template <typename T, int U, int BMR, int STEP>
int launch(const Args& a, int ndir, int smem, cudaStream_t stream) {
  if (a.H % U || a.groups < 1 || a.groups > a.R || a.stages < 2 || a.stages > MAX_STAGES ||
      a.kc < 32 || a.kc > 256 || a.kc % 32 || smem != smem_bytes<T>(U, BMR, a.C, a.H, a.kc, a.stages))
    return cudaErrorInvalidValue;
  int dev = 0, n_sm = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  if ((e = (cudaError_t)blocks_per_sm<T, U, BMR, STEP>(a.C, a.H, a.kc, a.stages, &per_sm)) != cudaSuccess)
    return e;
  const int blocks = a.groups * ndir * (a.H / U);
  if (blocks > per_sm * n_sm) return cudaErrorCooperativeLaunchTooLarge;
  Args args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lstm_fused_wide_kernel<T, U, BMR, STEP>),
                                  dim3(blocks), dim3(THREADS), params, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the instances (units, tile rows): bfloat16 (32, 64), (16, 64), (8, 128);
// float32 (16, 256), (16, 128), (16, 32), (8, 128)
template <typename F>
int with_instance(int dtype, int U, int rows, F&& f) {
  using bf = __nv_bfloat16;
  using std::integral_constant;
  if (dtype == 1) {
    if (U == 32 && rows == 64)
      return f((bf*)nullptr, integral_constant<int, 32>{}, integral_constant<int, 64>{});
    if (U == 16 && rows == 64)
      return f((bf*)nullptr, integral_constant<int, 16>{}, integral_constant<int, 64>{});
    if (U == 8 && rows == 128)
      return f((bf*)nullptr, integral_constant<int, 8>{}, integral_constant<int, 128>{});
  } else if (dtype == 0) {
    if (U == 16 && rows == 256)
      return f((float*)nullptr, integral_constant<int, 16>{}, integral_constant<int, 256>{});
    if (U == 16 && rows == 128)
      return f((float*)nullptr, integral_constant<int, 16>{}, integral_constant<int, 128>{});
    if (U == 16 && rows == 32)
      return f((float*)nullptr, integral_constant<int, 16>{}, integral_constant<int, 32>{});
    if (U == 8 && rows == 128)
      return f((float*)nullptr, integral_constant<int, 8>{}, integral_constant<int, 128>{});
  }
  return cudaErrorInvalidValue;
}

template <int STEP>
int launch_step(int dtype, const Args& a, int ndir, int U, int rows, int smem, void* stream) {
  return with_instance(dtype, U, rows, [&](auto* ty, auto u, auto m) {
    using T = std::remove_pointer_t<decltype(ty)>;
    return launch<T, decltype(u)::value, decltype(m)::value, STEP>(
        a, ndir, smem, static_cast<cudaStream_t>(stream));
  });
}

int launch_any(int dtype, int step, const Args& a, int ndir, int U, int rows, int smem,
               void* stream) {
  if (a.R <= 0 || a.Tn <= 0 || a.H <= 0 || a.H % 8 || a.C <= 0 || a.C % 4)
    return cudaErrorInvalidValue;
  switch (step) {
    case kFull: return launch_step<kFull>(dtype, a, ndir, U, rows, smem, stream);
    case kNoInDma: return launch_step<kNoInDma>(dtype, a, ndir, U, rows, smem, stream);
    case kNoDot:
      return a.C == a.H ? launch_step<kNoDot>(dtype, a, ndir, U, rows, smem, stream)
                        : cudaErrorInvalidValue;
    case kNoVpu: return launch_step<kNoVpu>(dtype, a, ndir, U, rows, smem, stream);
    case kEmpty: return launch_step<kEmpty>(dtype, a, ndir, U, rows, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x (R, T, C), w_ih (C, 4H), b (4H), w_hh (H, 4H),
// out (R, T, 2H), c_state float32 (2, R, H) scratch, all contiguous and
// 16-byte aligned on the current device; H % units == 0, C % 4 == 0. The plan
// (units, tile rows, groups, kc, stages, smem bytes) is ops/lstm.py
// `fused_wide_plan`'s. Returns the
// cudaError_t of the launch (0 on success; cudaErrorCooperativeLaunchTooLarge
// when the grid of whole row groups is not co-resident on this device).
extern "C" int lstm_fused_wide_launch(int dtype, const void* x, const void* w_ih_f,
                                      const void* w_ih_b, const void* b_f, const void* b_b,
                                      const void* w_hh_f, const void* w_hh_b, void* out,
                                      void* c_state, int R, int Tn, int C, int H, int units,
                                      int rows, int groups, int kc, int stages, int smem,
                                      void* stream) {
  Args a{};
  a.x = x;
  a.w_ih[0] = w_ih_f;
  a.w_ih[1] = w_ih_b;
  a.b[0] = b_f;
  a.b[1] = b_b;
  a.w_hh[0] = w_hh_f;
  a.w_hh[1] = w_hh_b;
  a.out = out;
  a.c_state = static_cast<float*>(c_state);
  a.R = R;
  a.Tn = Tn;
  a.C = C;
  a.H = H;
  a.groups = groups;
  a.kc = kc;
  a.stages = stages;
  return launch_any(dtype, lstm::kFull, a, 2, units, rows, smem, stream);
}

// The per-step ablation: one direction (the forward one) of the kernel above
// with step = lstm::Step (0 kFull, the production kernel, ... 4 kEmpty), at the
// plan of a two-direction launch. x (R, T, C), w_ih (C, 4H), b (4H),
// w_hh (H, 4H), out (R, T, 2H) (columns [0, H) written), c_state float32 (R, H)
// scratch, as lstm_fused_wide_launch; kNoDot needs C == H.
extern "C" int lstm_step_variant_wide_launch(int dtype, int step, const void* x,
                                             const void* w_ih, const void* b, const void* w_hh,
                                             void* out, void* c_state, int R, int Tn, int C,
                                             int H, int units, int rows, int groups,
                                             int kc, int stages, int smem, void* stream) {
  Args a{};
  a.x = x;
  a.w_ih[0] = a.w_ih[1] = w_ih;
  a.b[0] = a.b[1] = b;
  a.w_hh[0] = a.w_hh[1] = w_hh;
  a.out = out;
  a.c_state = static_cast<float*>(c_state);
  a.R = R;
  a.Tn = Tn;
  a.C = C;
  a.H = H;
  a.groups = groups;
  a.kc = kc;
  a.stages = stages;
  return launch_any(dtype, step, a, 1, units, rows, smem, stream);
}

// Blocks of the kernel (dtype, step, units, tile rows) at (C, H) with a ring of
// `stages` chunks of kc k
// that one SM holds at once (the plan's blocks_per_sm), into *blocks.
extern "C" int lstm_fused_wide_blocks_per_sm(int dtype, int step, int units, int rows, int C,
                                             int H, int kc, int stages, int* blocks) {
  auto f = [&](auto* ty, auto u, auto m) {
    using T = std::remove_pointer_t<decltype(ty)>;
    constexpr int UU = decltype(u)::value, MM = decltype(m)::value;
    switch (step) {
      case lstm::kFull: return blocks_per_sm<T, UU, MM, lstm::kFull>(C, H, kc, stages, blocks);
      case lstm::kNoInDma: return blocks_per_sm<T, UU, MM, lstm::kNoInDma>(C, H, kc, stages, blocks);
      case lstm::kNoDot: return blocks_per_sm<T, UU, MM, lstm::kNoDot>(C, H, kc, stages, blocks);
      case lstm::kNoVpu: return blocks_per_sm<T, UU, MM, lstm::kNoVpu>(C, H, kc, stages, blocks);
      case lstm::kEmpty: return blocks_per_sm<T, UU, MM, lstm::kEmpty>(C, H, kc, stages, blocks);
      default: return (int)cudaErrorInvalidValue;
    }
  };
  return with_instance(dtype, units, rows, f);
}
