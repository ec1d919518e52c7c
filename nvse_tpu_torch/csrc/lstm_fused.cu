// Fused-projection bidirectional LSTM for narrow hidden sizes (H <= 128), for
// Hopper (sm_90a).
//
// Replaces, at those sizes, the TPU kernel family of nvse_tpu/ops/pallas_lstm.py
// `lstm_scan_fused`: `_fused_kernel` (launched by `_pallas_lstm_fused`,
// pallas_lstm.py:815) and `_fused_kernel_unrolled` (launched by
// `_pallas_lstm_fused_unrolled`, pallas_lstm.py:727), one function at two TPU
// unroll factors. csrc/lstm_fused_wide.cu takes 128 < H. At the same sizes it
// also holds the per-step ablation variants of the TPU harness `build` /
// `_variant_kernel` (scripts/profile_lstm_step.py:99 / :44): this kernel with a
// compile-time STEP (lstm_cell.cuh), launched for one direction, behind
// scripts/profile_torch_lstm_step.py.
//
// Contract. For every row r and direction d (0 forward, 1 backward), zero state:
//   gates_t = x_t @ W_ih_d + b_d + h_{t-1} @ W_hh_d   (gate order i, f, g, o)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
// accumulated in float32 from the input-type values. x (R, T, C) -> out
// (R, T, 2H), both directions in one launch; the backward direction walks
// t = T-1 .. 0 and writes h at the original time index, into columns [H, 2H).
// h is rounded to the weight type as stored and read back rounded by the
// recurrent product (the `_hdot` rule, pallas_lstm.py:36-43); c is carried in
// float32. float32 or bfloat16; H % 8 == 0, C % 4 == 0. The nonlinearities are
// the hardware's approximations (`Act` below): tanh.approx.f32 in bfloat16
// (relative error about 2^-11; the sigmoid built from it is off by up to about
// 2.4e-4 where its value is small), __expf and __fdividef in float32 (about
// 1e-7). c takes their error at every step of the chain.
//
// What bounds it. At BSRNN-M's shapes (C = H = 128; R = 272 rows over T = 1024
// steps for the time BiLSTM, R = 8192 over T = 34 for the band BiLSTM) one call
// does 2 directions x R*T x 2*(C+H)*4H = 0.146 TFLOP on a few hundred MB: the
// work is operations (2.2 ms at the float32 peak, 0.15 ms at the bfloat16
// tensor-core peak), and the time BiLSTM is besides a chain of 1024 dependent
// steps, each a product of only 272 rows with the 128 x 512 W_hh.
//
// Design. A thread-block cluster of K blocks owns one (direction, row tile) at
// a time. Block `rank` of the cluster owns U hidden units, [rank U, rank U + U),
// and keeps the [W_ih; W_hh] columns of their four gates in shared memory for
// the whole launch, in the input type, columns unit-major (column = 4 unit +
// gate): K U >= H, U = 64 (bfloat16) or 32 (float32) at H = 128, so K = 2 or 4
// and 128 KB of weights a block. A cluster walks its tiles (j, j + ncl, ...)
// with the weights loaded once: the caller's plan (ops/lstm.py
// `fused_narrow_plan`) names U, the tile instance, the tiles, the clusters and
// the x ring.
// - No barrier a step: h travels by dataflow. A block computes the four gates
//   of its units for the tile's rows, runs the cell where the gates are, and
//   stores h rounded into the output, into its own h buffer, and into every
//   peer's (st.async into distributed shared memory), into one of two h
//   buffers by step parity. Each st.async completes its bytes on the peer's
//   mbarrier of that buffer, whose one arrival is the peer's own thread 0
//   announcing the bytes it expects; a block waits on that mbarrier before
//   its next recurrent product. Within a tile, a peer can store h_n into a
//   buffer only after it has read h_{n-1} from every block, and a block sends
//   h_{n-1} only after its own reads of the buffer that h_n then overwrites:
//   the two buffers need no other ordering. The first step of a tile reads
//   nothing from the peers, so that order does not reach across tiles: there
//   the cluster passes a barrier, each block arriving after its last
//   recurrent product of the tile before and waiting before its first store
//   of h into a peer (the next tile's x product runs in between). A thread's
//   release at a cluster barrier would wait for its stores to reach the
//   peers; st.async does not. Between the stores and the wait a block runs
//   the next step's input half of the product, x_{t+1} @ W_ih, which needs
//   no h: only the recurrent half, h_{t-1} @ W_hh, and the cell are on the
//   chain of dependent steps. One
//   block barrier a step orders the block's own h and the x ring (cp.async,
//   each step staged `stages` steps ahead); the last step of a tile sends
//   nothing, so no store is in flight when a block exits. The clusters are
//   independent: no grid barrier, and a grid of more clusters than the card
//   holds runs in waves.
// - bfloat16: the products run on the tensor cores, mma.sync m16n8k16 with
//   float32 sums (each bf16 x bf16 product exact; only the order of the sums
//   differs from the plain version); a warp owns 8 units (32 columns) and
//   INST m16 tiles of rows; the row operand [x_t | h_{t-1}] through ldmatrix
//   from rows padded by 16 bytes, the weight operand through ldmatrix from
//   the [column][k] slice. A lane's C fragment holds gates (i, f) or (g, o)
//   of one unit for two rows: one shuffle with the neighbouring lane gathers
//   the four gates of one (row, unit), whose c stays in that lane's registers.
// - float32 (true float32: no TF32): CUDA-core FMAs; thread tx owns unit tx
//   of the slice, all four gates, for INST rows (i * TY + ty), and per 4 k
//   reads INST row float4 (a broadcast: a warp shares its rows) and 4 weight
//   float4 for 16 INST FMAs. Rows past the tile are skipped a warp at a time.
// Units past H (K U > H) have zero weights and are not written.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// plain C entries (lstm_fused_launch, lstm_step_variant_launch,
// lstm_fused_max_clusters), loaded through ctypes.
#include <type_traits>

#include "lstm_cell.cuh"
#include "lstm_cluster.cuh"

namespace {

using namespace lstm;

constexpr int THREADS = 256;
constexpr int MAX_CLUSTER = 8;          // the portable cluster size
constexpr int MAX_STAGES = 4;

// the tile constants; ops/lstm.py `_NARROW` mirrors them. A tile of instance
// INST has ROWS * INST / U rows: bfloat16, 8 warps of 8 units over U and INST
// m16 tiles each over the rest; float32, U threads over the units and
// 256 / U over the rows, INST rows each.
template <typename T> struct Narrow;
template <> struct Narrow<__nv_bfloat16> {
  static constexpr int KT = 16;         // k of an mma: C and H padded to it
  static constexpr int PAD = 8;         // 16 bytes a staged row: ldmatrix rows in distinct banks
  static constexpr int ROWS = 1024;
};
template <> struct Narrow<float> {
  static constexpr int KT = 4;
  static constexpr int PAD = 4;         // float4 reads of neighbouring rows in distinct banks
  static constexpr int ROWS = 256;
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <typename T>
__host__ __device__ constexpr int tile_rows(int U, int inst) {
  return Narrow<T>::ROWS * inst / U;
}

// dynamic shared memory at (U, INST, C, H) with a ring of `stages` x steps:
// the weight slice, b, two h buffers, the x ring
template <typename T>
constexpr long smem_bytes(int U, int inst, int C, int H, int stages) {
  using N = Narrow<T>;
  const long CP = round_up(C, N::KT), HP = round_up(H, N::KT), BM = tile_rows<T>(U, inst);
  const long w = std::is_same<T, float>::value ? (CP + HP) * 4 * U * 4 : 4L * U * (CP + HP + 8) * 2;
  return w + 4L * U * 4 + (2 * BM * (HP + N::PAD) + stages * BM * (CP + N::PAD)) * (long)sizeof(T);
}

struct Args {
  const void* x;          // (R, Tn, C)
  const void* w_ih[2];    // (C, 4H) of each direction
  const void* b[2];       // (4H) of each direction
  const void* w_hh[2];    // (H, 4H) of each direction
  void* out;              // (R, Tn, 2H)
  int R, Tn, C, H;
  int U;                  // hidden units a block; a cluster of ceil(H / U) blocks
  int ntiles;             // row tiles of a direction (balanced: R * p / ntiles)
  int ncl;                // clusters of a direction; cluster j walks tiles j, j + ncl, ...
  int ndir;               // directions launched (2; 1 for the ablation: the forward one)
  int stages;             // x ring (2 ... MAX_STAGES)
};

// cp.async of 8 bytes (bfloat16 rows of x that are not 16-byte aligned:
// C % 8 == 4); bytes past src_bytes are zero-filled
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

// float32: acc[i][gate] += sum over nk k of a_s[(i TY + ty) pitch + k] *
// w[k NC + 4 tx + gate] for the first A of the thread's RM rows
template <int A, int RM>
__device__ __forceinline__ void fma_rows(float (&acc)[RM][4], const float* a_s, int pitch,
                                         const float* w, int NC, int nk, int tx, int ty, int TY) {
#pragma unroll 2
  for (int k = 0; k < nk; k += 4) {
    float4 av[A];
#pragma unroll
    for (int i = 0; i < A; ++i)
      av[i] = *reinterpret_cast<const float4*>(a_s + (i * TY + ty) * pitch + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 wv = *reinterpret_cast<const float4*>(w + (size_t)(k + e) * NC + tx * 4);
#pragma unroll
      for (int i = 0; i < A; ++i) {
        const float v = e == 0 ? av[i].x : e == 1 ? av[i].y : e == 2 ? av[i].z : av[i].w;
        acc[i][0] = fmaf(v, wv.x, acc[i][0]);
        acc[i][1] = fmaf(v, wv.y, acc[i][1]);
        acc[i][2] = fmaf(v, wv.z, acc[i][2]);
        acc[i][3] = fmaf(v, wv.w, acc[i][3]);
      }
    }
  }
}

template <int RM>
__device__ __forceinline__ void fma_part(float (&acc)[RM][4], const float* a_s, int pitch,
                                         const float* w, int NC, int nk, int act, int tx, int ty,
                                         int TY) {
  switch (act) {
    case 0: break;
    case 1: fma_rows<1, RM>(acc, a_s, pitch, w, NC, nk, tx, ty, TY); break;
    case 2: fma_rows<(RM > 2 ? 2 : RM), RM>(acc, a_s, pitch, w, NC, nk, tx, ty, TY); break;
    case 3: fma_rows<(RM > 3 ? 3 : RM), RM>(acc, a_s, pitch, w, NC, nk, tx, ty, TY); break;
    default: fma_rows<RM, RM>(acc, a_s, pitch, w, NC, nk, tx, ty, TY); break;
  }
}

// The cell's nonlinearities. bfloat16: the hardware tanh (tanh.approx.f32,
// relative error below 2^-10.9, under the 2^-8 of h's rounding to bfloat16),
// sigmoid(x) = (1 + tanh(x / 2)) / 2. float32: e^x through ex2.approx and an
// approximate reciprocal (errors near 1e-7 each, against the limit of 1e-4),
// sigmoid(x) = 1 / (1 + e^-x), tanh(x) = 2 sigmoid(2x) - 1. Both saturate to
// the right limits for large |x|.
template <typename T> struct Act;
template <> struct Act<__nv_bfloat16> {
  static __device__ __forceinline__ float tanh(float x) {
    float y;
    asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
  }
  static __device__ __forceinline__ float sig(float x) { return fmaf(0.5f, tanh(0.5f * x), 0.5f); }
};
template <> struct Act<float> {
  static __device__ __forceinline__ float sig(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }
  static __device__ __forceinline__ float tanh(float x) { return fmaf(2.0f, sig(2.0f * x), -1.0f); }
};

template <typename T, int INST, int STEP>
__global__ void __launch_bounds__(THREADS, 1) lstm_fused_kernel(const Args a) {
  using N = Narrow<T>;
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  constexpr int E = 16 / sizeof(T);                // elements of a 16-byte copy
  const int U = a.U, NC = 4 * U, H = a.H, C = a.C, Tn = a.Tn, R = a.R, G = 4 * H;
  const int CP = round_up(C, N::KT), HP = round_up(H, N::KT);
  const int BM = tile_rows<T>(U, INST);
  const int XP = CP + N::PAD, HPP = HP + N::PAD;   // pitches of a staged x row and an h row
  const int KP = CP + HP + 8;                      // bf16 slice row: [x | h | 16 unread bytes]
  const int S = a.stages;
  const unsigned K = cluster_size(), rank = cluster_rank();
  const int cl = blockIdx.x / K;
  const int dir = cl % a.ndir, j = cl / a.ndir;
  const int u0 = rank * U;
  const int nmine = j < a.ntiles ? (a.ntiles - j + a.ncl - 1) / a.ncl : 0;   // tiles of this cluster
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* xin = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  // rows [row0, row0 + np) of the cluster's tile kt (the balanced tiles of R)
  auto bounds = [&](int kt, int& row0, int& np) {
    const long long p = j + (long long)kt * a.ncl;
    row0 = (int)(R * p / a.ntiles);
    np = (int)(R * (p + 1) / a.ntiles) - row0;
  };
  auto step_time = [&](int n) { return dir ? Tn - 1 - n : n; };

  extern __shared__ float4 smem_f4[];
  T* w_s = reinterpret_cast<T*>(smem_f4);          // bf16 [NC][KP]; float32 [CP + HP][NC]
  const int w_elems = BF ? NC * KP : (CP + HP) * NC;
  float* b_s = reinterpret_cast<float*>(w_s + w_elems);
  T* h_s = reinterpret_cast<T*>(b_s + NC);         // [2][BM][HPP]
  T* x_s = h_s + 2 * BM * HPP;                     // [S][BM][XP]

  // zeros in the weight slice and the h buffers (the pads of k, the units past
  // H and the rows past a tile are read, times zero), then the slice and b
  {
    const int n16 = (int)(((long)w_elems * sizeof(T)) / 16);
    for (int i = tid; i < n16; i += THREADS) smem_f4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    float4* hz = reinterpret_cast<float4*>(h_s);
    for (int i = tid; i < (int)((2L * BM * HPP * sizeof(T)) / 16); i += THREADS)
      hz[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the two h buffers' mbarriers (by step parity), before any peer can store
  __shared__ alignas(8) unsigned long long h_bar[2];
  if (tid == 0) {
    mbar_init(&h_bar[0]);
    mbar_init(&h_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (STEP != kEmpty) {                            // kEmpty reads no weights
    const T* w_ih = static_cast<const T*>(a.w_ih[dir]);
    const T* w_hh = static_cast<const T*>(a.w_hh[dir]);
    const int per_gate = U / E, per_row = 4 * per_gate, total = (C + H) * per_row;
    constexpr int LOADS = 4;                       // 16-byte loads in flight a thread
    for (int i0 = tid; i0 < total; i0 += LOADS * THREADS) {
      uint4 v[LOADS];
      int dst[LOADS], step[LOADS];                 // first element and stride in w_s
#pragma unroll
      for (int l = 0; l < LOADS; ++l) {
        const int i = i0 + l * THREADS, kk = i / per_row, q = i - kk * per_row;
        const int g = q / per_gate, ul = (q - g * per_gate) * E;
        const bool hh = kk >= C;
        const int k = hh ? kk - C : kk, krow = hh ? CP + k : k;
        dst[l] = -1;
        if (i >= total || u0 + ul >= H) continue;  // units past H: zeros
        v[l] = *reinterpret_cast<const uint4*>((hh ? w_hh : w_ih) + (size_t)k * G +
                                               (size_t)g * H + u0 + ul);
        dst[l] = BF ? (4 * ul + g) * KP + krow : krow * NC + 4 * ul + g;
        step[l] = BF ? 4 * KP : 4;
      }
#pragma unroll
      for (int l = 0; l < LOADS; ++l) {
        if (dst[l] < 0) continue;
        const unsigned w4[4] = {v[l].x, v[l].y, v[l].z, v[l].w};
#pragma unroll
        for (int e = 0; e < E; ++e) {
          T val;
          if constexpr (BF) val = __ushort_as_bfloat16((unsigned short)(w4[e / 2] >> (16 * (e & 1))));
          else val = __uint_as_float(w4[e]);
          w_s[dst[l] + e * step[l]] = val;
        }
      }
    }
    const T* bias = static_cast<const T*>(a.b[dir]);
    for (int col = tid; col < NC; col += THREADS) {
      const int unit = u0 + (col >> 2);
      b_s[col] = unit < H ? to_f<T>(bias[(size_t)(col & 3) * H + unit]) : 0.0f;
    }
  }

  // The x ring. fetch() stages the next item (tile f_kt of the cluster, step
  // f_n) into the next stage as one cp.async group (empty past the last
  // item): 16-byte copies, 8-byte ones for bfloat16 rows that are not 16-byte
  // aligned, zero-filled past the tile's rows and C. No division in the loop:
  // thread tid's first piece (row, k) steps by THREADS pieces.
  const bool x16 = (C * (int)sizeof(T)) % 16 == 0;
  const int xe = x16 ? E : 8 / (int)sizeof(T), per = CP / xe;   // elements a copy, copies a row
  const int q_r0 = tid / per, q_k0 = (tid - q_r0 * per) * xe;
  const int dq_r = THREADS / per, dq_k = (THREADS - dq_r * per) * xe;
  int f_kt = 0, f_n = 0, f_stage = 0, f_row0 = 0, f_np = 0;
  if (nmine > 0) bounds(0, f_row0, f_np);
  auto fetch = [&]() {
    if (f_kt < nmine) {
      const int t = STEP == kNoInDma ? 0 : step_time(f_n);
      T* dst = x_s + (size_t)f_stage * BM * XP;
      const T* src = xin + ((size_t)f_row0 * Tn + t) * C;
      const size_t stride = (size_t)Tn * C;
      for (int r = q_r0, kk = q_k0; r < BM;) {
        const int nb = r < f_np ? max(0, min(xe, C - kk)) * (int)sizeof(T) : 0;
        const T* s = nb ? src + r * stride + kk : xin;
        if (x16) cp_async16(dst + r * XP + kk, s, nb);
        else cp_async8(dst + r * XP + kk, s, nb);
        r += dq_r;
        kk += dq_k;
        if (kk >= CP) { kk -= CP; ++r; }
      }
      if (++f_n == Tn) {
        f_n = 0;
        if (++f_kt < nmine) bounds(f_kt, f_row0, f_np);
      }
    }
    if (++f_stage == S) f_stage = 0;
    cp_async_commit();
  };

  // the thread's part of a tile. bfloat16: warp (wm, wn) owns units wn * 8 ...
  // + 8 (32 columns) and m16 tiles wm * INST ... + INST; float32: thread (tx, ty)
  // owns unit tx and rows i * TY + ty
  const int WN = BF ? U / 8 : 1;
  const int wm = warp / WN, wn = warp % WN;
  const int TY = THREADS / U, tx = tid % U, ty = tid / U;
  constexpr int PJ = BF ? 4 : 1;                   // units of a thread's pairs per row
  float acc[INST][PJ][4];
  float c_reg[INST][PJ];
  T h_reg[INST][PJ];                               // h_n, stored to `out` after the arrive
  const int odd = lane & 1;
  auto pair_row = [&](int i) {
    return BF ? (wm * INST + i) * 16 + (lane >> 2) + odd * 8 : i * TY + ty;
  };
  auto pair_unit = [&](int jj) { return BF ? wn * 8 + jj * 2 + ((lane & 3) >> 1) : tx; };
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < INST; ++i)
#pragma unroll
      for (int jj = 0; jj < PJ; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][jj][q] = 0.0f;
  };

  // acc += a rows (k in [0, nk), pitch `pitch`) x the slice's rows [kw0, kw0 + nk)
  auto product = [&](const T* a_s, int pitch, int kw0, int nk, int np) {
    if constexpr (BF) {
      const int mat = lane >> 3, r8 = lane & 7;
      const T* wrow = w_s + (size_t)(wn * 32 + (mat >> 1) * 8 + r8) * KP + kw0 + (mat & 1) * 8;
      const T* arow = a_s + (lane & 15) * pitch + (lane >> 4) * 8;
#pragma unroll 4
      for (int ks = 0; ks < nk; ks += 16) {
        unsigned bfr[4][2];
#pragma unroll
        for (int np2 = 0; np2 < 2; ++np2) {        // (cols 0-7 | 8-15) x (k 0-7 | 8-15)
          unsigned tq[4];
          ldsm_x4(tq, wrow + (size_t)np2 * 16 * KP + ks);
          bfr[2 * np2][0] = tq[0];
          bfr[2 * np2][1] = tq[1];
          bfr[2 * np2 + 1][0] = tq[2];
          bfr[2 * np2 + 1][1] = tq[3];
        }
#pragma unroll
        for (int mt = 0; mt < INST; ++mt) {
          const int m0 = (wm * INST + mt) * 16;
          if (m0 >= np) continue;                  // warp-uniform: no row of this tile
          unsigned af[4];
          ldsm_x4(af, arow + m0 * pitch + ks);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af, bfr[nt][0], bfr[nt][1]);
        }
      }
    } else {
      float(&acc2)[INST][4] = reinterpret_cast<float(&)[INST][4]>(acc);
      const int act = max(0, min(INST, (np - ty + TY - 1) / TY));
      fma_part<INST>(acc2, reinterpret_cast<const float*>(a_s), pitch,
                     reinterpret_cast<const float*>(w_s) + (size_t)kw0 * NC, NC, nk, act, tx, ty,
                     TY);
    }
  };

  if (STEP != kEmpty)
    for (int s = 0; s < S; ++s) fetch();
  cluster_arrive();                                // every block of the cluster has started
  cluster_wait();                                  // and set up its barriers
  zero();
#pragma unroll
  for (int i = 0; i < INST; ++i)
#pragma unroll
    for (int jj = 0; jj < PJ; ++jj) c_reg[i][jj] = 0.0f;
  if (nmine > 0 && STEP != kEmpty) {
    cp_async_wait_dyn(S - 1);                      // item 0's x (this thread's copies)
    __syncthreads();                               // ... every thread's
    if (STEP != kNoDot) {
      int row0, np;
      bounds(0, row0, np);
      product(x_s, XP, 0, CP, np);
    }
  }

  unsigned parity[2] = {0u, 0u};                   // of each h buffer's next phase
  int m = 0, stage = 0;                            // item (tile kt, step n) and its x stage
  for (int kt = 0; kt < nmine; ++kt) {
    int row0, np, np_next = 0, row_next;
    bounds(kt, row0, np);
    if (kt + 1 < nmine) bounds(kt + 1, row_next, np_next);
    for (int n = 0; n < Tn; ++n, ++m) {
      const int t = step_time(n);
      const T* hb = h_s + (size_t)(m & 1) * BM * HPP;            // h_{n-1}
      T* hw = h_s + (size_t)((m + 1) & 1) * BM * HPP;            // where h_n goes
      if (n > 0) {                                 // h_{n-1} of every block has landed
        mbar_wait(&h_bar[m & 1], parity[m & 1]);
        parity[m & 1] ^= 1u;
      } else if (kt > 0) {                         // every block is done with the last tile's h
        cluster_wait();
      }
      const bool send = n + 1 < Tn;                // h_n is read at step n + 1
      if (send && tid == 0)                        // the bytes of h_n the peers store here
        mbar_expect(&h_bar[(m + 1) & 1], (unsigned)(np * (H - min(U, H - u0)) * (int)sizeof(T)));
      if (n > 0 && STEP != kNoDot && STEP != kEmpty) product(hb, HPP, CP, HP, np);
      if (n + 1 == Tn && kt + 1 < nmine) cluster_arrive();   // this tile's h buffers read
      const T* xb = x_s + (size_t)stage * BM * XP;

      // the cell of (row, unit) from its four gate sums; h into h_state and,
      // where step n + 1 reads it, into this block's h buffer and (st.async)
      // every peer's
      auto cell_out = [&](int lr, int ul, float (&g)[4], float& c_state, T& h_state) {
        const int unit = u0 + ul;
#pragma unroll
        for (int q = 0; q < 4; ++q) g[q] += b_s[ul * 4 + q];
        if (STEP == kNoDot) {                      // gates = tile(x_t, 4) * 0.25 + b (C == H)
          const float v = 0.25f * to_f<T>(xb[lr * XP + (unit < C ? unit : 0)]);
#pragma unroll
          for (int q = 0; q < 4; ++q) g[q] = v + b_s[ul * 4 + q];
        }
        const float c_prev = n > 0 ? c_state : 0.0f;
        float c, h;
        if (STEP == kEmpty) {                      // the zero state
          c = h = 0.0f;
        } else if (STEP == kNoVpu) {
          // the g and o sums feed nothing here: the zero term keeps their
          // products, which the compiler would drop, so that only the
          // transcendentals go
          c = g[0] + 0.5f * c_prev;
          h = g[1] + 0.5f * c + 0.0f * (g[2] + g[3]);
        } else {
          c = Act<T>::sig(g[1]) * c_prev + Act<T>::sig(g[0]) * Act<T>::tanh(g[2]);
          h = Act<T>::sig(g[3]) * Act<T>::tanh(c);
        }
        c_state = c;
        h_state = from_f<T>(h);
        T* dst = hw + lr * HPP + unit;
        if (send && lr < np && unit < H) *dst = h_state;
        // bfloat16: lanes l and l ^ 2 hold units u and u + 1 of one row; the
        // one with u sends both, as st.async moves 4 bytes at least
        unsigned word = bits(h_state);
        if (BF) word |= __shfl_xor_sync(0xffffffffu, word, 2) << 16;
        if (send && lr < np && unit < H && (!BF || (lane & 2) == 0)) {
          const unsigned at = smem_u32(dst), bar = smem_u32(&h_bar[(m + 1) & 1]);
          for (unsigned r = 0; r < K; ++r)
            if (r != rank) st_async(cluster_map(at, r), word, cluster_map(bar, r));
        }
      };

      if constexpr (BF) {
#pragma unroll
        for (int mt = 0; mt < INST; ++mt) {
          const int m0 = (wm * INST + mt) * 16;
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
            cell_out(pair_row(mt), pair_unit(nt), g, c_reg[mt][nt], h_reg[mt][nt]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < INST; ++i) {
          const int lr = pair_row(i);
          if (lr >= np) continue;
          float g[4] = {acc[i][0][0], acc[i][0][1], acc[i][0][2], acc[i][0][3]};
          cell_out(lr, pair_unit(0), g, c_reg[i][0], h_reg[i][0]);
        }
      }
      // h_n into the output
#pragma unroll
      for (int i = 0; i < INST; ++i)
#pragma unroll
        for (int jj = 0; jj < PJ; ++jj) {
          const int lr = pair_row(i), unit = u0 + pair_unit(jj);
          if (lr < np && unit < H)
            out[((size_t)(row0 + lr) * Tn + t) * 2 * H + (size_t)dir * H + unit] = h_reg[i][jj];
        }
      if (++stage == S) stage = 0;
      if (n + 1 < Tn || kt + 1 < nmine) {
        // every thread's h_n stores into this block's buffer before step n + 1
        // reads them, and every thread done with the x stage just used
        if (STEP != kEmpty) cp_async_wait_dyn(S - 2);   // the next item's x (this thread's copies)
        __syncthreads();
        if (STEP != kEmpty) {
          fetch();
          zero();
          if (STEP != kNoDot)                      // x_{t+1} @ W_ih, while h_n travels
            product(x_s + (size_t)stage * BM * XP, XP, 0, CP, n + 1 < Tn ? np : np_next);
        }
      }
    }
  }
}

template <typename T, int INST, int STEP>
cudaError_t configure(int K, int smem, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(lstm_fused_kernel<T, INST, STEP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// clusters of K blocks of the instance that the card holds at once
template <typename T, int INST, int STEP>
int max_clusters(int K, int smem, int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<T, INST, STEP>(K, smem, cfg, attr);
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3(K);
  return cudaOccupancyMaxActiveClusters(clusters, lstm_fused_kernel<T, INST, STEP>, &cfg);
}

bool valid_units(int dtype, int U) {
  return U == 8 || U == 16 || U == 32 || (U == 64 && dtype == 1);
}

// Launches a.ndir directions with the caller's plan; cudaErrorLaunchOutOfResources
// when not even one cluster fits on this device.
template <typename T, int INST, int STEP>
int launch(const Args& a, int smem, cudaStream_t stream) {
  const int K = (a.H + a.U - 1) / a.U, BM = tile_rows<T>(a.U, INST);
  if (K > MAX_CLUSTER || a.ntiles < 1 || a.ntiles > a.R || a.ncl < 1 || a.ncl > a.ntiles ||
      (a.R + a.ntiles - 1) / a.ntiles > BM || a.stages < 2 || a.stages > MAX_STAGES ||
      smem != smem_bytes<T>(a.U, INST, a.C, a.H, a.stages))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<T, INST, STEP>(K, smem, cfg, attr);
  if (e != cudaSuccess) return e;
  int fit = 0;
  cfg.gridDim = dim3(K);
  if ((e = cudaOccupancyMaxActiveClusters(&fit, lstm_fused_kernel<T, INST, STEP>, &cfg)) !=
      cudaSuccess)
    return e;
  if (fit < 1) return cudaErrorLaunchOutOfResources;
  cfg.gridDim = dim3(K * a.ncl * a.ndir);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, lstm_fused_kernel<T, INST, STEP>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the instances: INST 1, 2 or 4 (m16 tiles of a warp in bfloat16, rows of a
// thread in float32), each dtype
template <typename F>
int with_instance(int dtype, int inst, F&& f) {
  using bf = __nv_bfloat16;
  using std::integral_constant;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (inst) {
    case 1:
      return dtype ? f((bf*)nullptr, integral_constant<int, 1>{})
                   : f((float*)nullptr, integral_constant<int, 1>{});
    case 2:
      return dtype ? f((bf*)nullptr, integral_constant<int, 2>{})
                   : f((float*)nullptr, integral_constant<int, 2>{});
    case 4:
      return dtype ? f((bf*)nullptr, integral_constant<int, 4>{})
                   : f((float*)nullptr, integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

template <int STEP>
int launch_step(int dtype, int inst, const Args& a, int smem, void* stream) {
  return with_instance(dtype, inst, [&](auto* ty, auto in) {
    using T = std::remove_pointer_t<decltype(ty)>;
    return launch<T, decltype(in)::value, STEP>(a, smem, static_cast<cudaStream_t>(stream));
  });
}

int launch_any(int dtype, int step, int inst, const Args& a, int smem, void* stream) {
  if (a.R <= 0 || a.Tn <= 0 || a.H <= 0 || a.H % 8 || a.H > 128 || a.C <= 0 || a.C % 4 ||
      !valid_units(dtype, a.U))
    return cudaErrorInvalidValue;
  switch (step) {
    case kFull: return launch_step<kFull>(dtype, inst, a, smem, stream);
    case kNoInDma: return launch_step<kNoInDma>(dtype, inst, a, smem, stream);
    case kNoDot:
      return a.C == a.H ? launch_step<kNoDot>(dtype, inst, a, smem, stream) : cudaErrorInvalidValue;
    case kNoVpu: return launch_step<kNoVpu>(dtype, inst, a, smem, stream);
    case kEmpty: return launch_step<kEmpty>(dtype, inst, a, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* x, const void* w_ih_f, const void* w_ih_b, const void* b_f,
               const void* b_b, const void* w_hh_f, const void* w_hh_b, void* out, int R,
               int Tn, int C, int H, int units, int ntiles, int ncl, int ndir, int stages) {
  Args a{};
  a.x = x;
  a.w_ih[0] = w_ih_f;
  a.w_ih[1] = w_ih_b;
  a.b[0] = b_f;
  a.b[1] = b_b;
  a.w_hh[0] = w_hh_f;
  a.w_hh[1] = w_hh_b;
  a.out = out;
  a.R = R;
  a.Tn = Tn;
  a.C = C;
  a.H = H;
  a.U = units;
  a.ntiles = ntiles;
  a.ncl = ncl;
  a.ndir = ndir;
  a.stages = stages;
  return a;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x (R, T, C), w_ih (C, 4H), b (4H), w_hh (H, 4H),
// out (R, T, 2H), all contiguous and 16-byte aligned on the current device;
// H <= 128, H % 8 == 0, C % 4 == 0. The plan (units a block, instance, row
// tiles, clusters a direction, x stages, smem bytes) is ops/lstm.py
// `fused_narrow_plan`'s. Returns the cudaError_t of the launch (0 on success).
extern "C" int lstm_fused_launch(int dtype, const void* x, const void* w_ih_f,
                                 const void* w_ih_b, const void* b_f, const void* b_b,
                                 const void* w_hh_f, const void* w_hh_b, void* out, int R,
                                 int Tn, int C, int H, int units, int inst, int ntiles, int ncl,
                                 int stages, int smem, void* stream) {
  const Args a = make_args(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b, out, R, Tn, C, H, units,
                           ntiles, ncl, 2, stages);
  return launch_any(dtype, lstm::kFull, inst, a, smem, stream);
}

// The per-step ablation: one direction (the forward one) of the kernel above
// with step = lstm::Step (0 kFull, the production kernel, ... 4 kEmpty), at the
// plan of a two-direction launch. x (R, T, C), w_ih (C, 4H), b (4H),
// w_hh (H, 4H), out (R, T, 2H) (columns [0, H) written); kNoDot needs C == H.
extern "C" int lstm_step_variant_launch(int dtype, int step, const void* x, const void* w_ih,
                                        const void* b, const void* w_hh, void* out, int R,
                                        int Tn, int C, int H, int units, int inst, int ntiles,
                                        int ncl, int stages, int smem, void* stream) {
  const Args a = make_args(x, w_ih, w_ih, b, b, w_hh, w_hh, out, R, Tn, C, H, units, ntiles, ncl,
                           1, stages);
  return launch_any(dtype, step, inst, a, smem, stream);
}

// Clusters of ceil(H / units) blocks of the kernel (dtype, step, units,
// instance) with smem bytes that the card holds at once, into *clusters (the
// plan's co-residency).
extern "C" int lstm_fused_max_clusters(int dtype, int step, int units, int inst, int H,
                                       int smem, int* clusters) {
  if (H <= 0 || H > 128 || !valid_units(dtype, units)) return cudaErrorInvalidValue;
  const int K = (H + units - 1) / units;
  if (K > MAX_CLUSTER) return cudaErrorInvalidValue;
  return with_instance(dtype, inst, [&](auto* ty, auto in) {
    using T = std::remove_pointer_t<decltype(ty)>;
    constexpr int I = decltype(in)::value;
    switch (step) {
      case lstm::kFull: return max_clusters<T, I, lstm::kFull>(K, smem, clusters);
      case lstm::kNoInDma: return max_clusters<T, I, lstm::kNoInDma>(K, smem, clusters);
      case lstm::kNoDot: return max_clusters<T, I, lstm::kNoDot>(K, smem, clusters);
      case lstm::kNoVpu: return max_clusters<T, I, lstm::kNoVpu>(K, smem, clusters);
      case lstm::kEmpty: return max_clusters<T, I, lstm::kEmpty>(K, smem, clusters);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}
