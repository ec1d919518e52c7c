// Unidirectional LSTM scans over a projected input for narrow hidden sizes
// (H <= 128), for Hopper (sm_90a): the inference scans and the residual-saving
// forward of the training route, one kernel template with three modes.
//
// Replaces the TPU kernels at those sizes:
//   kScan     <- `_lstm_kernel` / `_lstm_kernel_unrolled` of nvse_tpu/ops/pallas_lstm.py
//                (launched by `_pallas_lstm_scan`, pallas_lstm.py:212)
//   kStateful <- `_lstm_kernel_stateful`
//                (launched by `_pallas_lstm_scan_stateful`, pallas_lstm.py:297)
//   kScan with two directions <- `_make_bidir_kernel`, the two-direction scan
//                (launched by `_pallas_lstm_scan_bidir`, pallas_lstm.py:427), and
//                with a pointer for each direction `_dualdot_kernel` (launched by
//                `_pallas_lstm_scan_bidir2`, pallas_lstm.py:499) at H <= 128
//   kFwdHc    <- `_fwd_kernel_hc` / `_fwd_kernel_hc_unrolled` of
//                nvse_tpu/ops/pallas_lstm_bwd.py (launched by `lstm_fwd_hc`,
//                pallas_lstm_bwd.py:181)
// The unrolled TPU variants are the same functions at other unroll factors.
// csrc/lstm_scan_wide.cu takes 128 < H.
//
// Contract (time-major, gate order i, f, g, o):
//   gates_t = x_proj[t] + h_{t-1} @ W_hh
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g);  h_t = sigmoid(o) * tanh(c_t)
//   lstm_scan:          h_{-1} = c_{-1} = 0                  -> hs (T, R, H)
//   lstm_scan_stateful: h_{-1} = h0, c_{-1} = c0, each (R, H) -> hs, cs (T, R, H)
//   lstm_scan_bidir:    x_proj (T, 2B, 4H), w_stack (2H, 4H), zero state -> hs (T, 2B, H);
//                       rows [0, B) scan with w_stack[:H], rows [B, 2B) with w_stack[H:],
//                       all forward in time (the caller flips the backward rows)
//   lstm_scan_bidir2:   the same with each direction's x_proj (T, R, 4H), W_hh and
//                       hs (T, R, H) in its own tensors
//   lstm_fwd_hc:        zero state -> hs, cs (T, R, H)
// Types: x_proj, W_hh, h0, c0, hs and cs are all float32 or all bfloat16 (and in
// lstm_fwd_hc also all float16, on the bfloat16 layout with float16 products); the
// state and every sum are float32. The inference modes round h to the weight
// type before the recurrent product (the `_hdot` rule, pallas_lstm.py:36-43), so
// in bfloat16 the product sees exactly the h that was stored; kFwdHc multiplies
// the unrounded float32 h (pallas_lstm_bwd.py:147-160): in float32 that is the
// same kernel, in bfloat16 h reaches the product as two planes, hi = bf16(h)
// (what is stored) and lo = bf16(h - hi), both exchanged and multiplied by the
// same W_hh fragment (two mma), which makes h to about 2^-17 of it (the split
// of csrc/lstm_scan_wide.cu); float16 the same with f16 planes (h in (-1, 1):
// about 2^-22 of it, and at most 2^-25 absolute below float16's normal range). c is stored rounded but carried in float32. The
// cell is exact: expf and tanhf, as the plain version.
// H % 8 == 0; every pointer 16-byte aligned.
//
// What bounds it. At BSRNN-M's shapes (H = 128) the causal time LSTM of a
// B = 8 x 1024 decode is 272 rows x 1024 steps: 36.5 GFLOP (0.55 ms at the
// float32 peak, 0.04 ms at the bfloat16 tensor-core peak), and above all a
// chain of 1024 dependent steps, each a product of 272 rows with the 128 x 512
// W_hh. A streaming chunk is 272 (8 streams) or 34 rows (one) x 80 steps: the
// same chain, 80 long, and at 34 rows almost nothing else. So the time is the
// latency of a step: the recurrent product, the cell and the exchange of h.
//
// Design: the cluster layout of csrc/lstm_fused.cu without the x @ W_ih half.
// A thread-block cluster of K = ceil(H / U) blocks owns one (direction, row
// tile) at a time; block `rank` owns U hidden units, [rank U, rank U + U), and
// keeps the W_hh columns of their four gates in REGISTERS for the whole launch
// (the slice is 64 KB: 32 registers a thread in bfloat16, 64 in float32), so a
// step reads no weights from shared memory. A cluster walks its tiles (j, j + ncl, ...) with the weights
// loaded once; the caller's plan (ops/lstm.py `scan_narrow_plan`) names the
// tile instance, the tiles, the clusters and the x ring.
// - No barrier on the chain: h travels by dataflow, as in lstm_fused.cu. A
//   block runs the cell of its units for the tile's rows and stores h rounded
//   into hs, into its own h buffer and into every peer's (st.async into
//   distributed shared memory), into one of two buffers by step parity; each
//   st.async completes its bytes on the peer's mbarrier of that buffer, whose
//   one arrival is the peer's own thread 0 announcing the bytes it expects. A
//   peer can store h_n only after reading h_{n-1} from every block, so the two
//   buffers need no other ordering within a tile; one cluster barrier orders
//   each tile boundary (arrive after the last product of a tile, wait before
//   the first store of the next). The last step of a tile sends nothing.
// - x_proj[t] is not on the chain: each block stages the 4 x U columns of its
//   units for the tile's rows by cp.async, `stages` steps ahead, into a ring;
//   the cell adds them to the product's sums. One block barrier a step orders
//   the block's own h and the ring.
// - bfloat16 (U = 64, so K <= 2; 512 threads): the product runs on the tensor
//   cores, mma.sync m16n8k16 with float32 sums (each bf16 x bf16 product
//   exact; only the order of the sums differs from the plain version). Warp w
//   owns units 4w ... 4w + 3 (16 columns, unit-major: column = 4 unit + gate)
//   and INST m16 tiles of rows; its B fragments (8 k-steps x 2 n-tiles) sit in
//   registers, the row operand h comes through ldmatrix from rows padded by 16
//   bytes, all 8 k-steps (k past H is zero on both sides). The C fragments go
//   through a per-warp scratch in shared memory so that lane (r, u) of 8 rows
//   x 4 units runs the cell of one (row, unit): a tile of up to 8 rows costs a
//   lane one exact cell a step, not the four its fragments hold.
// - float32 (true float32: no TF32; U = 32, so K <= 4): CUDA-core FMAs. Lane
//   (ks, unit) of 8 k-slices x 4 units a warp holds W_hh[k][4 gates of its
//   unit] for k in its slice (k-chunks of 4 taken ks, ks + 8, ...: a warp's
//   h reads are 8 consecutive float4, conflict-free), runs all INST rows of
//   the tile, and the 8 slices meet by a shuffle reduce-scatter that leaves
//   each lane the four gates of its rows. The chain a thread runs is 16 k
//   deep, not 128. kFwdHc adds tiles of 32 and 48 rows, run as passes of 16
//   (product, reduce-scatter, cells), so that one tile a cluster holds the
//   training forward's 544 or 1040 rows on the 30 clusters of 4 blocks an H100
//   holds (tiles of 16 took 2 and 3 a cluster).
// Units past H (K U > H) have zero weights and are not written.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// plain C entries (lstm_scan_launch, lstm_scan_stateful_launch,
// lstm_scan_bidir_launch, lstm_scan_bidir2_launch, lstm_fwd_hc_launch,
// lstm_scan_max_clusters), loaded through ctypes.
#include <type_traits>

#include "lstm_cell.cuh"
#include "lstm_cluster.cuh"

namespace {

using namespace lstm;

constexpr int MAX_CLUSTER = 8;          // the portable cluster size
constexpr int MAX_STAGES = 4;
constexpr int HP = 128;                 // k of the recurrent product: H padded with zeros

enum Mode : int { kScan = 0, kStateful = 1, kFwdHc = 2 };

// h reaches the product as two 16-bit planes, hi + lo (h is in (-1, 1): float16
// needs no scale, what is lost is at most half its least subnormal, 2^-25)
template <typename T, int MODE>
constexpr bool kSplit = sizeof(T) == 2 && MODE == kFwdHc;

// the tile constants; ops/lstm.py `_SCAN` mirrors them. A tile of instance
// INST has ROWS * INST rows: bfloat16, INST m16 tiles a warp; float32, INST
// rows a thread. Then the threads of a block and the gate scratch (bfloat16).
template <typename T> struct Scan;
template <> struct Scan<__nv_bfloat16> {
  static constexpr int THREADS = 512;   // 16 warps of 4 units (2 n8 tiles)
  static constexpr int U = 64;
  static constexpr int HPP = HP + 8;    // pitch of an h row: ldmatrix rows in distinct banks
  static constexpr int ROWS = 16;
  static constexpr int GWP = 24;        // pitch of a gate-scratch row (16 columns + 8)
  static constexpr int GW = 16 * 16 * GWP * 4;   // bytes of the warps' [16][GWP] gate scratch
};
template <> struct Scan<__half> : Scan<__nv_bfloat16> {};   // kFwdHc in float16
template <> struct Scan<float> {
  static constexpr int THREADS = 256;   // 32 units x 8 k-slices
  static constexpr int U = 32;
  static constexpr int HPP = HP;
  static constexpr int ROWS = 1;
  static constexpr int GWP = 0;
  static constexpr int GW = 0;
};

template <typename T>
__host__ __device__ constexpr int tile_rows(int inst) {
  return Scan<T>::ROWS * inst;
}

// dynamic shared memory at INST with a ring of `stages` x steps: two h buffers
// (and two of lo for kFwdHc in bfloat16) and the ring, each of the tile's rows
// (x: the 4 x U columns of the block's units), then (bfloat16) the warps' gate
// scratch
template <typename T, int MODE>
constexpr long smem_bytes(int inst, int stages) {
  const long bm = tile_rows<T>(inst);
  return ((kSplit<T, MODE> ? 4 : 2) * bm * Scan<T>::HPP + (long)stages * bm * 4 * Scan<T>::U) *
             (long)sizeof(T) +
         Scan<T>::GW;
}

struct Args {
  const void* xp;         // (Tn, ndir R, 4H)
  const void* w;          // (ndir H, 4H): each direction's W_hh
  const void* xp2;        // two pointers: direction 1's x_proj (Tn, R, 4H), W_hh, hs
  const void* w2;
  void* hs2;
  const void* h0;         // (R, H) (stateful)
  const void* c0;         // (R, H) (stateful)
  void* hs;               // (Tn, ndir R, H)
  void* cs;               // (Tn, R, H) (stateful, kFwdHc)
  int R, Tn, H;           // R: the rows of one direction
  int ntiles;             // row tiles of a direction (balanced: R * p / ntiles)
  int ncl;                // clusters of a direction; cluster j walks tiles j, j + ncl, ...
  int ndir;               // directions: 1, or 2 for lstm_scan_bidir
  int stages;             // x ring (2 ... MAX_STAGES)
};

template <typename T, int INST, int MODE>
__global__ void __launch_bounds__(Scan<T>::THREADS, 1) lstm_scan_kernel(const Args a) {
  using SC = Scan<T>;
  constexpr bool BF = sizeof(T) == 2;             // bfloat16 or float16: the tensor cores
  constexpr bool STATEFUL = MODE == kStateful, SPLIT = kSplit<T, MODE>;
  constexpr bool WRITE_C = MODE != kScan;
  constexpr int THREADS = SC::THREADS, GWP = SC::GWP;
  constexpr int U = SC::U, HPP = SC::HPP, BM = tile_rows<T>(INST), XP = 4 * U;
  constexpr int E = 16 / sizeof(T);                // elements of a 16-byte copy
  constexpr int NT = 2;                            // bfloat16: n8 tiles (4 units) of a warp
  constexpr int KS = THREADS / U;                  // float32: k-slices of a unit
  constexpr int J = HP / (4 * KS);                 // float32: k-chunks of 4 a slice
  const bool two = a.xp2 != nullptr;               // each direction in its own tensors
  const int H = a.H, G = 4 * H, Tn = a.Tn, R = a.R, Rs = two ? R : a.ndir * R, S = a.stages;
  const unsigned K = cluster_size(), rank = cluster_rank();
  const int cl = blockIdx.x / K;
  const int dir = cl % a.ndir, j = cl / a.ndir, rb = two ? 0 : dir * R;   // rb: its first row
  const int u0 = rank * U, own = min(U, H - u0);
  const int nmine = j < a.ntiles ? (a.ntiles - j + a.ncl - 1) / a.ncl : 0;   // tiles of this cluster
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* xp = static_cast<const T*>(two && dir ? a.xp2 : a.xp);
  const T* w = two && dir ? static_cast<const T*>(a.w2) : static_cast<const T*>(a.w) + (size_t)dir * H * G;
  T* hs = static_cast<T*>(two && dir ? a.hs2 : a.hs);
  // rows [row0, row0 + np) of the cluster's tile kt (the balanced tiles of R)
  auto bounds = [&](int kt, int& row0, int& np) {
    const long long p = j + (long long)kt * a.ncl;
    row0 = (int)(R * p / a.ntiles);
    np = (int)(R * (p + 1) / a.ntiles) - row0;
  };

  extern __shared__ float4 smem_f4[];
  constexpr int NH = SPLIT ? 4 : 2;                // h buffers (then lo buffers), by step parity
  T* h_s = reinterpret_cast<T*>(smem_f4);          // [2][BM][HPP], then (kFwdHc in bfloat16) lo
  T* x_s = h_s + NH * BM * HPP;                    // [S][BM][4 gates][U]
  float* g_s = reinterpret_cast<float*>(x_s + (size_t)S * BM * XP);   // bfloat16: [16][16][GWP]

  // zeros in the h buffers (the pad of k past H is read, times zero weights),
  // then the two buffers' mbarriers (by step parity), before any peer can store
  for (int i = tid; i < (int)((NH * (long)BM * HPP * sizeof(T)) / 16); i += THREADS)
    smem_f4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __shared__ alignas(8) unsigned long long h_bar[2];
  if (tid == 0) {
    mbar_init(&h_bar[0]);
    mbar_init(&h_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the block's W_hh columns, into registers for the whole launch (zeros past H)
  auto wval = [&](int k, int gate, int unit) -> T {
    return k < H && unit < H ? w[(size_t)k * G + gate * H + unit] : from_f<T>(0.0f);
  };
  // bfloat16: warp w owns units 4w ... 4w + 3; the B fragment of k-step ks and
  // n-tile nt: column nt * 8 + lane / 4 (unit nt * 2 + lane / 16, gate (lane / 4) & 3),
  // k = 16 ks + 2 (lane & 3) + {0, 1} and + 8
  // float32: lane (ks, unit ul): k = 4 (ks + KS jj) + e
  const int ks = lane % KS, ful = warp * (32 / KS) + lane / KS;
  using Frag = std::conditional_t<BF, unsigned[HP / 16][NT][2], float[J][4][4]>;
  Frag wr;
  if constexpr (BF) {
    const int n = lane >> 2, unit = u0 + warp * 4 + (n >> 2), gate = n & 3;
#pragma unroll
    for (int k16 = 0; k16 < HP / 16; ++k16)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int k = 16 * k16 + 2 * (lane & 3) + 8 * hi;
          wr[k16][nt][hi] = bits(wval(k, gate, unit + 2 * nt)) |
                            (bits(wval(k + 1, gate, unit + 2 * nt)) << 16);
        }
  } else {
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int g = 0; g < 4; ++g) wr[jj][e][g] = to_f<T>(wval(4 * (ks + KS * jj) + e, g, u0 + ful));
  }

  // The x ring. fetch() stages the next item (tile f_kt of the cluster, step
  // f_n) into the next stage as one cp.async group (empty past the last
  // item): the 4 gates x U units of each of the tile's rows, 16 bytes a copy;
  // units past H are not copied (their cells are not stored).
  int f_kt = 0, f_n = 0, f_stage = 0, f_row0 = 0, f_np = 0;
  if (nmine > 0) bounds(0, f_row0, f_np);
  auto fetch = [&]() {
    if (f_kt < nmine) {
      T* dst = x_s + (size_t)f_stage * BM * XP;
      const T* src = xp + ((size_t)f_n * Rs + rb + f_row0) * G + u0;
      for (int i = tid; i < f_np * 4 * (U / E); i += THREADS) {
        const int r = i / (4 * (U / E)), q = (i / (U / E)) & 3, ul = (i % (U / E)) * E;
        if (u0 + ul < H) cp_async16(dst + r * XP + q * U + ul, src + (size_t)r * G + q * H + ul, 16);
      }
      if (++f_n == Tn) {
        f_n = 0;
        if (++f_kt < nmine) bounds(f_kt, f_row0, f_np);
      }
    }
    if (++f_stage == S) f_stage = 0;
    cp_async_commit();
  };

  constexpr int PJ = BF ? NT : 1;
  // float32 tiles past 16 rows (kFwdHc's) run the product and the cells in
  // NPASS passes of CH = 16 rows, so that their sums fit the registers
  constexpr int CH = BF ? INST : (INST > 16 ? 16 : INST), NPASS = INST / CH;
  constexpr int RPL = BF ? INST : (CH >= KS ? CH / KS : 1);       // float32: rows of a lane a pass
  constexpr int DUP = BF ? 1 : (CH >= KS ? 1 : KS / CH);          // float32: lanes of a row
  constexpr int NCELL = BF ? INST * 2 : NPASS * RPL;              // the (row, unit) pairs a lane holds
  float acc[CH][PJ][4];
  float c_reg[NCELL];                              // their c, carried in float32
#pragma unroll
  for (int i = 0; i < NCELL; ++i) c_reg[i] = 0.0f;

  // acc = h rows (np of them, at most CH) x the block's W_hh columns (kFwdHc in
  // bfloat16: + the lo rows at a_s + 2 BM HPP x the same columns)
  auto product = [&](const T* a_s, int np) {
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int jj = 0; jj < PJ; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][jj][q] = 0.0f;
    if constexpr (BF) {
      // all 8 k-steps (k past H is zero on both sides): a runtime bound on the
      // unrolled loop costs more than the zeros; the row operand of 4 k-steps
      // is loaded before their products, so that the loads do not wait on them
      const T* arow = a_s + (lane & 15) * HPP + (lane >> 4) * 8;
#pragma unroll
      for (int mt = 0; mt < INST; ++mt) {
        if (mt * 16 >= np) break;                  // warp-uniform: no row of this tile
#pragma unroll
        for (int k0 = 0; k0 < HP / 16; k0 += 4) {
          unsigned af[4][4], al[SPLIT ? 4 : 1][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) ldsm_x4(af[j], arow + mt * 16 * HPP + (k0 + j) * 16);
          if constexpr (SPLIT) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              ldsm_x4(al[j], arow + 2 * BM * HPP + mt * 16 * HPP + (k0 + j) * 16);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              mma16<T>(acc[mt][nt], af[j], wr[k0 + j][nt][0], wr[k0 + j][nt][1]);
              if constexpr (SPLIT)
                mma16<T>(acc[mt][nt], al[SPLIT ? j : 0], wr[k0 + j][nt][0], wr[k0 + j][nt][1]);
            }
        }
      }
    } else {
      const float* hb = reinterpret_cast<const float*>(a_s) + 4 * ks;
#pragma unroll
      for (int r = 0; r < CH; ++r) {
        if (r >= np) break;                        // uniform
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          const float4 hv = *reinterpret_cast<const float4*>(hb + r * HPP + 4 * KS * jj);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float s = acc[r][0][g];
            s = fmaf(hv.x, wr[jj][0][g], s);
            s = fmaf(hv.y, wr[jj][1][g], s);
            s = fmaf(hv.z, wr[jj][2][g], s);
            s = fmaf(hv.w, wr[jj][3][g], s);
            acc[r][0][g] = s;
          }
        }
      }
    }
  };

  for (int s = 0; s < S; ++s) fetch();
  cluster_arrive();                                // every block of the cluster has started
  cluster_wait();                                  // and set up its barriers
  if (nmine > 0) {
    cp_async_wait_dyn(S - 1);                      // item 0's x (this thread's copies)
    __syncthreads();                               // ... every thread's, and the zeroed buffers
  }

  const T* c0 = static_cast<const T*>(a.c0);
  unsigned parity[2] = {0u, 0u};                   // of each h buffer's next phase
  int m = 0, stage = 0;                            // item (tile kt, step n) and its x stage
  for (int kt = 0; kt < nmine; ++kt) {
    int row0, np;
    bounds(kt, row0, np);
    for (int n = 0; n < Tn; ++n, ++m) {
      T* hb = h_s + (size_t)(m & 1) * BM * HPP;                  // h_{n-1}
      T* hw = h_s + (size_t)((m + 1) & 1) * BM * HPP;            // where h_n goes
      if (n > 0) {                                 // h_{n-1} of every block has landed
        mbar_wait(&h_bar[m & 1], parity[m & 1]);
        parity[m & 1] ^= 1u;
      } else {
        if (kt > 0) cluster_wait();                // every block is done with the last tile's h
        if constexpr (STATEFUL) {                  // h0 of the tile's rows, every unit, as stored
          const T* h0 = static_cast<const T*>(a.h0) + (size_t)row0 * H;
          for (int i = tid; i < np * (H / E); i += THREADS) {
            const int r = i / (H / E), k = (i % (H / E)) * E;
            *reinterpret_cast<uint4*>(hb + r * HPP + k) =
                *reinterpret_cast<const uint4*>(h0 + (size_t)r * H + k);
          }
          __syncthreads();
        }
      }
      const bool send = n + 1 < Tn;                // h_n is read at step n + 1
      if (send && tid == 0)                        // the bytes of h_n (and lo) the peers store here
        mbar_expect(&h_bar[(m + 1) & 1],
                    (unsigned)((SPLIT ? 2 : 1) * np * (H - own) * (int)sizeof(T)));
      if constexpr (BF) {
        product(hb, n > 0 || STATEFUL ? np : 0);   // h_{-1} = 0: no product, zero sums
        if (n + 1 == Tn && kt + 1 < nmine) cluster_arrive();   // this tile's h buffers read
      }
      const T* xb = x_s + (size_t)stage * BM * XP;

      // The cell of (row lr, unit ul of the block) from its four gate sums, where
      // `ok` (rows past the tile read x that was never staged); then h into hs
      // and, where step n + 1 reads it, into this block's h buffer and
      // (st.async) every peer's (kFwdHc in bfloat16: lo = bf16(h - hi) too)
      auto cell = [&](int lr, int ul, const float (&gs)[4], float& c_state, bool ok) {
        T hv = from_f<T>(0.0f), lv = from_f<T>(0.0f);
        float c = 0.0f;
        if (ok) {
          float z[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) z[q] = gs[q] + to_f<T>(xb[lr * XP + q * U + ul]);
          float c_prev = c_state;
          if (n == 0) c_prev = STATEFUL ? to_f<T>(c0[(size_t)(row0 + lr) * H + u0 + ul]) : 0.0f;
          c = sigmoid(z[1]) * c_prev + sigmoid(z[0]) * tanhf(z[2]);
          const float h = sigmoid(z[3]) * tanhf(c);
          hv = from_f<T>(h);
          if constexpr (SPLIT) lv = from_f<T>(h - to_f<T>(hv));
          c_state = c;
        }
        // bfloat16: lanes l and l ^ 1 hold units u and u + 1 of one row; the
        // one with u sends both, as st.async moves 4 bytes at least
        unsigned word = bits(hv), lword = bits(lv);
        if (BF) word |= __shfl_xor_sync(0xffffffffu, word, 1) << 16;
        if (SPLIT) lword |= __shfl_xor_sync(0xffffffffu, lword, 1) << 16;
        if (!ok) return;
        const int unit = u0 + ul;
        T* dst = hw + lr * HPP + unit;
        if (send) {
          *dst = hv;
          if constexpr (SPLIT) dst[2 * BM * HPP] = lv;
          if (!BF || (lane & 1) == 0) {
            const unsigned at = smem_u32(dst), bar = smem_u32(&h_bar[(m + 1) & 1]);
            const unsigned lat = smem_u32(dst + 2 * BM * HPP);
            for (unsigned r = 0; r < K; ++r)
              if (r != rank) {
                st_async(cluster_map(at, r), word, cluster_map(bar, r));
                if (SPLIT) st_async(cluster_map(lat, r), lword, cluster_map(bar, r));
              }
          }
        }
        const size_t o = ((size_t)n * Rs + rb + row0 + lr) * H + unit;
        hs[o] = hv;
        if (WRITE_C) static_cast<T*>(a.cs)[o] = from_f<T>(c);
      };

      if constexpr (BF) {
        // the warp's C fragments hold two gates of one (row, unit) a lane, for
        // every 16 rows whether in the tile or not: through the warp's [16][GWP]
        // scratch, lane (r, u) of 8 rows x 4 units takes the four gates of its
        // (row, unit), so a tile of up to 8 rows costs a lane one cell a step
        float* gw = g_s + warp * 16 * GWP;
        const int ul = warp * 4 + (lane & 3);
#pragma unroll
        for (int mt = 0; mt < INST; ++mt) {
          if (mt * 16 >= np) break;                // warp-uniform: no row of this tile
          __syncwarp();                            // the last m16 tile's reads are done
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int col = nt * 8 + 2 * (lane & 3);
            *reinterpret_cast<float2*>(gw + (lane >> 2) * GWP + col) =
                make_float2(acc[mt][nt][0], acc[mt][nt][1]);
            *reinterpret_cast<float2*>(gw + ((lane >> 2) + 8) * GWP + col) =
                make_float2(acc[mt][nt][2], acc[mt][nt][3]);
          }
          __syncwarp();
#pragma unroll
          for (int it = 0; it < 2; ++it) {
            if (mt * 16 + it * 8 >= np) break;     // warp-uniform
            const int r = it * 8 + (lane >> 2), lr = mt * 16 + r;
            const float4 v = *reinterpret_cast<const float4*>(gw + r * GWP + 4 * (lane & 3));
            const float gs[4] = {v.x, v.y, v.z, v.w};
            cell(lr, ul, gs, c_reg[mt * 2 + it], lr < np && u0 + ul < H);
          }
        }
      } else {
        // a pass: the product of CH rows, then the 8 k-slices' sums meet by the
        // reduce-scatter: lane ks holds the four gates of its RPL rows (DUP lanes
        // hold each row: the first runs it)
#pragma unroll
        for (int pass = 0; pass < NPASS; ++pass) {
          const int p0 = pass * CH;
          if (p0 > 0 && p0 >= np) break;           // uniform
          product(hb + (size_t)p0 * HPP, n > 0 || STATEFUL ? np - p0 : 0);
          float v[4 * CH];
#pragma unroll
          for (int r = 0; r < CH; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) v[4 * r + q] = acc[r][0][q];
          reduce_scatter<4 * CH, KS / 2>(v, lane);
#pragma unroll
          for (int i = 0; i < RPL; ++i) {
            const int lr = p0 + (CH >= KS ? ks * RPL + i : ks / DUP);
            const float gs[4] = {v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]};
            cell(lr, ful, gs, c_reg[pass * RPL + i], ks % DUP == 0 && lr < np && u0 + ful < H);
          }
        }
        if (n + 1 == Tn && kt + 1 < nmine) cluster_arrive();   // this tile's h buffers read
      }
      if (++stage == S) stage = 0;
      if (n + 1 < Tn || kt + 1 < nmine) {
        // every thread's h_n stores into this block's buffer before step n + 1
        // reads them, and every thread done with the x stage just used
        cp_async_wait_dyn(S - 2);                  // the next item's x (this thread's copies)
        __syncthreads();
        fetch();
      }
    }
  }
}

template <typename T, int INST, int MODE>
cudaError_t configure(int K, int smem, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(lstm_scan_kernel<T, INST, MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(Scan<T>::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
int cluster_of(int H) {
  return (H + Scan<T>::U - 1) / Scan<T>::U;
}

// clusters of the instance that the card holds at once
template <typename T, int INST, int MODE>
int max_clusters(int H, int smem, int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  const int K = cluster_of<T>(H);
  cudaError_t e = configure<T, INST, MODE>(K, smem, cfg, attr);
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3(K);
  return cudaOccupancyMaxActiveClusters(clusters, lstm_scan_kernel<T, INST, MODE>, &cfg);
}

// Launches a.ndir directions with the caller's plan; cudaErrorLaunchOutOfResources
// when not even one cluster fits on this device.
template <typename T, int INST, int MODE>
int launch(const Args& a, int smem, cudaStream_t stream) {
  const int K = cluster_of<T>(a.H), BM = tile_rows<T>(INST);
  if (K > MAX_CLUSTER || a.ntiles < 1 || a.ntiles > a.R || a.ncl < 1 || a.ncl > a.ntiles ||
      (a.R + a.ntiles - 1) / a.ntiles > BM || a.stages < 2 || a.stages > MAX_STAGES ||
      smem != smem_bytes<T, MODE>(INST, a.stages))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<T, INST, MODE>(K, smem, cfg, attr);
  if (e != cudaSuccess) return e;
  int fit = 0;
  cfg.gridDim = dim3(K);
  if ((e = cudaOccupancyMaxActiveClusters(&fit, lstm_scan_kernel<T, INST, MODE>, &cfg)) !=
      cudaSuccess)
    return e;
  if (fit < 1) return cudaErrorLaunchOutOfResources;
  cfg.gridDim = dim3(K * a.ncl * a.ndir);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, lstm_scan_kernel<T, INST, MODE>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the instances: INST 1, 2 or 4 m16 tiles of a warp in bfloat16 (and in float16,
// kFwdHc only: the training forward); 1, 2, 4, 8 or 16 rows of a thread in float32
// in each mode, and 32 or 48 (passes of 16) in kFwdHc
template <int MODE, typename F>
int with_instance(int dtype, int inst, F&& f) {
  using bf = __nv_bfloat16;
  using std::integral_constant;
  if constexpr (MODE == kFwdHc) {
    if (dtype == 2) {
      switch (inst) {
        case 1: return f((__half*)nullptr, integral_constant<int, 1>{});
        case 2: return f((__half*)nullptr, integral_constant<int, 2>{});
        case 4: return f((__half*)nullptr, integral_constant<int, 4>{});
        default: return cudaErrorInvalidValue;
      }
    }
  }
  if (dtype == 1) {
    switch (inst) {
      case 1: return f((bf*)nullptr, integral_constant<int, 1>{});
      case 2: return f((bf*)nullptr, integral_constant<int, 2>{});
      case 4: return f((bf*)nullptr, integral_constant<int, 4>{});
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) {
    switch (inst) {
      case 1: return f((float*)nullptr, integral_constant<int, 1>{});
      case 2: return f((float*)nullptr, integral_constant<int, 2>{});
      case 4: return f((float*)nullptr, integral_constant<int, 4>{});
      case 8: return f((float*)nullptr, integral_constant<int, 8>{});
      case 16: return f((float*)nullptr, integral_constant<int, 16>{});
      case 32:                                     // kFwdHc's tiles of 17 ... 48 rows
        if constexpr (MODE == kFwdHc) return f((float*)nullptr, integral_constant<int, 32>{});
        return cudaErrorInvalidValue;
      case 48:
        if constexpr (MODE == kFwdHc) return f((float*)nullptr, integral_constant<int, 48>{});
        return cudaErrorInvalidValue;
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

template <int MODE>
int launch_any(int dtype, int inst, const Args& a, int smem, void* stream) {
  if (a.R <= 0 || a.Tn <= 0 || a.H <= 0 || a.H % 8 || a.H > HP) return cudaErrorInvalidValue;
  return with_instance<MODE>(dtype, inst, [&](auto* ty, auto in) {
    using T = std::remove_pointer_t<decltype(ty)>;
    return launch<T, decltype(in)::value, MODE>(a, smem, static_cast<cudaStream_t>(stream));
  });
}

Args make_args(const void* xp, const void* w, const void* h0, const void* c0, void* hs, void* cs,
               int R, int Tn, int H, int ntiles, int ncl, int ndir, int stages) {
  Args a{};
  a.xp = xp;
  a.w = w;
  a.h0 = h0;
  a.c0 = c0;
  a.hs = hs;
  a.cs = cs;
  a.R = R;
  a.Tn = Tn;
  a.H = H;
  a.ntiles = ntiles;
  a.ncl = ncl;
  a.ndir = ndir;
  a.stages = stages;
  return a;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (lstm_fwd_hc_launch only). x_proj (T, R, 4H), w_hh (H, 4H), h0/c0 (R, H),
// hs/cs (T, R, H), all contiguous and 16-byte aligned on the current device;
// H <= 128, H % 8 == 0. The plan (instance, row tiles, clusters, x stages, smem
// bytes) is ops/lstm.py `scan_narrow_plan`'s. Each entry returns the
// cudaError_t of the launch (0 on success).
extern "C" int lstm_scan_launch(int dtype, const void* xp, const void* w_hh, void* hs, int R,
                                int Tn, int H, int inst, int ntiles, int ncl, int stages, int smem,
                                void* stream) {
  const Args a = make_args(xp, w_hh, nullptr, nullptr, hs, nullptr, R, Tn, H, ntiles, ncl, 1,
                           stages);
  return launch_any<kScan>(dtype, inst, a, smem, stream);
}

extern "C" int lstm_scan_stateful_launch(int dtype, const void* xp, const void* w_hh,
                                         const void* h0, const void* c0, void* hs, void* cs,
                                         int R, int Tn, int H, int inst, int ntiles, int ncl,
                                         int stages, int smem, void* stream) {
  const Args a = make_args(xp, w_hh, h0, c0, hs, cs, R, Tn, H, ntiles, ncl, 1, stages);
  return launch_any<kStateful>(dtype, inst, a, smem, stream);
}

// x_proj (T, R, 4H), w_hh (H, 4H) -> hs, cs (T, R, H): the residual-saving
// forward from zero state, h multiplied unrounded.
extern "C" int lstm_fwd_hc_launch(int dtype, const void* xp, const void* w_hh, void* hs, void* cs,
                                  int R, int Tn, int H, int inst, int ntiles, int ncl, int stages,
                                  int smem, void* stream) {
  const Args a = make_args(xp, w_hh, nullptr, nullptr, hs, cs, R, Tn, H, ntiles, ncl, 1, stages);
  return launch_any<kFwdHc>(dtype, inst, a, smem, stream);
}

// x_proj (T, 2B, 4H), w_stack (2H, 4H), hs (T, 2B, H); B the rows of one
// direction, the plan's tiles and clusters those of one direction.
extern "C" int lstm_scan_bidir_launch(int dtype, const void* xp, const void* w_stack, void* hs,
                                      int B, int Tn, int H, int inst, int ntiles, int ncl,
                                      int stages, int smem, void* stream) {
  const Args a = make_args(xp, w_stack, nullptr, nullptr, hs, nullptr, B, Tn, H, ntiles, ncl, 2,
                           stages);
  return launch_any<kScan>(dtype, inst, a, smem, stream);
}

// The two scans of lstm_scan_bidir2, each direction in its own tensors: xa / xb
// (T, R, 4H), wa / wb (H, 4H) -> ha / hb (T, R, H); the plan as
// lstm_scan_bidir_launch's at B = R.
extern "C" int lstm_scan_bidir2_launch(int dtype, const void* xa, const void* xb, const void* wa,
                                       const void* wb, void* ha, void* hb, int R, int Tn, int H,
                                       int inst, int ntiles, int ncl, int stages, int smem,
                                       void* stream) {
  Args a = make_args(xa, wa, nullptr, nullptr, ha, nullptr, R, Tn, H, ntiles, ncl, 2, stages);
  a.xp2 = xb;
  a.w2 = wb;
  a.hs2 = hb;
  if (!xb || !wb || !hb) return cudaErrorInvalidValue;
  return launch_any<kScan>(dtype, inst, a, smem, stream);
}

// Clusters of ceil(H / units) blocks of the kernel (dtype, mode 0-2 as `Mode`,
// instance) with smem bytes that the card holds at once, into *clusters (the
// plan's co-residency).
extern "C" int lstm_scan_max_clusters(int dtype, int mode, int inst, int H, int smem,
                                      int* clusters) {
  if (H <= 0 || H > HP) return cudaErrorInvalidValue;
  auto query = [&](auto md) {
    constexpr int M = decltype(md)::value;
    return with_instance<M>(dtype, inst, [&](auto* ty, auto in) {
      using T = std::remove_pointer_t<decltype(ty)>;
      return max_clusters<T, decltype(in)::value, M>(H, smem, clusters);
    });
  };
  switch (mode) {
    case kScan: return query(std::integral_constant<int, kScan>{});
    case kStateful: return query(std::integral_constant<int, kStateful>{});
    case kFwdHc: return query(std::integral_constant<int, kFwdHc>{});
    default: return cudaErrorInvalidValue;
  }
}
