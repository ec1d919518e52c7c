// Reverse-time LSTM backward for narrow hidden sizes (H <= 128) and the dW_hh
// reduction for every H the training kernels take, for Hopper (sm_90a).
//
// Replaces the TPU kernel `lstm_bwd` of nvse_tpu/ops/pallas_lstm_bwd.py
// (`_bwd_kernel` / `_bwd_kernel_unrolled`, launched at pallas_lstm_bwd.py:339):
//   lstm_bwd_cluster_kernel  the reverse-time recurrence, H <= 128
//                            (csrc/lstm_bwd_wide.cu takes 128 < H <= 768)
//   lstm_dw_mma_kernel / lstm_dw_fma_kernel (bfloat16 and float16 / float32)
//                            the dW_hh sum, which the TPU kernel adds up inside
//                            its body, for every H (the tiles cover any H % 8 == 0)
// The unrolled TPU variants are the same functions at other unroll factors.
// The residual-saving forward (`lstm_fwd_hc`, pallas_lstm_bwd.py:181) is a mode
// of the scans: csrc/lstm_scan.cu (H <= 128), csrc/lstm_scan_wide.cu (wider).
//
// Contract (time-major, one direction, zero initial state, gate order i,f,g,o):
//   forward:  gates_t = x_proj[t] + h_{t-1} @ W_hh
//             c_t = f * c_{t-1} + i * g;  h_t = o * tanh(c_t)       -> hs, cs (T, R, H)
//   backward: dh = dhs[t] + dh_carry;  dc = dc_carry + dh * o * (1 - tanh(c_t)^2)
//             dgates = [dc*g*i*(1-i), dc*c_{t-1}*f*(1-f), dc*i*(1-g^2), dh*tanh(c_t)*o*(1-o)]
//             dx_proj[t] = dgates;  dh_carry = dgates @ W_hh^T;  dc_carry = dc * f
//             dW_hh = sum_{t, r} h_{t-1}^T dgates                    (the dW kernels)
// with h_{-1} = c_{-1} = 0 read as zeros at t = 0 (no shifted copies in memory).
// x_proj, W_hh, hs, cs, dhs and dx_proj are all float32, all bfloat16 or all float16. The
// backward reads h_{t-1}, c_t and c_{t-1} as stored, sums both products in
// float32, keeps the carries and the carry's dgates in float32
// (pallas_lstm_bwd.py:243) and stores dx_proj in the x_proj type; the cell is
// exact (expf, tanhf). dW sums the stored dx_proj in float32; the splits of the
// rows add their sums into one float32 dW, and the caller casts once.
//
// What bounds the recurrence. At the BSRNN-M training shapes (H = 128; 544 rows
// x 65 steps for the time BiLSTM, 1040 rows x 34 steps for the band BiLSTM,
// 16 launches a step each) it does 9.3 GFLOP a launch (two products of R T x H
// x 4H), 0.14 ms at the float32 peak and 0.009 ms at the bfloat16 tensor-core
// peak, on 100-200 MB. And it is a chain of T dependent steps, each of which
// needs the whole of the previous step's dgates (dh_carry mixes every column).
//
// Design: the cluster layout of csrc/lstm_scan.cu. A thread-block cluster of K =
// ceil(H / U) blocks owns one row tile at a time (U = 64 units a block in
// bfloat16, 32 in float32: K <= 2 / 4); block `rank` owns the U hidden units
// [rank U, rank U + U) and keeps the (H, 4U) column slice of W_hh for their four
// gates resident for both products (bfloat16: shared memory; float32:
// registers, two layouts of 64 a thread). A cluster walks
// its tiles (j, j + ncl, ...) with the slice loaded once; the caller's plan
// (ops/lstm.py `bwd_narrow_plan`) names the tile instance, the tiles, the
// clusters and the ring's depth. At each step t = T-1 ... 0 of a tile a block
// - takes its ring stage: h_{t-1} (all H), x_proj[t] of its 4U columns, dhs[t],
//   c_t and c_{t-1} of its units, staged by cp.async `stages` - 1 steps ahead;
// - recomputes its gates, h_{t-1} @ slice, and their activations and every
//   factor of the cell backward that reads no carry (the sigmoids, the tanhs):
//   all of it before it waits for the carry, so it overlaps the exchange;
// - waits for dh_carry of its units, runs the cell backward (a few FMAs a
//   (row, unit): dc stays in the owning thread's registers), stores dx_proj;
// - computes its share of the next carry, dgates[:, its 4U] @ slice^T, for all
//   H units, and st.asyncs the (rows x U) part of it that belongs to peer p's
//   units into p's shared memory, into a slot per sender and a buffer per step
//   parity, completing on p's mbarrier of that buffer (its own part it stores).
//   p sums the K shares of its units in a fixed order, then adds dhs[t]. The
//   carry goes through distributed shared memory: no L2 round trip, no grid
//   barrier. A peer can store the shares of step t - 1 only after it read those
//   of step t from every block, so the two buffers need no other ordering
//   within a tile; one cluster barrier orders each tile boundary.
// - bfloat16: both products on the tensor cores, mma.sync m16n8k16 with float32
//   sums; the slice is [column][k], read through ldmatrix by the recompute and
//   through ldmatrix.trans (as W_hh^T) by the carry, whose float32 dgates are
//   split in two, dgates = hi + lo with hi = bf16(dgates) and lo = bf16(dgates
//   - hi), each multiplied by the same slice (exact products, float32 sums):
//   what is lost is about 2^-17 of dgates (as csrc/lstm_bwd_wide.cu).
//   float16 takes the bfloat16 layout with float16 products. Its exponent range
//   is not float32's (a GAN step's dgates of 1e-7 are float16 subnormals, and
//   large ones pass 65,504), so its split scales each row of a block's dgates by
//   a power of two first (lstm_cell.cuh row_scale: the row's largest |dgates|
//   lands in [2^13, 2^14)) and the carry's sums by its inverse. Its cell gives each
//   warp whole rows (bfloat16's: each row to two warps), so that one warp reduction
//   meets a row's largest |dgates| and the warp splits its dgates at once: no
//   shared-memory max, block barrier or pass over the dgates beyond bfloat16's.
//   float32 (true float32: no TF32): CUDA-core FMAs with the slice in
//   registers, as csrc/lstm_scan.cu's float32 product: lane (k-slice ks, unit)
//   of 8 x 4 a warp holds W_hh[k][4 gates] for its 16 k, runs 8 rows at a time
//   (one 16-byte h load for 16 FMAs) and the 8 slices meet by a shuffle
//   reduce-scatter that leaves lane ks the gates of row ks; the carry is the
//   same with lane (column slice, output quad) holding W_hh[4 outputs][16
//   columns]. A first version with the slice in shared memory ([k][column],
//   each warp's 16 columns by 8 row lanes x 4 column quads) ran at 12-15 us a
//   step at 17-24 rows (its 16-byte loads, broadcast over the lanes, the likely
//   bound); this one at 8 (scripts/bench_torch_scan_plan.py --kernel train_narrow).
//   Without the slice, the shared memory holds tiles of up to 48 rows: the
//   card holds 30 clusters of 4, and 1040 rows take one tile a cluster.
// Columns are unit-major (column = 4 unit + gate); units past H have zero
// weights and are not written.
//
// The dW kernels: dW_hh is (H, 4H) = 256 KiB in float32 at H = 128, which fits
// neither a block's shared memory nor its registers, so it is a second kernel
// (also that of the wide recurrence of csrc/lstm_bwd_wide.cu, up to H = 768, and of
// the step-wise one of csrc/lstm_stepwise.cu past it and in float16): a
// GEMM over the T*R rows of [h_{t-1} | dx_proj], 128 x 128 output tiles, split
// over the rows so that the grid fills the card; the splits add their sums into
// the float32 (H, 4H) with atomics (in an order that varies from run to run; a
// single split stores). At BSRNN-L's training shapes it is 18.5 GFLOP on 90 MB
// (bf16): bound by operations in float32 (0.28 ms), by bytes in bfloat16 (0.027
// ms). bfloat16 and float16 run on the tensor cores (mma.sync m16n8k16, float32
// sums, each product exact), float32 on CUDA cores with 8 x 8 outputs a thread; both stage
// the rows with cp.async into a ring, the next chunks' copies in flight while
// the current one is multiplied.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// plain C entries (lstm_bwd_launch, lstm_bwd_max_clusters, lstm_dw_launch,
// lstm_dw_blocks_per_sm), loaded through ctypes.
#include <type_traits>

#include "lstm_cell.cuh"
#include "lstm_cluster.cuh"

namespace {

using namespace lstm;

// The recurrence's constants; ops/lstm.py `_BWD_NARROW` mirrors them.
namespace rec {
constexpr int THREADS = 256;            // 8 warps
constexpr int MAX_STAGES = 3;
constexpr int HP = 128;                 // H padded with zeros (the bfloat16 product's k)
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int U = 64, KMAX = 2;
  static constexpr int KP = HP + 8;     // pitch of a slice row [column][k] and of an h row
  static constexpr int WROWS = 4 * U;   // the slice: [4U][KP]
  static constexpr int WP = KP;
  static constexpr int DP = 4 * U + 8;  // pitch of a dgates hi / lo row (bf16)
};
template <> struct Cfg<__half> : Cfg<__nv_bfloat16> {};   // the bfloat16 layout
template <> struct Cfg<float> {
  static constexpr int U = 32, KMAX = 4;
  static constexpr int KP = HP + 4;     // pitch of an h row
  static constexpr int WROWS = 0;       // the slice sits in registers
  static constexpr int WP = 0;
  static constexpr int DP = 0;          // dgates overwrite the gate sums in place
};
template <typename T> constexpr int GP = 4 * Cfg<T>::U + 4;   // pitch of a gate row (float)
template <typename T> constexpr int UP = Cfg<T>::U + 4;       // pitch of a share row (float)

__host__ __device__ constexpr long up16(long v) { return (v + 15) / 16 * 16; }

// elements of a ring stage at BM rows: h_{t-1} [BM][KP], x_proj [BM][4U] (column
// q U + unit of gate q), dhs, c_t and c_{t-1} [BM][U] each
template <typename T>
__host__ __device__ constexpr long stage_elems(int bm) {
  return (long)bm * (Cfg<T>::KP + 7 * Cfg<T>::U);
}

// dynamic shared memory at BM rows and a ring of `stages`: the slice (bfloat16), the ring,
// the gate sums (float32), the dgates hi / lo (bfloat16), the carry shares
// [2 parities][KMAX senders][BM][UP] (float32); each part 16-byte aligned
template <typename T>
__host__ __device__ constexpr long smem_bytes(int bm, int stages) {
  using C = Cfg<T>;
  return up16((long)C::WROWS * C::WP * sizeof(T)) + up16(stages * stage_elems<T>(bm) * sizeof(T)) +
         up16((long)bm * GP<T> * 4) + up16(2L * bm * C::DP * 2) +
         up16(2L * C::KMAX * bm * UP<T> * 4);
}
}  // namespace rec

struct RecArgs {
  const void* xp;         // (Tn, R, 4H)
  const void* hs;         // (Tn, R, H)
  const void* cs;         // (Tn, R, H)
  const void* dhs;        // (Tn, R, H)
  const void* w;          // (H, 4H)
  void* dx;               // (Tn, R, 4H)
  int R, Tn, H;
  int ntiles;             // row tiles (balanced: R * p / ntiles)
  int ncl;                // clusters; cluster j walks tiles j, j + ncl, ...
  int stages;             // the ring (2 ... MAX_STAGES)
};

template <typename T, int BM>
__global__ void __launch_bounds__(rec::THREADS, 1) lstm_bwd_cluster_kernel(const RecArgs a) {
  using C = rec::Cfg<T>;
  constexpr bool BF = sizeof(T) == 2;             // bfloat16 or float16: the tensor cores
  constexpr bool F16 = std::is_same<T, __half>::value;   // the carry's split takes a row scale
  using T16 = std::conditional_t<BF, T, __nv_bfloat16>;  // the dgates planes
  constexpr int THREADS = rec::THREADS, U = C::U, NC = 4 * U, KP = C::KP, WP = C::WP;
  constexpr int GP = rec::GP<T>, UP = rec::UP<T>, DP = C::DP, KM = C::KMAX;
  constexpr int E = 16 / sizeof(T);                // elements of a 16-byte copy
  constexpr int PP = BM * U / THREADS;             // (row, unit) pairs of a thread
  static_assert(!F16 || PP % (U / 32) == 0, "float16: a warp's rows whole");
  constexpr long STAGE = rec::stage_elems<T>(BM);
  static_assert(PP * THREADS == BM * U, "whole pairs a thread");
  const int H = a.H, G = 4 * H, Tn = a.Tn, R = a.R, S = a.stages;
  const unsigned K = cluster_size(), rank = cluster_rank();
  const int j = blockIdx.x / K;
  const int u0 = rank * U, own = max(0, min(U, H - u0));
  const int nmine = j < a.ntiles ? (a.ntiles - j + a.ncl - 1) / a.ncl : 0;   // tiles of this cluster
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* xp = static_cast<const T*>(a.xp);
  const T* hs = static_cast<const T*>(a.hs);
  const T* cs = static_cast<const T*>(a.cs);
  const T* dhs = static_cast<const T*>(a.dhs);
  const T* w = static_cast<const T*>(a.w);
  T* dx = static_cast<T*>(a.dx);
  // rows [row0, row0 + np) of the cluster's tile kt (the balanced tiles of R)
  auto bounds = [&](int kt, int& row0, int& np) {
    const long long p = j + (long long)kt * a.ncl;
    row0 = (int)(R * p / a.ntiles);
    np = (int)(R * (p + 1) / a.ntiles) - row0;
  };

  extern __shared__ float4 smem_f4[];
  char* base = reinterpret_cast<char*>(smem_f4);
  T* w_s = reinterpret_cast<T*>(base);
  base += rec::up16((long)C::WROWS * WP * sizeof(T));
  T* ring = reinterpret_cast<T*>(base);
  base += rec::up16(S * STAGE * sizeof(T));
  float* g_s = reinterpret_cast<float*>(base);     // [BM][GP] gate sums (float32: then dgates)
  base += rec::up16((long)BM * GP * 4);
  T16* dg_hi = reinterpret_cast<T16*>(base);      // 16 bits: [BM][DP] each
  T16* dg_lo = dg_hi + BM * DP;
  base += rec::up16(2L * BM * DP * 2);
  float* share = reinterpret_cast<float*>(base);   // [2][KM][BM][UP]

  // zeros everywhere (the pads that the products read: k past H, units past H),
  // then the two share buffers' mbarriers (by step parity), then the slice
  {
    const long n16 = rec::smem_bytes<T>(BM, S) / 16;
    for (long i = tid; i < n16; i += THREADS) smem_f4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __shared__ alignas(8) unsigned long long bar[2];
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // float16: the float32 bits of the largest |dgates| of row r by item parity, in
  // the pad of r's gate-sum row (zeroed above; the sums fill columns [0, 4U))
  auto rmax = [&](int parity, int r) { return reinterpret_cast<int*>(g_s + r * GP + NC) + parity; };
  // a thread's (row, unit) pairs i = 0 ... PP - 1: p = tid + i THREADS, row p / U and
  // unit p % U; float16 gives a warp whole rows (unit lane + 32 (i % (U / 32)) of row
  // warp + 8 (i / (U / 32))), so that a warp reduction meets a row's largest |dgates|
  auto pair_row = [&](int i) {
    return F16 ? i / (U / 32) * (THREADS / 32) + warp : (tid + i * THREADS) / U;
  };
  auto pair_unit = [&](int i) { return F16 ? i % (U / 32) * 32 + lane : (tid + i * THREADS) % U; };
  __syncthreads();                                 // (also orders the zeros before the ring's copies)
  // bfloat16: the slice in shared memory, [column = 4 unit + gate][k], zeros past H.
  // float32: in registers, as csrc/lstm_scan.cu's: lane (ks, unit fu) of 8 k-slices x
  // 4 units a warp holds W_hh[k][4 gates of its unit] for k = 4 (ks + 8 jj) + e (the
  // recompute), and as lane (column slice ks, output quad fu) W_hh[4 fu + o][the
  // gate e of unit ks + 8 jj] (the carry: its columns 4 (ks + 8 jj) + e)
  constexpr int FJ = BF ? 1 : rec::HP / 32;
  float wr[FJ][4][4], wt[FJ][4][4];
  const int ks = lane & 7, fu = warp * 4 + (lane >> 3);
  if constexpr (BF) {
    for (int i = tid; i < NC * H; i += THREADS) {
      const int k = i / NC, col = i - k * NC, unit = u0 + col / 4, gate = col & 3;
      if (unit < H) w_s[col * WP + k] = w[(size_t)k * G + gate * H + unit];
    }
  } else {
    auto wv = [&](int k, int gate, int unit) {
      return k < H && unit < H ? w[(size_t)k * G + gate * H + unit] : 0.0f;
    };
#pragma unroll
    for (int jj = 0; jj < FJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          wr[jj][e][g] = wv(4 * (ks + 8 * jj) + e, g, u0 + fu);
          wt[jj][e][g] = wv(4 * fu + g, e, u0 + ks + 8 * jj);
        }
  }

  // The ring. fetch() stages the next item (tile f_kt of the cluster, step
  // f_n, t = Tn - 1 - f_n) into the next stage as one cp.async group (empty
  // past the last item), 16 bytes a copy; units past H are not copied.
  int f_kt = 0, f_n = 0, f_stage = 0, f_row0 = 0, f_np = 0;
  if (nmine > 0) bounds(0, f_row0, f_np);
  auto fetch = [&]() {
    if (f_kt < nmine) {
      T* h_ = ring + f_stage * STAGE;
      T* x_ = h_ + BM * KP;
      T* d_ = x_ + BM * NC;                        // dhs, then c_t, then c_{t-1}
      const int t = Tn - 1 - f_n;
      const size_t r0 = (size_t)t * R + f_row0;    // the tile's first row at step t
      for (int i = tid; i < f_np * 4 * (U / E); i += THREADS) {
        const int r = i / (4 * (U / E)), q = (i / (U / E)) & 3, ul = (i % (U / E)) * E;
        if (ul < own) cp_async16(x_ + r * NC + q * U + ul, xp + (r0 + r) * G + q * H + u0 + ul, 16);
      }
      for (int i = tid; i < f_np * (U / E); i += THREADS) {
        const int r = i / (U / E), ul = (i % (U / E)) * E;
        if (ul < own) {
          const size_t o = (r0 + r) * H + u0 + ul;
          cp_async16(d_ + r * U + ul, dhs + o, 16);
          cp_async16(d_ + (BM + r) * U + ul, cs + o, 16);
          if (t > 0) cp_async16(d_ + (2 * BM + r) * U + ul, cs + o - (size_t)R * H, 16);
        }
      }
      if (t > 0) {
        for (int i = tid; i < f_np * (H / E); i += THREADS) {
          const int r = i / (H / E), k = (i % (H / E)) * E;
          cp_async16(h_ + r * KP + k, hs + (r0 - R + r) * H + k, 16);
        }
      }
      if (++f_n == Tn) {
        f_n = 0;
        if (++f_kt < nmine) bounds(f_kt, f_row0, f_np);
      }
    }
    if (++f_stage == S) f_stage = 0;
    cp_async_commit();
  };
  for (int s = 0; s < S - 1; ++s) fetch();
  cluster_arrive();                                // every block of the cluster has started
  cluster_wait();                                  // and set up its barriers

  float dcc[PP];                                   // dc carry of this thread's pairs
  unsigned parity[2] = {0u, 0u};                   // of each share buffer's next phase
  int m = 0;                                       // the item (tile kt, step n)
  for (int kt = 0; kt < nmine; ++kt) {
    int row0, np;
    bounds(kt, row0, np);
    for (int n = 0; n < Tn; ++n, ++m) {
      const int t = Tn - 1 - n;
      cp_async_wait_dyn(S - 2);                    // item m (this thread's copies)
      __syncthreads();                             // ... every thread's; item m - 1's stage is free
      fetch();                                     // item m + S - 1
      if (n == 0 && kt > 0) cluster_wait();        // every block is done with the last tile's shares
      const T* h_ = ring + (m % S) * STAGE;
      const T* x_ = h_ + BM * KP;
      const T* d_ = x_ + BM * NC;
      if (t > 0 && tid == 0)                       // the bytes of dh_carry(t - 1) the peers store here
        mbar_expect(&bar[(t - 1) & 1], (unsigned)((int)(K - 1) * np * own * 4));

      // 1. the gate recompute into g_s [row][column]: h_{t-1} @ slice (float32 sums)
      if (t > 0) {
        if constexpr (BF) {
          // warp: the m16 tile wm of the tile's MT, n8 tiles [wn NT, wn NT + NT) of the 4U columns;
          // all HP / 16 k-steps (k past H is zero on both sides)
          constexpr int MT = BM / 16, NW = 8 / MT, NT = NC / 8 / NW;
          const int wm = warp % MT, wn = warp / MT;
          if (wm * 16 < np) {
            float acc[NT][4];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
            const int mat = lane >> 3, r8 = lane & 7;
            const T* arow = h_ + (wm * 16 + (lane & 15)) * KP + (lane >> 4) * 8;
#pragma unroll
            for (int k = 0; k < rec::HP; k += 16) {
              unsigned af[4];
              ldsm_x4(af, arow + k);
#pragma unroll
              for (int p2 = 0; p2 < NT / 2; ++p2) {   // (cols 0-7 | 8-15) x (k 0-7 | 8-15)
                unsigned tq[4];
                ldsm_x4(tq, w_s + ((wn * NT + p2 * 2) * 8 + (mat >> 1) * 8 + r8) * WP + k +
                                (mat & 1) * 8);
                mma16<T>(acc[2 * p2], af, tq[0], tq[1]);
                mma16<T>(acc[2 * p2 + 1], af, tq[2], tq[3]);
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
        } else {
          // the tile's rows in chunks of 8: lane (ks, fu) sums its k-slice for the
          // chunk's rows, and the reduce-scatter leaves it the 4 gates of row 8 rc + ks
          for (int rc = 0; 8 * rc < np; ++rc) {
            float v[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) v[i] = 0.0f;
            const float* hb = reinterpret_cast<const float*>(h_) + 8 * rc * KP + 4 * ks;
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              if (8 * rc + r >= np) break;         // warp-uniform
#pragma unroll
              for (int jj = 0; jj < FJ; ++jj) {
                const float4 hv = *reinterpret_cast<const float4*>(hb + r * KP + 32 * jj);
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                  float sum = v[4 * r + g];
                  sum = fmaf(hv.x, wr[jj][0][g], sum);
                  sum = fmaf(hv.y, wr[jj][1][g], sum);
                  sum = fmaf(hv.z, wr[jj][2][g], sum);
                  sum = fmaf(hv.w, wr[jj][3][g], sum);
                  v[4 * r + g] = sum;
                }
              }
            }
            reduce_scatter<32, 4>(v, lane);
            if (8 * rc + ks < np)
              *reinterpret_cast<float4*>(g_s + (8 * rc + ks) * GP + 4 * fu) =
                  make_float4(v[0], v[1], v[2], v[3]);
          }
        }
      }
      __syncthreads();

      // 2. everything of the cell backward that reads no carry, for this thread's
      // pairs (`pair`)
      float fa[PP], fb[PP], fc[PP], fd[PP], fe[PP], ff[PP], dhv[PP];
#pragma unroll
      for (int i = 0; i < PP; ++i) {
        const int r = pair_row(i), ul = pair_unit(i);
        fa[i] = fb[i] = fc[i] = fd[i] = fe[i] = ff[i] = dhv[i] = 0.0f;
        if (n == 0) dcc[i] = 0.0f;
        if (r < np && ul < own) {
          const float4 gv = t > 0 ? *reinterpret_cast<const float4*>(g_s + r * GP + 4 * ul)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float z[4] = {to_f<T>(x_[r * NC + ul]) + gv.x, to_f<T>(x_[r * NC + U + ul]) + gv.y,
                              to_f<T>(x_[r * NC + 2 * U + ul]) + gv.z,
                              to_f<T>(x_[r * NC + 3 * U + ul]) + gv.w};
          const float gi = sigmoid(z[0]), gf = sigmoid(z[1]), gg = tanhf(z[2]), go = sigmoid(z[3]);
          const float tc = tanhf(to_f<T>(d_[(BM + r) * U + ul]));
          const float cp = t > 0 ? to_f<T>(d_[(2 * BM + r) * U + ul]) : 0.0f;
          fa[i] = go * (1.0f - tc * tc);           // dc += dh * fa
          fb[i] = gg * gi * (1.0f - gi);           // d_i = dc * fb
          fc[i] = cp * gf * (1.0f - gf);           // d_f = dc * fc
          fd[i] = gi * (1.0f - gg * gg);           // d_g = dc * fd
          fe[i] = tc * go * (1.0f - go);           // d_o = dh * fe
          ff[i] = gf;                              // dc_carry = dc * f
          dhv[i] = to_f<T>(d_[r * U + ul]);
        }
      }

      // 3. dh_carry(t) of this block's units has landed
      if (t + 1 < Tn) {
        mbar_wait(&bar[t & 1], parity[t & 1]);
        parity[t & 1] ^= 1u;
      }
      // 4. the cell backward: dx_proj, and dgates for the carry's product
      const float* sh = share + (size_t)(t & 1) * KM * BM * UP;
      // pair i's dgates d from its carry: dc carried, dx_proj stored
      auto cell = [&](int i, int r, int ul, float (&d)[4]) {
        float dh = dhv[i];
        if (t + 1 < Tn) {
          float carry = 0.0f;
          for (unsigned s = 0; s < K; ++s) carry += sh[(s * BM + r) * UP + ul];
          dh += carry;
        }
        const float dc = dcc[i] + dh * fa[i];
        d[0] = dc * fb[i], d[1] = dc * fc[i], d[2] = dc * fd[i], d[3] = dh * fe[i];
        dcc[i] = dc * ff[i];
        T* dxr = dx + ((size_t)t * R + row0 + r) * G + u0 + ul;
#pragma unroll
        for (int q = 0; q < 4; ++q) dxr[q * H] = from_f<T>(d[q]);
      };
      if constexpr (F16) {
        // a warp's row: its U / 32 pairs a lane, the row's largest |dgates| by a
        // warp reduction, then the float32 dgates as hi + lo at the row's power-of-two scale
        // (lstm_cell.cuh row_scale: every |d sc| < 2^14, nothing below float16's
        // range lost beyond 2^-38 of the row's largest); the carry's sums are scaled
        // back below
#pragma unroll
        for (int i0 = 0; i0 < PP; i0 += U / 32) {
          const int r = pair_row(i0);
          float d[U / 32][4], dmax = 0.0f;
#pragma unroll
          for (int j = 0; j < U / 32; ++j) {
            d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.0f;
            if (r < np && pair_unit(i0 + j) < own) {
              cell(i0 + j, r, pair_unit(i0 + j), d[j]);
              dmax = fmaxf(dmax, fmaxf(fmaxf(fabsf(d[j][0]), fabsf(d[j][1])),
                                       fmaxf(fabsf(d[j][2]), fabsf(d[j][3]))));
            }
          }
          // |dgates| >= 0: its bits order as the values do
          const int mx = (int)__reduce_max_sync(0xffffffffu, (unsigned)__float_as_int(dmax));
          if (r < np) {                            // warp-uniform
            const float sc = row_scale(mx).x;
            if (lane == 0) *rmax(m & 1, r) = mx;
#pragma unroll
            for (int j = 0; j < U / 32; ++j) {
              const int ul = pair_unit(i0 + j);
              if (ul >= own) continue;
              __half hi[4], lo[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) split_f16(d[j][q], sc, hi[q], lo[q]);
              *reinterpret_cast<uint2*>(dg_hi + r * DP + 4 * ul) = *reinterpret_cast<const uint2*>(hi);
              *reinterpret_cast<uint2*>(dg_lo + r * DP + 4 * ul) = *reinterpret_cast<const uint2*>(lo);
            }
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < PP; ++i) {
          const int r = pair_row(i), ul = pair_unit(i);
          if (r < np && ul < own) {
            float d[4];
            cell(i, r, ul, d);
            if constexpr (BF) {                      // the float32 dgates as hi + lo
              unsigned hi[2], lo[2];
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const __nv_bfloat162 h2 = __floats2bfloat162_rn(d[2 * q], d[2 * q + 1]);
                const float2 back = __bfloat1622float2(h2);
                const __nv_bfloat162 l2 = __floats2bfloat162_rn(d[2 * q] - back.x, d[2 * q + 1] - back.y);
                hi[q] = *reinterpret_cast<const unsigned*>(&h2);
                lo[q] = *reinterpret_cast<const unsigned*>(&l2);
              }
              *reinterpret_cast<uint2*>(dg_hi + r * DP + 4 * ul) = make_uint2(hi[0], hi[1]);
              *reinterpret_cast<uint2*>(dg_lo + r * DP + 4 * ul) = make_uint2(lo[0], lo[1]);
            } else {                                 // dgates over the gate sums, in place
              *reinterpret_cast<float4*>(g_s + r * GP + 4 * ul) = make_float4(d[0], d[1], d[2], d[3]);
            }
          }
        }
      }
      if (t == 0) {                                // dh_carry(-1) is not needed
        if (kt + 1 < nmine) cluster_arrive();      // this tile's shares read
        continue;
      }
      __syncthreads();                             // every pair's dgates

      // 5. this block's share of dh_carry(t - 1), dgates[:, its 4U] @ slice^T for
      // all H units: the part of unit k goes to block k / U, slot `rank` of its
      // buffer (t - 1) & 1 (st.async into a peer, a store here)
      float* dst0 = share + ((size_t)((t - 1) & 1) * KM + rank) * BM * UP;
      const unsigned bar_at = smem_u32(&bar[(t - 1) & 1]);
      if constexpr (BF) {
        // warp: n8 tiles (units) 2 warp, 2 warp + 1; all m16 tiles; k over the
        // block's columns of units within H
        constexpr int MT = BM / 16;
        const int mat = lane >> 3, r8 = lane & 7, n0 = warp * 2;
        if (n0 * 8 < H) {
          float acc[MT][2][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[mt][jj][q] = 0.0f;
          for (int kk = 0; kk < 4 * own; kk += 16) {
            // B = slice^T (kk over the block's columns, n over the units): from the
            // [column][k] slice by ldmatrix.trans; matrices (kk 0-7 | 8-15) x (n 0-7 | 8-15)
            unsigned b[4];
            ldsm_x4_trans(b, w_s + (kk + (mat & 1) * 8 + r8) * WP + n0 * 8 + (mat >> 1) * 8);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              if (mt * 16 >= np) break;            // warp-uniform
              unsigned ah[4], al[4];
              const int off = (mt * 16 + (lane & 15)) * DP + kk + (lane >> 4) * 8;
              ldsm_x4(ah, dg_hi + off);
              ldsm_x4(al, dg_lo + off);
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                mma16<T>(acc[mt][jj], ah, b[2 * jj], b[2 * jj + 1]);
                mma16<T>(acc[mt][jj], al, b[2 * jj], b[2 * jj + 1]);
              }
            }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float inv[2] = {1.0f, 1.0f};           // float16: the rows' scales undone
            if constexpr (F16) {
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int r = mt * 16 + (lane >> 2) + 8 * hh;
                if (r < np) inv[hh] = row_scale(*rmax(m & 1, r)).y;
              }
            }
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int k = (n0 + jj) * 8 + 2 * (lane & 3);
              const int pb = k / U;
              if (k >= H) continue;
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int r = mt * 16 + (lane >> 2) + 8 * hh;
                if (r >= np) continue;
                float* dst = dst0 + r * UP + k - pb * U;
                const float2 v = make_float2(acc[mt][jj][2 * hh] * inv[hh],
                                             acc[mt][jj][2 * hh + 1] * inv[hh]);
                if (pb == (int)rank) *reinterpret_cast<float2*>(dst) = v;
                else st_async2(cluster_map(smem_u32(dst), pb), v, cluster_map(bar_at, pb));
              }
            }
          }
        }
      } else {
        // rows in chunks of 8: lane (column slice ks, output quad fu) sums its columns
        // for the chunk's rows, and the reduce-scatter leaves it units 4 fu ... + 3 of
        // row 8 rc + ks
        const int k0 = 4 * fu, pb = k0 / U;
        for (int rc = 0; 8 * rc < np; ++rc) {
          float v[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) v[i] = 0.0f;
          const float* db = g_s + 8 * rc * GP + 4 * ks;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if (8 * rc + r >= np) break;           // warp-uniform
#pragma unroll
            for (int jj = 0; jj < FJ; ++jj) {
              const float4 dv = *reinterpret_cast<const float4*>(db + r * GP + 32 * jj);
#pragma unroll
              for (int o = 0; o < 4; ++o) {
                float sum = v[4 * r + o];
                sum = fmaf(dv.x, wt[jj][0][o], sum);
                sum = fmaf(dv.y, wt[jj][1][o], sum);
                sum = fmaf(dv.z, wt[jj][2][o], sum);
                sum = fmaf(dv.w, wt[jj][3][o], sum);
                v[4 * r + o] = sum;
              }
            }
          }
          reduce_scatter<32, 4>(v, lane);
          const int r = 8 * rc + ks;
          if (r < np && k0 < H) {
            float* dst = dst0 + r * UP + k0 - pb * U;
            const float4 out = make_float4(v[0], v[1], v[2], v[3]);
            if (pb == (int)rank) *reinterpret_cast<float4*>(dst) = out;
            else st_async4(cluster_map(smem_u32(dst), pb), out, cluster_map(bar_at, pb));
          }
        }
      }
    }
  }
}

template <typename T, int BM>
cudaError_t rec_configure(int K, int smem, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(lstm_bwd_cluster_kernel<T, BM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(rec::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
int rec_cluster_of(int H) {
  return (H + rec::Cfg<T>::U - 1) / rec::Cfg<T>::U;
}

// clusters of the instance that the card holds at once
template <typename T, int BM>
int rec_max_clusters(int H, int smem, int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  const int K = rec_cluster_of<T>(H);
  cudaError_t e = rec_configure<T, BM>(K, smem, cfg, attr);
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3(K);
  return cudaOccupancyMaxActiveClusters(clusters, lstm_bwd_cluster_kernel<T, BM>, &cfg);
}

// The launch with the caller's plan; cudaErrorLaunchOutOfResources when not
// even one cluster fits on this device.
template <typename T, int BM>
int rec_launch(const RecArgs& a, int smem, cudaStream_t stream) {
  const int K = rec_cluster_of<T>(a.H);
  if (K > rec::Cfg<T>::KMAX || a.ntiles < 1 || a.ntiles > a.R || a.ncl < 1 || a.ncl > a.ntiles ||
      (a.R + a.ntiles - 1) / a.ntiles > BM || a.stages < 2 || a.stages > rec::MAX_STAGES ||
      smem != rec::smem_bytes<T>(BM, a.stages))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t e = rec_configure<T, BM>(K, smem, cfg, attr);
  if (e != cudaSuccess) return e;
  int fit = 0;
  cfg.gridDim = dim3(K);
  if ((e = cudaOccupancyMaxActiveClusters(&fit, lstm_bwd_cluster_kernel<T, BM>, &cfg)) != cudaSuccess)
    return e;
  if (fit < 1) return cudaErrorLaunchOutOfResources;
  cfg.gridDim = dim3(K * a.ncl);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, lstm_bwd_cluster_kernel<T, BM>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the instances (dtype, rows a tile); ops/lstm.py `_BWD_NARROW` mirrors them
template <typename F>
int rec_with_instance(int dtype, int tile_rows, F&& f) {
  using std::integral_constant;
  if (dtype == 1 && tile_rows == 16) return f((__nv_bfloat16*)nullptr, integral_constant<int, 16>{});
  if (dtype == 2 && tile_rows == 16) return f((__half*)nullptr, integral_constant<int, 16>{});
  if (dtype == 0 && tile_rows == 16) return f((float*)nullptr, integral_constant<int, 16>{});
  if (dtype == 0 && tile_rows == 32) return f((float*)nullptr, integral_constant<int, 32>{});
  if (dtype == 0 && tile_rows == 48) return f((float*)nullptr, integral_constant<int, 48>{});
  return cudaErrorInvalidValue;
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
template <typename T> constexpr int smem_bytes() {
  if constexpr (sizeof(T) == 2) return MMA_STAGES * MMA_BK * 2 * MMA_PITCH * 2;
  else return FMA_STAGES * FMA_BK * (BM + BN) * 4;
}
}  // namespace dw

// bfloat16 and float16 (T): a block owns a 128 x 128 tile of (m, j) and the split's rows;
// 8 warps as 2 (m) x 4 (j), 64 x 32 outputs each, as 4 x 4 mma.sync
// m16n8k16 tiles with float32 sums in registers. Both operands come through
// ldmatrix.trans (A's rows n are contiguous along m, B's along j). The
// stages are filled by cp.async, three chunks of 32 rows in flight ahead of
// the one being multiplied.
template <typename T>
__global__ void __launch_bounds__(dw::THREADS)
lstm_dw_mma_kernel(const T* __restrict__ hs, const T* __restrict__ dx,
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
  T* sm = reinterpret_cast<T*>(smem_f4);

  auto fetch = [&](int c) {                           // chunk c into its stage, one group
    if (c < nk) {
      T* a_s = sm + (c % MMA_STAGES) * STAGE;
      T* b_s = a_s + MMA_BK * MMA_PITCH;
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
    const T* a_s = sm + (c % MMA_STAGES) * STAGE;
    const T* b_s = a_s + MMA_BK * MMA_PITCH;
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
        for (int nt = 0; nt < 4; ++nt) {
          if constexpr (std::is_same_v<T, __half>) mma_f16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
          else mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
        }
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

template <typename T>
cudaError_t dw_set_smem() {
  if constexpr (std::is_same_v<T, float>)
    return cudaFuncSetAttribute(lstm_dw_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                dw::smem_bytes<T>());
  else
    return cudaFuncSetAttribute(lstm_dw_mma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
    lstm_dw_mma_kernel<T><<<grid, dw::THREADS, smem, stream>>>(
        static_cast<const T*>(hs), static_cast<const T*>(dx), dw, R, (int)N, H, rows_per_split);
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
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lstm_dw_mma_kernel<T>, dw::THREADS,
                                                         dw::smem_bytes<T>());
}


// the recurrence runs H <= 128 (a cluster of at most KMAX blocks); the dW
// reduction is tiled and takes every H (kDwMaxH: the grid's y, one 128-row tile a block)
constexpr int kDwMaxH = 65535 * dw::BM;
bool bad_shape(int R, int Tn, int H, int max_h = rec::HP) {
  return R <= 0 || Tn <= 0 || H <= 0 || H > max_h || H % 8;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. x_proj (T, R, 4H), hs/cs/dhs (T, R, H), w_hh
// (H, 4H) -> dx_proj (T, R, 4H); all contiguous and 16-byte aligned on the
// current device, H <= 128, H % 8 == 0. The plan (tile rows, row tiles,
// clusters, ring stages, smem bytes) is ops/lstm.py `bwd_narrow_plan`'s. Each
// entry returns the cudaError_t of the launch (0 on success).
extern "C" int lstm_bwd_launch(int dtype, const void* xp, const void* hs, const void* cs,
                               const void* dhs, const void* w_hh, void* dx, int R, int Tn, int H,
                               int tile_rows, int ntiles, int ncl, int stages, int smem,
                               void* stream) {
  if (bad_shape(R, Tn, H)) return cudaErrorInvalidValue;
  const RecArgs a{xp, hs, cs, dhs, w_hh, dx, R, Tn, H, ntiles, ncl, stages};
  return rec_with_instance(dtype, tile_rows, [&](auto* ty, auto bm) {
    using T = std::remove_pointer_t<decltype(ty)>;
    return rec_launch<T, decltype(bm)::value>(a, smem, static_cast<cudaStream_t>(stream));
  });
}

// Clusters of ceil(H / units) blocks of the recurrence (dtype, tile rows) with
// smem bytes that the card holds at once, into *clusters (the plan's co-residency).
extern "C" int lstm_bwd_max_clusters(int dtype, int tile_rows, int H, int smem, int* clusters) {
  if (H <= 0 || H > rec::HP) return cudaErrorInvalidValue;
  return rec_with_instance(dtype, tile_rows, [&](auto* ty, auto bm) {
    using T = std::remove_pointer_t<decltype(ty)>;
    return rec_max_clusters<T, decltype(bm)::value>(H, smem, clusters);
  });
}

// dtype: 0 float32, 1 bfloat16, 2 float16.
// hs (T, R, H), dx_proj (T, R, 4H) -> dw float32 (H, 4H): split s sums rows
// [s * rows_per_split, (s + 1) * rows_per_split) of the T*R rows and adds them
// into dw, which the caller zeroes when nsplit > 1 (one split stores); smem is
// the plan's dynamic shared memory (ops/lstm.py `dw_plan`), checked against
// this build's. All 16-byte aligned.
extern "C" int lstm_dw_launch(int dtype, const void* hs, const void* dx, void* dw, int R,
                              int Tn, int H, int nsplit, int rows_per_split, int smem,
                              void* stream) {
  if (bad_shape(R, Tn, H, kDwMaxH) || nsplit <= 0 || (long)R * Tn > 0x7fffffff)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  if (dtype == 0) return launch_dw<float>(hs, dx, out, R, Tn, H, nsplit, rows_per_split, smem, s);
  if (dtype == 1)
    return launch_dw<__nv_bfloat16>(hs, dx, out, R, Tn, H, nsplit, rows_per_split, smem, s);
  if (dtype == 2) return launch_dw<__half>(hs, dx, out, R, Tn, H, nsplit, rows_per_split, smem, s);
  return cudaErrorInvalidValue;
}

// Blocks of the dW kernel for `dtype` that one SM holds at once (the plan's
// blocks_per_sm), into *blocks.
extern "C" int lstm_dw_blocks_per_sm(int dtype, int* blocks) {
  if (dtype == 0) return dw_blocks_per_sm<float>(blocks);
  if (dtype == 1) return dw_blocks_per_sm<__nv_bfloat16>(blocks);
  if (dtype == 2) return dw_blocks_per_sm<__half>(blocks);
  return cudaErrorInvalidValue;
}
