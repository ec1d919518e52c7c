// Reverse-time LSTM backward recurrence for wide hidden sizes (128 < H <= 768),
// for Hopper (sm_90a).
//
// Replaces, at those sizes, the reverse-time recurrence of the TPU kernel
// `lstm_bwd` of nvse_tpu/ops/pallas_lstm_bwd.py (`_bwd_kernel` /
// `_bwd_kernel_unrolled`, launched at pallas_lstm_bwd.py:339); its dW_hh sum is
// the reduction of csrc/lstm_bwd.cu. csrc/lstm_bwd.cu's recurrence (one thread
// per gate column) takes H <= 128.
//
// Contract: that of csrc/lstm_bwd.cu (time-major, one scan, zero initial state,
// gate order i, f, g, o), for t = T-1 .. 0:
//   gates = x_proj[t] + h_{t-1} @ W_hh          (recomputed from the saved h_{t-1})
//   dh = dhs[t] + dh_carry;  dc = dc_carry + dh * o * (1 - tanh(c_t)^2)
//   dgates = [dc*g*i*(1-i), dc*c_{t-1}*f*(1-f), dc*i*(1-g^2), dh*tanh(c_t)*o*(1-o)]
//   dx_proj[t] = dgates;  dh_carry = dgates @ W_hh^T;  dc_carry = dc * f
// with h_{-1} = c_{-1} = 0 and the carries zero at t = T-1. x_proj, W_hh, hs,
// cs, dhs and dx_proj are all float32 or all bfloat16; h_{t-1}, c_t and c_{t-1}
// are read as stored, both products and the carries are float32 sums, and
// dx_proj is stored in the x_proj type. The carry's dgates are float32, as
// the JAX kernel's (pallas_lstm_bwd.py:239). In bfloat16 they reach the
// tensor cores split in two, dgates = hi + lo with hi = bf16(dgates) and lo =
// bf16(dgates - hi), each multiplied by the same W_hh (exact products, float32
// sums): what is lost is dgates - hi - lo, about 2^-17 of dgates, so the carry
// stays within float32 rounding of the exact one. The nonlinearities are
// exact (expf, tanhf).
//
// What bounds it. BSRNN-L training (H = 256) runs it at 544 rows x 65 steps
// (the time BiLSTM) and 1040 x 34 (the band BiLSTM), 16 launches a step each:
// 37 GFLOP a launch (two products of R T x H x 4H), 0.55 ms at the float32
// peak and 0.04 ms at the bfloat16 tensor-core peak, on 60-120 MB. And it is
// a chain of T dependent steps, each of which needs the whole of the previous
// step's dgates (dh_carry mixes every column of every unit).
//
// Design: the layout of csrc/lstm_fused_wide.cu. A block owns one (row group,
// slice of U hidden units) for the whole launch, and the plan (ops/lstm.py
// `bwd_wide_plan`) takes as many row groups of H / U blocks as the card holds
// at once: all co-resident blocks work every step. One cooperative grid
// barrier separates the steps, so a grid that cannot be co-resident is a
// launch error, never a hang. The block keeps the (H, 4U) column slice of
// W_hh for its units' four gates in shared memory, in the input type, for
// both products. At each step it runs its group's rows in tiles of TM:
// - the gate recompute, h_{t-1} @ W_hh[:, its columns]: h_{t-1} is the saved
//   hs[t-1], staged by cp.async (off the dependent chain: it reads no carry);
// - the cell backward of each (row, unit), dc carried in a float32 scratch
//   that only the pair's thread touches, dx_proj written;
// - its share of the next carry, dgates[:, its columns] @ W_hh[:, its
//   columns]^T, for all H: (TM, H) float32 written to a share buffer that the
//   group's blocks read after the barrier, each summing the H / U shares of
//   its own units. A block reads and writes R_g x H floats a step however many
//   blocks there are (the kernel this replaces read nb x R x H: every block
//   walked every row).
// - bfloat16: both products on the tensor cores, mma.sync m16n8k16 with
//   float32 sums; the slice is [column][k], read through ldmatrix by the
//   recompute and through ldmatrix.trans (as W_hh^T) by the carry. float32
//   (true float32: no TF32): CUDA-core FMAs, a warp's rows broadcast, its
//   lanes over the columns of the recompute and over the H outputs of the
//   carry, the slice [k][column] with an odd pitch.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// plain C entries (lstm_bwd_wide_launch, lstm_bwd_wide_blocks_per_sm), loaded
// through ctypes.
#include <cooperative_groups.h>

#include <type_traits>

#include "lstm_cell.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace lstm;

constexpr int THREADS = 256;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The layout of one instance (T, U units, TM rows a tile); ops/lstm.py
// `_bwd_wide_smem` mirrors it. bfloat16: w [4U][KP] (k padded to 16, rows 16
// bytes longer), h [TM][KP], g float32 [TM][4U], dg hi and lo [TM][4U + 8];
// float32: w [H][4U + 1], h [TM][H + 4], g (gates, then dgates) [TM][4U + 4].
template <typename T> struct Lay;
template <> struct Lay<__nv_bfloat16> {
  __host__ __device__ static int kp(int H) { return round_up(H, 16) + 8; }
  __host__ __device__ static long w(int U, int H) { return 4L * U * kp(H) * 2; }
  __host__ __device__ static long h(int TM, int H) { return (long)TM * kp(H) * 2; }
  __host__ __device__ static long g(int TM, int U) { return (long)TM * 4 * U * 4; }
  __host__ __device__ static long dg(int TM, int U) { return 2L * TM * (4 * U + 8) * 2; }
};
template <> struct Lay<float> {
  __host__ __device__ static long w(int U, int H) { return (long)H * (4 * U + 1) * 4; }
  __host__ __device__ static long h(int TM, int H) { return (long)TM * (H + 4) * 4; }
  __host__ __device__ static long g(int TM, int U) { return (long)TM * (4 * U + 4) * 4; }
  __host__ __device__ static long dg(int, int) { return 0; }
};

template <typename T>
__host__ __device__ long smem_bytes(int U, int TM, int H) {
  using L = Lay<T>;
  // each part 16-byte aligned
  return round_up((int)L::w(U, H), 16) + round_up((int)L::h(TM, H), 16) +
         round_up((int)L::g(TM, U), 16) + round_up((int)L::dg(TM, U), 16);
}

struct Args {
  const void* xp;         // (Tn, R, 4H)
  const void* hs;         // (Tn, R, H)
  const void* cs;         // (Tn, R, H)
  const void* dhs;        // (Tn, R, H)
  const void* w;          // (H, 4H)
  void* dx;               // (Tn, R, 4H)
  float* share;           // float32 (2, H / U, R, H) scratch: the carry's shares by step parity
  float* dc;              // float32 (R, H) scratch: the dc carry of each (row, unit)
  int R, Tn, H;
  int groups;             // row groups (balanced: R * g / groups)
};

template <typename T, int U, int TM>
__global__ void __launch_bounds__(THREADS, 1) lstm_bwd_wide_kernel(const Args a) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  constexpr int NC = 4 * U;                        // the block's gate columns
  constexpr int E = 16 / sizeof(T);
  using L = Lay<T>;
  cg::grid_group grid = cg::this_grid();
  const int H = a.H, G = 4 * H, R = a.R, Tn = a.Tn;
  const int nbg = H / U;                           // blocks of a row group
  const int gi = blockIdx.x / nbg, si = blockIdx.x % nbg, u0 = si * U;
  const int grow0 = (int)((long long)R * gi / a.groups);
  const int grows = (int)((long long)R * (gi + 1) / a.groups) - grow0;
  const int ntile = (grows + TM - 1) / TM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* xp = static_cast<const T*>(a.xp);
  const T* hs = static_cast<const T*>(a.hs);
  const T* cs = static_cast<const T*>(a.cs);
  const T* dhs = static_cast<const T*>(a.dhs);
  const T* w = static_cast<const T*>(a.w);
  T* dx = static_cast<T*>(a.dx);

  extern __shared__ float4 smem_f4[];
  char* base = reinterpret_cast<char*>(smem_f4);
  T* w_s = reinterpret_cast<T*>(base);
  base += round_up((int)L::w(U, H), 16);
  T* h_s = reinterpret_cast<T*>(base);
  base += round_up((int)L::h(TM, H), 16);
  float* g_s = reinterpret_cast<float*>(base);
  base += round_up((int)L::g(TM, U), 16);
  __nv_bfloat16* dg_hi = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* dg_lo = dg_hi + TM * (NC + 8);

  // the slice: bfloat16 [column = 4 unit + gate][k] (zeros past H in k), float32
  // [k][column]; the h tile's pad of k zeroed (cp.async writes [0, H) only)
  const int KP = BF ? round_up(H, 16) + 8 : H + 4;                // pitch of an h row
  const int WP = BF ? KP : NC + 1;                                // pitch of a slice row
  for (int i = tid; i < (BF ? NC * KP : H * NC); i += THREADS) {
    int col, k;
    if (BF) { col = i / KP; k = i - col * KP; }
    else { k = i / NC; col = i - k * NC; }
    const int unit = u0 + col / 4, gate = col & 3;
    const T v = k < H ? w[(size_t)k * G + gate * H + unit] : from_f<T>(0.0f);
    w_s[BF ? col * WP + k : k * WP + col] = v;
  }
  for (int i = tid; i < TM * KP; i += THREADS) h_s[i] = from_f<T>(0.0f);
  __syncthreads();

  for (int t = Tn - 1; t >= 0; --t) {
    const float* carry = a.share + (size_t)((t + 1) & 1) * nbg * R * H;   // written at step t + 1
    float* share = a.share + (size_t)(t & 1) * nbg * R * H;
    for (int tile = 0; tile < ntile; ++tile) {
      const int r0 = (int)((long long)grows * tile / ntile);
      const int np = (int)((long long)grows * (tile + 1) / ntile) - r0;
      const int row0 = grow0 + r0;                 // the tile's first row
      // 1. h_{t-1} of the tile's rows (the saved hs[t - 1]) into h_s
      if (t > 0) {
        const T* src = hs + ((size_t)(t - 1) * R + row0) * H;
        for (int i = tid; i < np * (H / E); i += THREADS) {
          const int r = i / (H / E), k = (i - r * (H / E)) * E;
          cp_async16(h_s + r * KP + k, src + (size_t)r * H + k, 16);
        }
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
      // 2. the gate recompute into g_s [row][column] (float32 sums)
      if (t > 0) {
        if constexpr (BF) {
          // warp (wm, wn): m16 tile wm of MT, n8 tiles [wn NT, wn NT + NT) of the 4U columns
          constexpr int MT = TM / 16, NW = 8 / MT, NT = NC / 8 / NW;
          const int wm = warp % MT, wn = warp / MT;
          if (wm * 16 < np) {
            float acc[NT][4];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
            const int mat = lane >> 3, r8 = lane & 7;
            const T* arow = h_s + (wm * 16 + (lane & 15)) * KP + (lane >> 4) * 8;
            for (int k = 0; k < H; k += 16) {
              unsigned af[4];
              ldsm_x4(af, arow + k);
#pragma unroll
              for (int np2 = 0; np2 < NT / 2; ++np2) {   // (cols 0-7 | 8-15) x (k 0-7 | 8-15)
                unsigned tq[4];
                ldsm_x4(tq, w_s + (size_t)((wn * NT + np2 * 2) * 8 + (mat >> 1) * 8 + r8) * WP +
                                k + (mat & 1) * 8);
                mma_bf16(acc[2 * np2], af, tq[0], tq[1]);
                mma_bf16(acc[2 * np2 + 1], af, tq[2], tq[3]);
              }
            }
            const int rr = wm * 16 + (lane >> 2);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int col = (wn * NT + nt) * 8 + 2 * (lane & 3);
              *reinterpret_cast<float2*>(g_s + rr * NC + col) = make_float2(acc[nt][0], acc[nt][1]);
              *reinterpret_cast<float2*>(g_s + (rr + 8) * NC + col) =
                  make_float2(acc[nt][2], acc[nt][3]);
            }
          }
        } else {
          // warp: rows [warp RM, warp RM + RM); lane: columns lane + 32 i
          constexpr int RM = TM / 8, NPL = NC / 32;
          const int wr0 = warp * RM;
          if (wr0 < np) {
            float acc[RM][NPL];
#pragma unroll
            for (int r = 0; r < RM; ++r)
#pragma unroll
              for (int i = 0; i < NPL; ++i) acc[r][i] = 0.0f;
            const float* hb = reinterpret_cast<const float*>(h_s) + wr0 * KP;
            const float* wb = reinterpret_cast<const float*>(w_s) + lane;
            for (int k = 0; k < H; k += 4) {
              float wv[4][NPL];
#pragma unroll
              for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int i = 0; i < NPL; ++i) wv[e][i] = wb[(k + e) * WP + 32 * i];
#pragma unroll
              for (int r = 0; r < RM; ++r) {
                const float4 hv = *reinterpret_cast<const float4*>(hb + r * KP + k);
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
            for (int r = 0; r < RM; ++r)
#pragma unroll
              for (int i = 0; i < NPL; ++i) g_s[(wr0 + r) * (NC + 4) + lane + 32 * i] = acc[r][i];
          }
        }
      }
      __syncthreads();
      // 3. the cell backward of each (row, unit) of the tile. dh_carry is the
      // sum of the group's nbg shares of the pair: P neighbouring threads a pair
      // (as many as the block has to spare, up to 8) load them, independent
      // loads, and meet by shuffles in a fixed order
      const int GP = BF ? NC : NC + 4;             // pitch of a g_s row
      const int cells = np * U;
      int P = 1;
      while (P < 8 && cells * P * 2 <= THREADS) P *= 2;
      const int part = tid % P;
      const size_t RH = (size_t)R * H;
      for (int p0 = 0; p0 < cells; p0 += THREADS / P) {
        const int p = p0 + tid / P;
        const bool on = p < cells;
        const int r = on ? p / U : 0, ul = on ? p - r * U : 0, row = row0 + r, unit = u0 + ul;
        float carry_dh = 0.0f;
        if (on && t + 1 < Tn) {
          const float* cp = carry + (size_t)row * H + unit;
          float sv[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) sv[j] = 0.0f;
          int b = part;
          for (; b + 7 * P < nbg; b += 8 * P) {    // 8 loads in flight
#pragma unroll
            for (int j = 0; j < 8; ++j) sv[j] += __ldcg(cp + (b + j * P) * RH);
          }
#pragma unroll 7
          for (; b < nbg; b += P) sv[0] += __ldcg(cp + b * RH);
          carry_dh = ((sv[0] + sv[1]) + (sv[2] + sv[3])) + ((sv[4] + sv[5]) + (sv[6] + sv[7]));
        }
        for (int msk = P / 2; msk > 0; msk >>= 1)
          carry_dh += __shfl_xor_sync(0xffffffffu, carry_dh, msk);
        if (!on || part) continue;
        const size_t o = ((size_t)t * R + row) * H + unit;
        const T* x = xp + ((size_t)t * R + row) * G + unit;
        float z[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) z[q] = to_f<T>(x[q * H]) + (t > 0 ? g_s[r * GP + 4 * ul + q] : 0.0f);
        const float c = to_f<T>(cs[o]);
        const float c_prev = t > 0 ? to_f<T>(cs[o - RH]) : 0.0f;
        const float dh = to_f<T>(dhs[o]) + carry_dh;
        float* dcp = a.dc + (size_t)row * H + unit;
        const float dcc = t + 1 < Tn ? __ldcg(dcp) : 0.0f;
        const float gi_ = sigmoid(z[0]), gf = sigmoid(z[1]), gg = tanhf(z[2]), go = sigmoid(z[3]);
        const float tc = tanhf(c);
        const float dc = dcc + dh * go * (1.0f - tc * tc);
        float d[4];
        d[0] = dc * gg * gi_ * (1.0f - gi_);
        d[1] = dc * c_prev * gf * (1.0f - gf);
        d[2] = dc * gi_ * (1.0f - gg * gg);
        d[3] = dh * tc * go * (1.0f - go);
        __stcg(dcp, dc * gf);
        T* dxr = dx + ((size_t)t * R + row) * G + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dxr[q * H] = from_f<T>(d[q]);
          if constexpr (BF) {
            const __nv_bfloat16 hi = __float2bfloat16(d[q]);
            dg_hi[r * (NC + 8) + 4 * ul + q] = hi;
            dg_lo[r * (NC + 8) + 4 * ul + q] = __float2bfloat16(d[q] - __bfloat162float(hi));
          } else {
            g_s[r * GP + 4 * ul + q] = d[q];       // dgates over the gates, in place
          }
        }
      }
      if (t == 0) continue;                        // dh_{-1} is not needed
      __syncthreads();
      // 4. this block's share of dh_{t-1} for the tile's rows: dgates[:, its
      // columns] @ W_hh[:, its columns]^T, all H outputs
      if constexpr (BF) {
        // warp: n8 tiles (k outputs) 2 warp, 2 warp + 1, then + 16 ...; all m16 tiles
        constexpr int MT = TM / 16;
        const int mat = lane >> 3, r8 = lane & 7;
        const int NT8 = round_up(H, 16) / 8;
        for (int n0 = warp * 2; n0 < NT8; n0 += 16) {
          float acc[MT][2][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.0f;
#pragma unroll
          for (int kk = 0; kk < NC; kk += 16) {
            // B = W^T (kk over the block's columns, n over k): from the [column][k]
            // slice by ldmatrix.trans; matrices (kk 0-7 | 8-15) x (n 0-7 | 8-15)
            unsigned b[4];
            ldsm_x4_trans(b, w_s + (size_t)(kk + (mat & 1) * 8 + r8) * WP + n0 * 8 + (mat >> 1) * 8);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              if (mt * 16 >= np) continue;         // warp-uniform
              unsigned ah[4], al[4];
              const int off = (mt * 16 + (lane & 15)) * (NC + 8) + kk + (lane >> 4) * 8;
              ldsm_x4(ah, dg_hi + off);
              ldsm_x4(al, dg_lo + off);
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                mma_bf16(acc[mt][j], ah, b[2 * j], b[2 * j + 1]);
                mma_bf16(acc[mt][j], al, b[2 * j], b[2 * j + 1]);
              }
            }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int kout = (n0 + j) * 8 + 2 * (lane & 3);
              if (kout >= H) continue;
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int r = mt * 16 + (lane >> 2) + 8 * hh;
                if (r < np)
                  *reinterpret_cast<float2*>(share + ((size_t)si * R + row0 + r) * H + kout) =
                      make_float2(acc[mt][j][2 * hh], acc[mt][j][2 * hh + 1]);
              }
            }
        }
      } else {
        // warp: rows [warp RM, warp RM + RM); lane: outputs k = lane + 32 i, 8 a pass
        constexpr int RM = TM / 8, KPL = 8;
        const int wr0 = warp * RM;
        if (wr0 < np) {
          const float* wb = reinterpret_cast<const float*>(w_s);
          for (int k0 = 0; k0 < H; k0 += 32 * KPL) {
            float acc[RM][KPL];
#pragma unroll
            for (int r = 0; r < RM; ++r)
#pragma unroll
              for (int i = 0; i < KPL; ++i) acc[r][i] = 0.0f;
            for (int col = 0; col < NC; col += 4) {
              float wv[4][KPL];
#pragma unroll
              for (int i = 0; i < KPL; ++i) {
                const int k = min(k0 + lane + 32 * i, H - 1);
#pragma unroll
                for (int e = 0; e < 4; ++e) wv[e][i] = wb[k * WP + col + e];
              }
#pragma unroll
              for (int r = 0; r < RM; ++r) {
                const float4 dv = *reinterpret_cast<const float4*>(g_s + (wr0 + r) * GP + col);
#pragma unroll
                for (int i = 0; i < KPL; ++i) {
                  float s = acc[r][i];
                  s = fmaf(dv.x, wv[0][i], s);
                  s = fmaf(dv.y, wv[1][i], s);
                  s = fmaf(dv.z, wv[2][i], s);
                  s = fmaf(dv.w, wv[3][i], s);
                  acc[r][i] = s;
                }
              }
            }
#pragma unroll
            for (int r = 0; r < RM; ++r) {
              if (wr0 + r >= np) break;
#pragma unroll
              for (int i = 0; i < KPL; ++i) {
                const int k = k0 + lane + 32 * i;
                if (k < H) share[((size_t)si * R + row0 + wr0 + r) * H + k] = acc[r][i];
              }
            }
          }
        }
      }
      __syncthreads();                             // the next tile overwrites h_s, g_s, dg
    }
    if (t > 0) {
      __threadfence();                             // the shares visible to every block
      grid.sync();
    }
  }
}

// the instances (dtype, U, TM); ops/lstm.py `_BWD_WIDE` mirrors them. In
// bfloat16 a warp's share of the recompute is at least two n8 tiles (4U / 8 / (8
// / (TM / 16)) >= 2): no (8, 32).
template <typename F>
int with_instance(int dtype, int U, int TM, F&& f) {
  using bf = __nv_bfloat16;
  using std::integral_constant;
#define BWD_INST(TY, UU, MM)                                                       \
  if (U == UU && TM == MM)                                                         \
    return f((TY*)nullptr, integral_constant<int, UU>{}, integral_constant<int, MM>{});
  if (dtype == 1) {
    BWD_INST(bf, 32, 64) BWD_INST(bf, 32, 32) BWD_INST(bf, 16, 64) BWD_INST(bf, 16, 32)
    BWD_INST(bf, 8, 64)
  } else if (dtype == 0) {
    BWD_INST(float, 16, 64) BWD_INST(float, 16, 32) BWD_INST(float, 8, 64) BWD_INST(float, 8, 32)
  }
#undef BWD_INST
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x_proj (T, R, 4H), hs/cs/dhs (T, R, H), w_hh
// (H, 4H) -> dx_proj (T, R, 4H); share float32 (2, H / units, R, H) and dc float32
// (R, H) scratch;
// all contiguous and 16-byte aligned on the current device, H % 8 == 0,
// units dividing H. The plan (units, tile rows, row groups, smem bytes) is
// ops/lstm.py `bwd_wide_plan`'s. Returns the cudaError_t of the launch (0 on
// success; cudaErrorCooperativeLaunchTooLarge when the grid is not co-resident).
extern "C" int lstm_bwd_wide_launch(int dtype, const void* xp, const void* hs, const void* cs,
                                    const void* dhs, const void* w_hh, void* dx, void* share,
                                    void* dc, int R, int Tn, int H, int units, int tile_rows,
                                    int groups, int smem, void* stream) {
  if (R <= 0 || Tn <= 0 || H <= 0 || H % 8 || H > 768 || units <= 0 || H % units || groups < 1 ||
      groups > R)
    return cudaErrorInvalidValue;
  return with_instance(dtype, units, tile_rows, [&](auto* ty, auto uu, auto mm) {
    using T = std::remove_pointer_t<decltype(ty)>;
    constexpr int U = decltype(uu)::value, TM = decltype(mm)::value;
    if (smem != smem_bytes<T>(U, TM, H)) return (int)cudaErrorInvalidValue;
    auto kernel = lstm_bwd_wide_kernel<T, U, TM>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    Args a{xp, hs, cs, dhs, w_hh, dx, static_cast<float*>(share), static_cast<float*>(dc),
           R, Tn, H, groups};
    void* args[] = {&a};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(groups * (H / U)),
                                    dim3(THREADS), args, smem, static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  });
}

// Blocks of the instance (dtype, units, tile rows) with smem bytes that an SM
// holds at once, into *blocks (the plan's co-residency).
extern "C" int lstm_bwd_wide_blocks_per_sm(int dtype, int units, int tile_rows, int smem,
                                           int* blocks) {
  return with_instance(dtype, units, tile_rows, [&](auto* ty, auto uu, auto mm) {
    using T = std::remove_pointer_t<decltype(ty)>;
    auto kernel = lstm_bwd_wide_kernel<T, decltype(uu)::value, decltype(mm)::value>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, smem);
  });
}
