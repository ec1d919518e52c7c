// Two independent unidirectional LSTM scans in one launch, for wide hidden
// sizes and few rows, for Hopper (sm_90a): one thread-block cluster a scan
// (and row tile) keeps that scan's W_hh resident and passes h between its
// blocks through distributed shared memory.
//
// Replaces the TPU kernel `_dualdot_kernel` of nvse_tpu/ops/pallas_lstm.py
// (launched by `_pallas_lstm_scan_bidir2`, pallas_lstm.py:499; public name
// `lstm_scan_bidir2`) where ops/lstm.py `bidir2_plan` takes this route: 128 < H
// with one wave of clusters (GCRN's H = 448 at 8 rows). Elsewhere the same
// wrapper launches the redesigned scans with two pointers: csrc/lstm_scan.cu for
// H <= 128, csrc/lstm_scan_wide.cu (mode kScanBidir) past what a cluster holds.
//
// Contract (time-major, gate order i, f, g, o), for each scan s in {a, b}:
//   gates_t = xp_s[t] + h_{t-1} @ W_s
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g);  h_t = sigmoid(o) * tanh(c_t)
//   h_{-1} = c_{-1} = 0                                        -> hs_s (T, R, H)
// Each scan runs forward in time with its own state and its own W_hh; a caller
// that wants a reversed direction flips its input and output. Types: xp, W and
// hs are all float32 or all bfloat16; the state and every sum are float32. h is
// rounded to the weight type before the recurrent product (the `_hdot` rule,
// pallas_lstm.py:36-43): the product reads h exactly as stored. The cell is
// exact (expf, tanhf), as the plain version. H % 8 == 0; pointers 16-byte
// aligned.
//
// What bounds it. GCRN's grouped LSTM is H = 448 over R = 8 rows and T = 1024
// steps: each step of a scan is a (R, H) @ (H, 4H) product of 12.8 MFLOP on a
// W_hh of 1.6 MB (bfloat16) or 3.2 MB (float32) that no block's shared memory
// holds, and the steps form a chain. The first layout spread the hidden units
// over the card and paid a grid-wide barrier and a round trip of h through L2
// at every step: 4.5 us a step against a product of a few hundred cycles.
//
// Design: a cluster of K = ceil(H / 32) blocks (up to 16, a non-portable size
// on an H100) owns one (scan, row tile); block `rank` owns 32 hidden units and
// keeps the W_hh columns of their four gates for the whole launch:
// - bfloat16 (tiles of 16 rows, one m16 tile): in REGISTERS, as the B fragments
//   of mma.sync m16n8k16 (float32 sums). Warp (kq, ng) of 4 x 4 runs k16 steps
//   [kq KQ, kq KQ + KQ) (KQ = ceil(ceil(H / 16) / 4)) for the 32 columns of n8
//   tiles 4 ng ... 4 ng + 3, h through ldmatrix from shared memory; the four
//   k-quarters' sums meet in shared memory. At H = 448 the slice is 112 KB: 56
//   registers a thread. H <= 512 (K <= 16).
// - float32 (tiles of 4 or 8 rows, true float32 FMAs, no TF32): the product
//   is bound by its shared-memory loads (h of the tile's rows for each k), so
//   the plan cuts few rows into as many tiles of 4 or more as one wave of
//   clusters holds (GCRN's 8 rows: 2 tiles of 4, 56 blocks). Warp (ks, half) of
//   8 x 2 owns a k-slice of KSL = ceil(H / 32) * 4 rows and 64 columns, 2 a lane;
//   the first 24 k of its slice in registers (48 a thread), the rest in shared
//   memory; h is kept [k][8 rows] so that a k is two broadcast float4 loads. At
//   H = 448 that is 128 KB of shared memory beside 96 KB of registers: H <= 448
//   fits an H100 (227 KB a block); the plan checks.
// Units past H (K 32 > H) have zero weights and are neither stored nor sent.
// A step: wait for h_{t-1} (each block's thread 0 arms an mbarrier with the
// bytes its peers will store; st.async from every peer completes them), the
// product, one block barrier, the cell of each (row, unit) by one thread (c in
// a register for the whole launch), h stored to hs, to this block's buffer and,
// packed 16 bytes a store (8 units of a row in bfloat16, 4 rows of a unit in
// float32), by st.async into every peer's buffer of the next step's parity;
// then a second block barrier. No grid barrier, and h never goes through L2.
// x_proj of the next steps is staged by cp.async into a ring of 3 steps.
// A peer stores h_t only after it read h_{t-1} from every block, so two
// buffers by step parity need no other ordering. Clusters are independent:
// more clusters than the card holds run in waves (the plan keeps one wave).
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// plain C entries (lstm_bidir2_launch, lstm_bidir2_step_launch,
// lstm_bidir2_max_clusters), loaded through ctypes.
#include <type_traits>

#include "lstm_cell.cuh"
#include "lstm_cluster.cuh"

namespace {

using namespace lstm;

constexpr int U = 32;                   // hidden units a block
constexpr int NC = 4 * U;               // its gate columns: column 4 unit + gate
constexpr int PP = NC + 4;              // pitch of a row of partial sums
constexpr int THREADS = 512;
constexpr int MAX_CLUSTER = 16;         // non-portable on an H100
constexpr int STAGES = 3;               // the x ring
constexpr int WR = 32;                  // float32: k of a thread's slice in registers

__host__ __device__ constexpr int up16(int v) { return (v + 15) / 16 * 16; }

// The tile rows and the layout of dynamic shared memory (each part 16-byte
// aligned); ops/lstm.py `_bidir2_cluster_smem` mirrors it.
//   bfloat16: h [2][16][HPP] (HPP = H padded to 16, + 8), partial sums
//             [2][4][16][PP] float32 (by step parity), x ring [3][16][4][U];
//   float32:  W slice [KSL - 32][8][NC] float32, h [2][KSL 8][8] (k-major),
//             partial sums [2][8][8][PP], x ring [3][4][8][U + 4].
template <typename T> struct Lay;
// bfloat16: the pitch of an h row (ldmatrix rows in distinct banks)
__host__ __device__ constexpr int hpp_of(int H) { return up16(H) + 8; }
template <> struct Lay<__nv_bfloat16> {
  static constexpr int ROWS = 16;
  __host__ __device__ static int hpp(int H) { return hpp_of(H); }
  __host__ __device__ static int w(int) { return 0; }
  __host__ __device__ static int h(int H) { return up16(2 * ROWS * hpp(H) * 2); }
  __host__ __device__ static int p() { return 2 * 4 * ROWS * PP * 4; }
  __host__ __device__ static int x() { return STAGES * ROWS * NC * 2; }
};
template <> struct Lay<float> {
  static constexpr int ROWS = 8;
  __host__ __device__ static int ksl(int H) { return ((H + 7) / 8 + 3) / 4 * 4; }
  __host__ __device__ static int w(int H) { return ksl(H) > WR ? (ksl(H) - WR) * 8 * NC * 4 : 0; }
  __host__ __device__ static int h(int H) { return 2 * ksl(H) * 8 * 8 * 4; }
  __host__ __device__ static int p() { return 2 * 8 * ROWS * PP * 4; }
  __host__ __device__ static int x() { return STAGES * 4 * ROWS * (U + 4) * 4; }
};
template <typename T>
__host__ __device__ int smem_bytes(int H) {
  using L = Lay<T>;
  return L::w(H) + L::h(H) + L::p() + L::x();
}

struct Args {
  const void* xp[2];      // (Tn, R, 4H) of each scan
  const void* w[2];       // (H, 4H) of each scan
  void* hs[2];            // (Tn, R, H) of each scan
  int R, Tn, H;
  int ntiles;             // row tiles a scan (balanced: R * j / ntiles); 2 ntiles clusters
};

// What a step computes (scripts/bench_torch_scan_plan.py --kernel bidir2 times each
// variant for the per-step split): kWhole, the production kernel; kNoProduct, no
// recurrent product (nor its partial sums); kNoExchange, h stored only into this
// block's own buffer (the peers' parts stale); kNoCell, h = z_o + c / 2 without
// the nonlinearities.
enum Split : int { kWhole = 0, kNoProduct = 1, kNoExchange = 2, kNoCell = 3 };

// NR: the rows a float32 tile holds at most (4 or 8: the product's rows);
// bfloat16 tiles hold up to 16 (one m16 tile).
template <typename T, int STEP, int NR>
__global__ void __launch_bounds__(THREADS, 1) lstm_bidir2_kernel(const Args a) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  using L = Lay<T>;
  constexpr int TR = L::ROWS;
  constexpr int E = 16 / sizeof(T);              // values a 16-byte copy
  const int H = a.H, G = 4 * H, Tn = a.Tn, R = a.R;
  const unsigned K = cluster_size(), rank = cluster_rank();
  const int cl = blockIdx.x / K, scan = cl & 1, tile = cl >> 1;
  const int row0 = (int)((long long)R * tile / a.ntiles);
  const int np = (int)((long long)R * (tile + 1) / a.ntiles) - row0;
  const int u0 = rank * U, own = max(0, min(U, H - u0));
  const T* xp = static_cast<const T*>(a.xp[scan]);
  const T* w = static_cast<const T*>(a.w[scan]);
  T* hs = static_cast<T*>(a.hs[scan]);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float4 smem_f4[];
  char* base = reinterpret_cast<char*>(smem_f4);
  float* w_s = reinterpret_cast<float*>(base);                       // float32 only
  T* h_s = reinterpret_cast<T*>(base + L::w(H));
  float* p_s = reinterpret_cast<float*>(base + L::w(H) + L::h(H));
  T* x_s = reinterpret_cast<T*>(base + L::w(H) + L::h(H) + L::p());
  const int HBUF = TR * hpp_of(H);               // values of one h buffer (bfloat16)
  const int KSL = BF ? 0 : Lay<float>::ksl(H);    // float32: k of a slice

  for (int i = tid; i < L::h(H) / 16; i += THREADS)
    reinterpret_cast<float4*>(h_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __shared__ alignas(8) unsigned long long h_bar[2];
  if (tid == 0) {
    mbar_init(&h_bar[0]);
    mbar_init(&h_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  auto wval = [&](int k, int col) -> T {        // W_hh[k][gate H + u0 + unit], column 4 unit + gate
    const int unit = u0 + (col >> 2), gate = col & 3;
    return k < H && unit < H ? w[(size_t)k * G + gate * H + unit] : from_f<T>(0.0f);
  };
  // the product's roles: bfloat16 warp (kq, ng), float32 warp (ks, half)
  const int g = lane >> 2, tq = lane & 3;
  const int KT = (H + 15) / 16, KQ = (KT + 3) / 4;
  const int kq = warp >> 2, ng = warp & 3;        // bfloat16
  const int ks = warp >> 1, colf = (warp & 1) * 64 + 2 * lane;   // float32: columns colf, colf + 1
  using Frag = std::conditional_t<BF, unsigned[8][4][2], float[WR][2]>;
  Frag wr;
  if constexpr (BF) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int k = 16 * (kq * KQ + kk) + 2 * tq + 8 * hi;
          const int col = ng * 32 + nt * 8 + g;
          const bool on = kk < KQ;
          wr[kk][nt][hi] = on ? (bits(wval(k, col)) | (bits(wval(k + 1, col)) << 16)) : 0u;
        }
  } else {
#pragma unroll
    for (int kk = 0; kk < WR; ++kk)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        wr[kk][e] = kk < KSL ? to_f<T>(wval(ks * KSL + kk, colf + e)) : 0.0f;
    for (int i = tid; i < (KSL > WR ? (KSL - WR) * 8 * NC : 0); i += THREADS) {
      const int kk = i / (8 * NC), sl = (i / NC) % 8, col = i % NC;
      w_s[i] = to_f<T>(wval(sl * KSL + WR + kk, col));
    }
  }

  // the x ring: step `item`'s 4 gates x U units of the tile's rows into stage
  // item % STAGES (bfloat16 [row][gate][unit], float32 [gate][row][unit + 4]);
  // units past H are not copied
  auto fetch = [&](int item) {
    if (item < Tn) {
      T* dst = x_s + (size_t)(item % STAGES) * (BF ? TR * NC : 4 * TR * (U + 4));
      const T* src = xp + ((size_t)item * R + row0) * G + u0;
      for (int i = tid; i < np * 4 * (U / E); i += THREADS) {
        const int r = i / (4 * (U / E)), q = (i / (U / E)) & 3, uu = (i % (U / E)) * E;
        if (u0 + uu < H)
          cp_async16(dst + (BF ? (r * 4 + q) * U : (q * TR + r) * (U + 4)) + uu,
                     src + (size_t)r * G + q * H + uu, 16);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < STAGES; ++s) fetch(s);
  cluster_arrive();                                // every block of the cluster has started
  cluster_wait();                                  // ... and set up its barriers
  cp_async_wait<STAGES - 1>();                     // step 0's x (this thread's copies)
  __syncthreads();

  // bytes of h that the blocks (this one too) store into this block's buffer a step
  const int senders = STEP == kNoExchange ? own : H;
  const unsigned expect = BF ? (unsigned)(np * senders * 2)
                             : (unsigned)(senders * 16 * ((np + 3) / 4));
  unsigned parity[2] = {0u, 0u};
  float c_reg = 0.0f;
  // the cell's (row, unit): bfloat16 (warp, lane); float32 (tid % 8, tid / 8) of 256
  const int cr = BF ? warp : (tid & 7), cu = BF ? lane : (tid >> 3);
  const bool cell_thread = (BF || tid < 256) && cr < np && cu < own;

  for (int n = 0; n < Tn; ++n) {
    T* hb = h_s + (size_t)(n & 1) * (BF ? HBUF : KSL * 64);          // h_{n-1}
    T* hw = h_s + (size_t)((n + 1) & 1) * (BF ? HBUF : KSL * 64);    // where h_n goes
    float* ps = p_s + (size_t)(n & 1) * (BF ? 4 : 8) * TR * PP;      // partial sums by parity
    if (n > 0) {                                   // h_{n-1} of every block has landed
      mbar_wait(&h_bar[n & 1], parity[n & 1]);
      parity[n & 1] ^= 1u;
    }
    const bool send = n + 1 < Tn;
    if (send && tid == 0) mbar_expect(&h_bar[(n + 1) & 1], expect);
    if (n > 0 && STEP != kNoProduct) {             // h_{-1} = 0: the first step has no product
      if constexpr (BF) {
        float acc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
        const int HPP = hpp_of(H);
        const T* arow = hb + (lane & 15) * HPP + (lane >> 4) * 8;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const int k16 = kq * KQ + kk;
          if (kk < KQ && k16 < KT) {               // warp-uniform
            unsigned af[4];
            ldsm_x4(af, arow + k16 * 16);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[nt], af, wr[kk][nt][0], wr[kk][nt][1]);
          }
        }
        float* pw = ps + (size_t)kq * TR * PP;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = ng * 32 + nt * 8 + 2 * tq;
          *reinterpret_cast<float2*>(pw + g * PP + col) = make_float2(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<float2*>(pw + (g + 8) * PP + col) = make_float2(acc[nt][2], acc[nt][3]);
        }
      } else {
        float acc[NR][2];
#pragma unroll
        for (int r = 0; r < NR; ++r) acc[r][0] = acc[r][1] = 0.0f;
        const float* hk = reinterpret_cast<const float*>(hb) + (size_t)ks * KSL * 8;
        auto fma8 = [&](const float* hr, float w0, float w1) {     // the tile's NR rows of h[k]
          float hv[NR];
#pragma unroll
          for (int q = 0; q < NR / 4; ++q) {
            const float4 h4 = *reinterpret_cast<const float4*>(hr + 4 * q);
            hv[4 * q] = h4.x;
            hv[4 * q + 1] = h4.y;
            hv[4 * q + 2] = h4.z;
            hv[4 * q + 3] = h4.w;
          }
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            acc[r][0] = fmaf(hv[r], w0, acc[r][0]);
            acc[r][1] = fmaf(hv[r], w1, acc[r][1]);
          }
        };
#pragma unroll
        for (int kk = 0; kk < WR; ++kk)
          if (kk < KSL) fma8(hk + kk * 8, wr[kk][0], wr[kk][1]);
        for (int kk = WR; kk < KSL; ++kk) {
          const float2 wv = *reinterpret_cast<const float2*>(w_s + ((kk - WR) * 8 + ks) * NC + colf);
          fma8(hk + kk * 8, wv.x, wv.y);
        }
        float* pw = ps + (size_t)ks * TR * PP + colf;
#pragma unroll
        for (int r = 0; r < NR; ++r)
          *reinterpret_cast<float2*>(pw + r * PP) = make_float2(acc[r][0], acc[r][1]);
      }
    }
    cp_async_wait<STAGES - 2>();                   // step n's x (this thread's copies)
    __syncthreads();                               // the partial sums, every thread's x; the
                                                   // last step's cells done (its x stage free)
    if (n > 0) fetch(n - 1 + STAGES);

    // the cell of (cr, cu): gates from the partial sums and x_proj
    float h = 0.0f;
    if (cell_thread) {
      const T* xb = x_s + (size_t)(n % STAGES) * (BF ? TR * NC : 4 * TR * (U + 4));
      float z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        z[q] = to_f<T>(xb[BF ? (cr * 4 + q) * U + cu : (q * TR + cr) * (U + 4) + cu]);
      if (n > 0 && STEP != kNoProduct) {
#pragma unroll
        for (int p = 0; p < (BF ? 4 : 8); ++p) {
          const float4 v = *reinterpret_cast<const float4*>(ps + ((size_t)p * TR + cr) * PP + 4 * cu);
          z[0] += v.x;
          z[1] += v.y;
          z[2] += v.z;
          z[3] += v.w;
        }
      }
      if (STEP == kNoCell) {
        h = z[3] + 0.5f * c_reg;
        c_reg = z[1];
      } else {
        const float c = sigmoid(z[1]) * c_reg + sigmoid(z[0]) * tanhf(z[2]);
        h = sigmoid(z[3]) * tanhf(c);
        c_reg = c;
      }
    }
    const T hv = from_f<T>(h);
    const unsigned bar = smem_u32(&h_bar[(n + 1) & 1]);
    // h_n into every block's buffer (this one's too), 16 bytes a store, on its
    // mbarrier: the chunk's G lanes each take the blocks p = lane % G, p + G, ...
    auto send_chunk = [&](const float4& v, unsigned at, int lane_in_chunk, int G) {
      for (unsigned p = lane_in_chunk; p < K; p += G)
        if (STEP != kNoExchange || p == rank)
          st_async4(cluster_map(at, p), v, cluster_map(bar, p));
    };
    if constexpr (BF) {
      if (cell_thread) hs[((size_t)n * R + row0 + cr) * H + u0 + cu] = hv;
      if (send) {                                  // 8 units of a row: lanes 8 c ... 8 c + 7
        const unsigned w0 = bits(hv) | (__shfl_down_sync(0xffffffffu, bits(hv), 1) << 16);
        const unsigned w1 = __shfl_down_sync(0xffffffffu, w0, 2);
        const unsigned w2 = __shfl_down_sync(0xffffffffu, w0, 4);
        const unsigned w3 = __shfl_down_sync(0xffffffffu, w0, 6);
        const int lead = lane & ~7;                // the chunk's first lane holds it
        const float4 v = make_float4(__uint_as_float(__shfl_sync(0xffffffffu, w0, lead)),
                                     __uint_as_float(__shfl_sync(0xffffffffu, w1, lead)),
                                     __uint_as_float(__shfl_sync(0xffffffffu, w2, lead)),
                                     __uint_as_float(__shfl_sync(0xffffffffu, w3, lead)));
        if (cr < np && (cu & ~7) < own)
          send_chunk(v, smem_u32(hw + cr * hpp_of(H) + u0 + (cu & ~7)), cu & 7, 8);
      }
    } else if (tid < 256) {                        // warps 0-7: 4 units x 8 rows a warp
      if (cell_thread) hs[((size_t)n * R + row0 + cr) * H + u0 + cu] = hv;
      if (send) {                                  // 4 rows of a unit: lanes 4 c ... 4 c + 3
        const int lead = lane & ~3;
        const float4 v = make_float4(__shfl_sync(0xffffffffu, h, lead),
                                     __shfl_sync(0xffffffffu, h, lead + 1),
                                     __shfl_sync(0xffffffffu, h, lead + 2),
                                     __shfl_sync(0xffffffffu, h, lead + 3));
        if ((cr & ~3) < np && cu < own)
          send_chunk(v, smem_u32(reinterpret_cast<float*>(hw) + (u0 + cu) * 8 + (cr & ~3)),
                     cr & 3, 4);
      }
    }
  }
}

template <typename T, int STEP, int NR>
cudaError_t configure(int K, int smem, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  auto kernel = lstm_bidir2_kernel<T, STEP, NR>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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

// the instances: bfloat16 tiles of up to 16 rows; float32 of up to 4 or 8
template <typename T, typename F>
int with_rows(int rows, F&& f) {
  using std::integral_constant;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (rows == 16) return f(integral_constant<int, 16>{});
  } else {
    if (rows == 4) return f(integral_constant<int, 4>{});
    if (rows == 8) return f(integral_constant<int, 8>{});
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int max_clusters(int H, int rows, int smem, int* clusters) {
  return with_rows<T>(rows, [&](auto nr) {
    constexpr int NR = decltype(nr)::value;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    const int K = (H + U - 1) / U;
    cudaError_t e = configure<T, kWhole, NR>(K, smem, cfg, attr);
    if (e != cudaSuccess) return (int)e;
    cfg.gridDim = dim3(K);
    return (int)cudaOccupancyMaxActiveClusters(clusters, lstm_bidir2_kernel<T, kWhole, NR>, &cfg);
  });
}

template <typename T, int STEP, int NR>
int launch(const Args& a, int smem, cudaStream_t stream) {
  const int K = (a.H + U - 1) / U;
  if (K > MAX_CLUSTER || a.H > 512 || a.ntiles < 1 || a.ntiles > a.R ||
      (a.R + a.ntiles - 1) / a.ntiles > NR || smem != smem_bytes<T>(a.H))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<T, STEP, NR>(K, smem, cfg, attr);
  if (e != cudaSuccess) return e;
  int fit = 0;
  cfg.gridDim = dim3(K);
  if ((e = cudaOccupancyMaxActiveClusters(&fit, lstm_bidir2_kernel<T, STEP, NR>, &cfg)) !=
      cudaSuccess)
    return e;
  if (fit < 1) return cudaErrorLaunchOutOfResources;
  cfg.gridDim = dim3(2 * a.ntiles * K);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, lstm_bidir2_kernel<T, STEP, NR>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int launch_step(int step, int rows, const Args& a, int smem, cudaStream_t stream) {
  return with_rows<T>(rows, [&](auto nr) {
    constexpr int NR = decltype(nr)::value;
    switch (step) {
      case kWhole: return launch<T, kWhole, NR>(a, smem, stream);
      case kNoProduct: return launch<T, kNoProduct, NR>(a, smem, stream);
      case kNoExchange: return launch<T, kNoExchange, NR>(a, smem, stream);
      case kNoCell: return launch<T, kNoCell, NR>(a, smem, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

int launch_any(int dtype, int step, const void* xp_a, const void* xp_b, const void* w_a,
               const void* w_b, void* hs_a, void* hs_b, int R, int Tn, int H, int ntiles,
               int rows, int smem, void* stream) {
  if (R <= 0 || Tn <= 0 || H <= 0 || H % 8) return cudaErrorInvalidValue;
  Args a{};
  a.xp[0] = xp_a;
  a.xp[1] = xp_b;
  a.w[0] = w_a;
  a.w[1] = w_b;
  a.hs[0] = hs_a;
  a.hs[1] = hs_b;
  a.R = R;
  a.Tn = Tn;
  a.H = H;
  a.ntiles = ntiles;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_step<float>(step, rows, a, smem, s);
  if (dtype == 1) return launch_step<__nv_bfloat16>(step, rows, a, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. xp_a / xp_b (T, R, 4H), w_a / w_b (H, 4H),
// hs_a / hs_b (T, R, H), all contiguous and 16-byte aligned on the current
// device; H % 8 == 0, H <= 512; ntiles row tiles a scan of at most `rows` rows
// (the instance: 16 in bfloat16; 4 or 8 in float32); smem the plan's bytes
// (ops/lstm.py `bidir2_plan`). Returns the cudaError_t of the launch (0 on success).
extern "C" int lstm_bidir2_launch(int dtype, const void* xp_a, const void* xp_b, const void* w_a,
                                  const void* w_b, void* hs_a, void* hs_b, int R, int Tn, int H,
                                  int ntiles, int rows, int smem, void* stream) {
  return launch_any(dtype, kWhole, xp_a, xp_b, w_a, w_b, hs_a, hs_b, R, Tn, H, ntiles, rows, smem,
                    stream);
}

// The same with a step variant (`Split`, 0-3) for the per-step split; the
// variants other than kWhole compute no LSTM.
extern "C" int lstm_bidir2_step_launch(int dtype, int step, const void* xp_a, const void* xp_b,
                                       const void* w_a, const void* w_b, void* hs_a, void* hs_b,
                                       int R, int Tn, int H, int ntiles, int rows, int smem,
                                       void* stream) {
  return launch_any(dtype, step, xp_a, xp_b, w_a, w_b, hs_a, hs_b, R, Tn, H, ntiles, rows, smem,
                    stream);
}

// Clusters of ceil(H / 32) blocks of the instance (rows) with smem bytes that
// the card holds at once, into *clusters (the plan's co-residency).
extern "C" int lstm_bidir2_max_clusters(int dtype, int H, int rows, int smem, int* clusters) {
  if (H <= 0 || H > 512) return cudaErrorInvalidValue;
  if (dtype == 0) return max_clusters<float>(H, rows, smem, clusters);
  if (dtype == 1) return max_clusters<__nv_bfloat16>(H, rows, smem, clusters);
  return cudaErrorInvalidValue;
}
