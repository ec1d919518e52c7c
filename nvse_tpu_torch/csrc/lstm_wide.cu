// Residual-saving LSTM forward for wide hidden sizes (128 < H <= 768) and few
// rows, for Hopper (sm_90a).
//
// Replaces, at those sizes, the TPU kernel `lstm_fwd_hc` of
// nvse_tpu/ops/pallas_lstm_bwd.py: lstm_fwd_hc_wide_kernel <- `_fwd_kernel_hc` /
// `_fwd_kernel_hc_unrolled` (launched by `lstm_fwd_hc`, pallas_lstm_bwd.py:181).
// The reverse-time recurrence of `lstm_bwd` at those sizes is
// csrc/lstm_bwd_wide.cu's, its dW_hh the reduction of csrc/lstm_bwd.cu;
// csrc/lstm_bwd.cu's recurrences (one thread per gate column) stop at H = 128.
//
// Contract: that of csrc/lstm_bwd.cu's forward (time-major, one scan, zero
// initial state, gate order i, f, g, o):
//   gates_t = x_proj[t] + h_{t-1} @ W_hh
//   c_t = f * c_{t-1} + i * g;  h_t = o * tanh(c_t)       -> hs, cs (T, R, H)
// x_proj, W_hh, hs and cs are all float32 or all bfloat16. The state is
// float32 and the product multiplies the float32 h, not h rounded to the
// weight type (pallas_lstm_bwd.py:148); hs and cs are stored in the x_proj type.
//
// What bounds it. GCRN training: T = 65 steps over R = 16 rows (the batch) at
// H = 448, four scans a step: 1.67 GFLOP on 4.7 MB (f32), 0.025 ms of the f32
// peak. In fact each is a chain of 65 dependent steps, each a (16, 448) @
// (448, 1792) product against a W_hh of 3.2 MB (f32) that no block's shared
// memory holds, so a step's latency (grid barrier, exchange through L2) bounds
// it.
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
// The cell of (row, unit) stays in its block (c in a float32 scratch only that
// thread touches). The unrounded h goes to a float32 exchange buffer (2, R, H),
// double-buffered by step parity: every block reads all of h_{t-1} from slot
// (t - 1) & 1 through L2 and writes its units of h_t to slot t & 1, which no
// block reads before the next barrier. CUDA cores in float32; the layout of
// csrc/lstm_bwd_wide.cu (row groups x unit slices, tensor cores in bfloat16)
// is later work.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with a
// plain C entry (lstm_fwd_hc_wide_launch), loaded through ctypes.
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
// W_hh slice
inline size_t smem_floats(int H, int U) {
  const Slice s(U);
  return (size_t)RT * H + (size_t)s.KS * RT * s.NC + (size_t)H * s.NCS;
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

// The smallest U of UNITS whose grid of ceil(H / U) blocks fits this device at
// once; sets *U and *smem (bytes). cudaErrorCooperativeLaunchTooLarge if none.
template <typename K>
cudaError_t pick_units(K kernel, int H, int* U, size_t* smem) {
  int dev = 0, n_sm = 0, max_smem = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if ((e = max_dynamic_smem(&max_smem)) != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  for (int u : UNITS) {
    const size_t bytes = sizeof(float) * smem_floats(H, u);
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
  cudaError_t e = pick_units(lstm_fwd_hc_wide_kernel<T>, H, &U, &smem);
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
