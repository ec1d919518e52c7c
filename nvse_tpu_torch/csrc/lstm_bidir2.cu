// Two independent unidirectional LSTM scans in one launch, for wide hidden
// sizes and few rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dualdot_kernel` of nvse_tpu/ops/pallas_lstm.py
// (launched by `_pallas_lstm_scan_bidir2`, pallas_lstm.py:499; public name
// `lstm_scan_bidir2`).
//
// Contract (time-major, gate order i, f, g, o), for each scan s in {a, b}:
//   gates_t = xp_s[t] + h_{t-1} @ W_s
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g);  h_t = sigmoid(o) * tanh(c_t)
//   h_{-1} = c_{-1} = 0                                        -> hs_s (T, R, H)
// Each scan runs in its own time order with its own state and its own W_hh;
// a caller that wants a reversed direction flips its input and output.
// Types: xp, W and hs are all float32 or all bfloat16; the state and every
// sum are float32. h is rounded to the weight type before the recurrent
// product (the `_hdot` rule, pallas_lstm.py:36-43).
//
// What bounds it. GCRN's grouped LSTM is H = 448 over R = batch rows (8 at
// the decode shape) and T = frames (1024): 26.3 GFLOP a launch on 153 MB
// (f32), operations on paper, but in fact a chain of T dependent steps, each
// a (R, H) @ (H, 4H) product of 12.8 MFLOP per scan against a W_hh of 3.2 MB
// (f32) that no block's shared memory holds. One block per row tile, the
// layout of the H <= 128 kernels, would pull that W_hh through one SM at
// every step.
//
// Design: the hidden units are spread over the card. A block owns U hidden
// units of one scan (U = 8 at H = 448: 56 blocks a scan, 112 in all), keeps
// its (H, 4U) slice of W_hh in shared memory for the whole scan, and computes
// all four gates of its units for every row, so c never leaves the block
// (it lives in a float32 scratch that only this block touches). Per step a
// block needs the whole h_{t-1} of its scan, which the other blocks wrote:
// it reads it back from hs[t-1] itself, which holds exactly the rounded h
// that the product must see, through L2 (`__ldcg`: L1 is not coherent across
// SMs), and one grid-wide barrier separates the steps. The launch is
// cooperative, so a grid that cannot be co-resident is a launch error and
// never a hang; the launcher picks the smallest U whose grid fits.
// Inside a block: 512 threads as KS k-slices x 32-padded gate columns; a
// thread accumulates its column over its k-slice for the 8 rows of a row
// tile (h broadcast from shared memory as float4), the partial sums meet in
// shared memory, and one thread per (row, unit) applies the cell. More than
// 8 rows run as several row tiles per step. x_proj of step t + 1 is
// prefetched into L2 while step t computes. CUDA cores in float32; tensor
// cores, W_hh in registers and a barrier per scan are later work.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// one plain C entry (lstm_bidir2_launch), loaded through ctypes.
#include <cooperative_groups.h>

#include "lstm_cell.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace lstm;

constexpr int RT = 8;          // rows per tile (accumulators per thread)
constexpr int THREADS = 512;

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

inline int padded_columns(int U) { return (4 * U + 31) & ~31; }

// dynamic shared memory of one block: h tile, partial sums, W_hh slice
template <typename T>
inline size_t smem_bytes(int H, int U) {
  const int ncp = padded_columns(U), ks = THREADS / ncp;
  return sizeof(float) * ((size_t)RT * H + (size_t)ks * RT * 4 * U) + sizeof(T) * (size_t)H * 4 * U;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bidir2_kernel(const T* __restrict__ xp_a, const T* __restrict__ xp_b,
                   const T* __restrict__ w_a, const T* __restrict__ w_b,
                   T* hs_a, T* hs_b, float* c_state, int R, int Tn, int H, int U) {
  cg::grid_group grid = cg::this_grid();
  constexpr int VEC = 16 / sizeof(T);          // h values per 16-byte load
  const int nb = (H + U - 1) / U;              // blocks per scan; gridDim.x == 2 * nb
  const int scan = blockIdx.x / nb;
  const int u0 = (blockIdx.x - scan * nb) * U;
  const T* __restrict__ xp = scan ? xp_b : xp_a;
  const T* __restrict__ w = scan ? w_b : w_a;
  T* hs = scan ? hs_b : hs_a;                  // read back at t - 1: no __restrict__
  float* cst = c_state + (size_t)scan * R * H;

  const int G = 4 * H, NC = 4 * U;
  const int NCP = (NC + 31) & ~31, KS = THREADS / NCP;
  const int tid = threadIdx.x;

  extern __shared__ float4 smem_f4[];
  float* h_s = reinterpret_cast<float*>(smem_f4);     // [RT][H]
  float* p_s = h_s + RT * H;                          // [KS][RT][NC]
  T* w_s = reinterpret_cast<T*>(p_s + KS * RT * NC);  // [H][NC], column = gate * U + unit

  for (int i = tid; i < H * NC; i += THREADS) {
    const int k = i / NC, col = i - k * NC;
    const int q = col / U, unit = u0 + col - q * U;
    w_s[i] = unit < H ? w[(size_t)k * G + q * H + unit] : from_f<T>(0.0f);
  }

  // product role: column pc over the k-chunks (of 4) [kc0, kc1)
  const int pks = tid / NCP, pc = tid - pks * NCP;
  const bool prod_on = pks < KS && pc < NC;
  const int kc0 = (int)((long)pks * (H / 4) / KS), kc1 = (int)((long)(pks + 1) * (H / 4) / KS);
  // cell role: (row cr of the tile, unit cu of the block)
  const int cr = tid / U, cu = tid - cr * U;
  const int unit = u0 + cu;
  const bool cell_thread = tid < RT * U && unit < H;
  __syncthreads();

  for (int t = 0; t < Tn; ++t) {
    for (int r0 = 0; r0 < R; r0 += RT) {
      const int row = r0 + cr;
      const bool cell_on = cell_thread && row < R;
      float xg[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c_prev = 0.0f;
      if (cell_on) {
        const T* x = xp + ((size_t)t * R + row) * G + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) xg[q] = to_f<T>(x[q * H]);
        if (t + 1 < Tn) {
#pragma unroll
          for (int q = 0; q < 4; ++q) prefetch_l2(x + (size_t)R * G + q * H);
        }
        if (t > 0) c_prev = cst[(size_t)row * H + unit];
      }

      if (t > 0) {                       // h_{-1} = 0: the first step has no product
        const int vec_per_row = H / VEC;
        for (int i = tid; i < RT * vec_per_row; i += THREADS) {
          const int rr = i / vec_per_row, kv = (i - rr * vec_per_row) * VEC;
          float* dst = h_s + rr * H + kv;
          if (r0 + rr < R) {
            load_h16(hs + ((size_t)(t - 1) * R + r0 + rr) * H + kv, dst);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) dst[e] = 0.0f;
          }
        }
        __syncthreads();

        if (prod_on) {
          float acc[RT];
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] = 0.0f;
          for (int kc = kc0; kc < kc1; ++kc) {
            const int k = kc * 4;
            float wv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) wv[e] = to_f<T>(w_s[(k + e) * NC + pc]);
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
          for (int r = 0; r < RT; ++r) p_s[(pks * RT + r) * NC + pc] = acc[r];
        }
        __syncthreads();
      }

      if (cell_on) {
        if (t > 0) {
          for (int s = 0; s < KS; ++s) {
            const float* p = p_s + (s * RT + cr) * NC + cu;
#pragma unroll
            for (int q = 0; q < 4; ++q) xg[q] += p[q * U];
          }
        }
        const float c = sigmoid(xg[1]) * c_prev + sigmoid(xg[0]) * tanhf(xg[2]);
        const float h = sigmoid(xg[3]) * tanhf(c);
        hs[((size_t)t * R + row) * H + unit] = from_f<T>(h);
        cst[(size_t)row * H + unit] = c;
      }
      // the next tile's h_s and p_s writes sit behind its own barriers
    }
    if (t + 1 < Tn) {
      __threadfence();                   // hs[t] visible to every block before the barrier
      grid.sync();
    }
  }
}

template <typename T>
int launch(const void* xp_a, const void* xp_b, const void* w_a, const void* w_b, void* hs_a,
           void* hs_b, float* c_state, int R, int Tn, int H, cudaStream_t stream) {
  int dev = 0, n_sm = 0, max_smem = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if ((e = max_dynamic_smem(&max_smem)) != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;

  // the smallest U (most blocks) whose whole grid is co-resident
  const int candidates[] = {8, 12, 16, 24, 32, 48, 64};
  for (int U : candidates) {
    const size_t smem = smem_bytes<T>(H, U);
    if (smem > (size_t)max_smem) continue;
    const int blocks = 2 * ((H + U - 1) / U);
    e = cudaFuncSetAttribute(lstm_bidir2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lstm_bidir2_kernel<T>, THREADS, smem);
    if (e != cudaSuccess) return e;
    if (blocks > per_sm * n_sm) continue;

    const T* xa = static_cast<const T*>(xp_a);
    const T* xb = static_cast<const T*>(xp_b);
    const T* wa = static_cast<const T*>(w_a);
    const T* wb = static_cast<const T*>(w_b);
    T* ha = static_cast<T*>(hs_a);
    T* hb = static_cast<T*>(hs_b);
    int u = U;
    void* args[] = {&xa, &xb, &wa, &wb, &ha, &hb, &c_state, &R, &Tn, &H, &u};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lstm_bidir2_kernel<T>), dim3(blocks),
                                    dim3(THREADS), args, smem, stream);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. xp_a / xp_b (T, R, 4H), w_a / w_b (H, 4H),
// hs_a / hs_b (T, R, H), c_state float32 (2, R, H) scratch, all contiguous on
// the current device; H % 8 == 0. Returns the cudaError_t of the launch (0 on
// success; cudaErrorCooperativeLaunchTooLarge when no split of the hidden
// units makes a grid that is co-resident on this device).
extern "C" int lstm_bidir2_launch(int dtype, const void* xp_a, const void* xp_b, const void* w_a,
                                  const void* w_b, void* hs_a, void* hs_b, void* c_state, int R,
                                  int Tn, int H, void* stream) {
  if (R <= 0 || Tn <= 0 || H <= 0 || H % 8) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* cst = static_cast<float*>(c_state);
  if (dtype == 0) return launch<float>(xp_a, xp_b, w_a, w_b, hs_a, hs_b, cst, R, Tn, H, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xp_a, xp_b, w_a, w_b, hs_a, hs_b, cst, R, Tn, H, s);
  return cudaErrorInvalidValue;
}
