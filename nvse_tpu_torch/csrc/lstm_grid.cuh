// The wide inference LSTM scans of csrc/lstm_scan_wide.cu (the unidirectional
// scans and the two-direction scan), for 128 < H and many rows, for Hopper
// (sm_90a).
//
// Contract, per row r and direction d (gate order i, f, g, o):
//   gates_t = x_proj[t] + h_{t-1} @ W_hh_d
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g);  h_t = sigmoid(o) * tanh(c_t)
// kScan:     x_proj (T, R, 4H) time-major, one direction, zero state -> hs (T, R, H).
// kStateful: the same from the caller's (h0, c0), each (R, H) -> hs and cs.
// kScanBidir: x_proj (T, 2R, 4H) time-major, zero state -> hs (T, 2R, H); rows
//            [d R, d R + R) scan with w_hh[d], both directions forward in time.
// Types: every tensor float32 or every tensor bfloat16; the state and every
// sum float32. h is rounded to the weight type as stored and the recurrent
// product reads it back rounded (the `_hdot` rule, pallas_lstm.py:36-43); c is
// carried in float32 and stored rounded.
//
// What bounds it. BSRNN-L (H = 256) runs the causal time scan at 272 rows x
// 1024 steps: 146 GFLOP, operations, not bytes (2.2 ms of the f32 peak), and
// a chain of 1024 dependent steps. W_hh of one direction is 1 MB in float32:
// no block's shared memory holds it.
//
// Design: the rows are split into row groups and the hidden units into
// slices of U = 8 units; a block owns one (direction, row group, unit slice).
// It keeps the float32 (H, 32) column slice of W_hh for its units' four gates
// in shared memory for the whole launch (32 KB at H = 256), computes all four
// gates of its units for every row of its group, so c stays with the thread
// that owns (row, unit) (in a float32 scratch only that thread touches), and
// writes h_t rounded into the output. At the next step every block of the
// group reads back the whole h_{t-1} of its rows from the output through L2
// (`__ldcg`: L1 is not coherent across SMs); one cooperative grid barrier
// separates the steps, so a grid that cannot be co-resident is a launch
// error, never a hang. The launcher takes as many row groups as fit one block
// an SM (4 for a scan at H = 256), at least 16 rows a group. kScanBidir runs
// both directions' blocks in one launch where they are co-resident (H <= 528
// on 132 SMs) and one launch a direction where not.
// Inside a block, 512 threads as 8 unit lanes x 64 row lanes: a thread owns
// one unit (its four gate columns, a float4 of the slice) and RM rows (1 or
// 2, so up to 128 rows a tile); a group's rows run as tiles, and each tile
// stages its rows of h_{t-1} in chunks of 256 k into shared memory as
// float32. The product is f32 FMAs on CUDA cores: per 4 k, 4 float4 weight
// reads and RM float4 row reads for 16 RM FMAs. The tensor-core product of
// csrc/lstm_fused_wide.cu and a barrier per row group are later work here.
#pragma once

#include <cooperative_groups.h>

#include "lstm_cell.cuh"

namespace lstm_grid {

namespace cg = cooperative_groups;
using namespace lstm;

constexpr int THREADS = 512;
constexpr int U = 8;                   // hidden units a block
constexpr int NC = 4 * U;              // its gate columns, unit-major: column = unit * 4 + gate
constexpr int TY = THREADS / U;        // row lanes
constexpr int KC = 256;                // k values of a staged chunk
constexpr int PITCH = KC + 4;          // floats a staged row (conflict-free float4 reads)
constexpr int MIN_GROUP_ROWS = 16;

enum Mode : int { kScan = 1, kStateful = 2, kScanBidir = 3 };

struct Args {
  const void* x;          // kScanBidir: (Tn, 2R, 4H); else x_proj (Tn, R, 4H)
  const void* w_hh[2];    // (H, 4H) of each direction (one for kScan, kStateful)
  const void* h0;         // kStateful: (R, H)
  const void* c0;         // kStateful: (R, H)
  void* out;              // kScanBidir: (Tn, 2R, H); else hs (Tn, R, H)
  void* cs;               // kStateful: (Tn, R, H)
  float* c_state;         // float32 (directions, R, H) scratch
  int R, Tn, H;
  int groups;             // row groups
  int dir0;               // kScanBidir: the first direction this launch runs
  int ndir;               // directions this launch runs (0: all of the mode's)
};

// four consecutive elements through L2, as floats (16-byte aligned for
// float32, 8-byte for bfloat16)
template <typename T> __device__ __forceinline__ float4 ldcg4(const T* p);
template <> __device__ __forceinline__ float4 ldcg4<float>(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
template <> __device__ __forceinline__ float4 ldcg4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 v = __ldcg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// a_s[r][0, kc) = src[r * stride + (0, kc)] as float32, rows r < np
template <typename T>
__device__ __forceinline__ void stage_tile(float* a_s, const T* src, size_t stride, int np,
                                           int kc) {
  const int per_row = kc / 4;
  for (int i = threadIdx.x; i < np * per_row; i += THREADS) {
    const int r = i / per_row, k = (i - r * per_row) * 4;
    *reinterpret_cast<float4*>(a_s + r * PITCH + k) = ldcg4<T>(src + (size_t)r * stride + k);
  }
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

// acc[i][gate] += sum over the chunk's kc k of a_s[ty * RM + i][k] * w_s[k][tx * 4 + gate]
template <int RM>
__device__ __forceinline__ void tile_product(float (&acc)[RM][4], const float* a_s,
                                             const float* w_s, int kc, int tx, int ty) {
  const float* a = a_s + ty * RM * PITCH;
  const float* w = w_s + tx * 4;
#pragma unroll 2
  for (int k = 0; k < kc; k += 4) {
    float4 wv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) wv[e] = *reinterpret_cast<const float4*>(w + (k + e) * NC);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(a + i * PITCH + k);
      fma4(acc[i], av.x, wv[0]);
      fma4(acc[i], av.y, wv[1]);
      fma4(acc[i], av.z, wv[2]);
      fma4(acc[i], av.w, wv[3]);
    }
  }
}

template <typename T, int MODE, int RM>
__global__ void __launch_bounds__(THREADS, 1) lstm_grid_kernel(const Args a) {
  constexpr bool STATEFUL = MODE == kStateful, TWO = MODE == kScanBidir;
  cg::grid_group grid = cg::this_grid();
  const int H = a.H, R = a.R, Tn = a.Tn, G = 4 * H;
  const int ns = H / U;                            // unit slices (H % 8 == 0)
  const int slice = blockIdx.x % ns, rest = blockIdx.x / ns;
  const int grp = rest % a.groups, dir = (TWO ? a.dir0 : 0) + rest / a.groups;
  const int Rs = TWO ? 2 * R : R;                  // row stride of x_proj and hs
  const size_t roff = TWO ? (size_t)dir * R : 0;   // the direction's first row
  const int u0 = slice * U;
  const int gr0 = (int)((long)R * grp / a.groups);
  const int gr = (int)((long)R * (grp + 1) / a.groups) - gr0;
  const int n_tile = (gr + TY * RM - 1) / (TY * RM);
  const int tid = threadIdx.x, tx = tid % U, ty = tid / U, unit = u0 + tx;

  const T* xin = static_cast<const T*>(a.x);
  const T* w_hh = static_cast<const T*>(a.w_hh[dir]);
  T* out = static_cast<T*>(a.out);                 // read back at the next step: no __restrict__
  float* cst = a.c_state + (size_t)dir * R * H;

  extern __shared__ float4 smem_f4[];
  float* w_s = reinterpret_cast<float*>(smem_f4);  // [H][NC]
  float* a_s = w_s + (size_t)H * NC;               // [TY * RM][PITCH]
  for (int i = tid; i < H * NC; i += THREADS) {
    const int k = i / NC, col = i - k * NC;
    w_s[i] = to_f<T>(w_hh[(size_t)k * G + (size_t)(col & 3) * H + u0 + (col >> 2)]);
  }
  // the first chunk's barrier publishes w_s; a scan's first step has no
  // chunk and reads none of it

  for (int n = 0; n < Tn; ++n) {
    const int t = n;
    for (int p = 0; p < n_tile; ++p) {
      const int pr0 = (int)((long)gr * p / n_tile);
      const int np = (int)((long)gr * (p + 1) / n_tile) - pr0;
      const int row0 = gr0 + pr0;                  // first row of the tile
      float acc[RM][4], xv[RM][4], c_prev[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {               // this thread's (row, unit) values, loaded early
        const int lr = ty * RM + i, row = row0 + lr;
        const bool on = lr < np;
        c_prev[i] = 0.0f;
        if (on && n > 0) c_prev[i] = cst[(size_t)row * H + unit];
        if (STATEFUL && on && n == 0) {
          c_prev[i] = to_f<T>(static_cast<const T*>(a.c0)[(size_t)row * H + unit]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][q] = 0.0f;
          xv[i][q] = on ? to_f<T>(xin[((size_t)t * Rs + roff + row) * G + q * H + unit]) : 0.0f;
        }
      }
      const bool act = ty * RM < np;               // the thread's first row is in the tile

      if (n > 0 || STATEFUL) {                     // h_{t-1} @ W_hh (h_{-1} = 0 without a state)
        const T* hsrc = n == 0 ? static_cast<const T*>(a.h0) + (size_t)row0 * H
                               : out + ((size_t)(t - 1) * Rs + roff + row0) * H;
        for (int k0 = 0; k0 < H; k0 += KC) {
          const int kc = min(KC, H - k0);
          __syncthreads();                         // the previous chunk's readers are done
          stage_tile(a_s, hsrc + k0, (size_t)H, np, kc);
          __syncthreads();
          if (act) tile_product<RM>(acc, a_s, w_s + (size_t)k0 * NC, kc, tx, ty);
        }
      }

#pragma unroll
      for (int i = 0; i < RM; ++i) {               // the cell of (row, unit)
        const int lr = ty * RM + i, row = row0 + lr;
        if (lr >= np) continue;
        float gt[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) gt[q] = acc[i][q] + xv[i][q];
        const float c = sigmoid(gt[1]) * c_prev[i] + sigmoid(gt[0]) * tanhf(gt[2]);
        const float h = sigmoid(gt[3]) * tanhf(c);
        const size_t o = ((size_t)t * Rs + roff + row) * H + unit;
        out[o] = from_f<T>(h);
        if (STATEFUL) static_cast<T*>(a.cs)[o] = from_f<T>(c);
        cst[(size_t)row * H + unit] = c;
      }
      // the next tile's staging sits behind its own barrier
    }
    if (n + 1 < Tn) {
      __threadfence();                             // h_t visible to every block before the barrier
      grid.sync();
    }
  }
}

// Launches lstm_grid_kernel<T, MODE, RM> if its shared memory fits, its grid
// is co-resident and (for RM = 2) a row group has more rows than row lanes;
// sets *launched when it tried. The row groups of a kScanBidir launch of one
// direction are its own.
template <typename T, int MODE, int RM>
cudaError_t try_launch(const Args& a0, int n_sm, int max_smem, cudaStream_t stream,
                       bool* launched) {
  const int ndir = a0.ndir ? a0.ndir : MODE == kScanBidir ? 2 : 1;   // directions this launch runs
  const size_t smem = sizeof(float) * ((size_t)a0.H * NC + (size_t)TY * RM * PITCH);
  if (smem > (size_t)max_smem) return cudaSuccess;
  auto kernel = lstm_grid_kernel<T, MODE, RM>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return e;
  const int per_group = ndir * (a0.H / U);
  const int max_groups = per_sm * n_sm / per_group;
  if (max_groups < 1) return cudaSuccess;
  Args a = a0;
  a.groups = min(max_groups, (a.R + MIN_GROUP_ROWS - 1) / MIN_GROUP_ROWS);
  if (RM > 1 && (a.R + a.groups - 1) / a.groups <= TY) return cudaSuccess;   // one row a lane
  *launched = true;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                  dim3(a.groups * ndir * (a0.H / U)), dim3(THREADS), args,
                                  smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Picks RM (2 where a row group has more rows than row lanes and the larger
// staged tile fits, else 1) and the row groups, and launches. Returns the
// cudaError_t of the launch; cudaErrorCooperativeLaunchTooLarge when no grid
// of whole row groups is co-resident on this device.
template <typename T, int MODE>
int launch(const Args& a, cudaStream_t stream) {
  if (a.R <= 0 || a.Tn <= 0 || a.H <= 0 || a.H % U) return cudaErrorInvalidValue;
  int dev = 0, n_sm = 0, max_smem = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if ((e = max_dynamic_smem(&max_smem)) != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  bool launched = false;
  e = try_launch<T, MODE, 2>(a, n_sm, max_smem, stream, &launched);
  if (e != cudaSuccess || launched) return e;
  e = try_launch<T, MODE, 1>(a, n_sm, max_smem, stream, &launched);
  if (e != cudaSuccess || launched) return e;
  return cudaErrorCooperativeLaunchTooLarge;
}

template <int MODE>
int launch_dtype(int dtype, const Args& a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, MODE>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16, MODE>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace lstm_grid
