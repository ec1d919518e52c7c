// The wide inference LSTM recurrence shared by csrc/lstm_fused_wide.cu (the
// fused bidirectional LSTM) and csrc/lstm_scan_wide.cu (the unidirectional
// scans), for 128 < H and many rows, for Hopper (sm_90a).
//
// Contract, per row r and direction d (gate order i, f, g, o):
//   gates_t = [x_t @ W_ih_d + b_d | x_proj[t]] + h_{t-1} @ W_hh_d
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g);  h_t = sigmoid(o) * tanh(c_t)
// kFused:    x (R, T, C) batch-first, both directions, zero state; the backward
//            direction walks t = T-1 .. 0 and writes h at its original time index
//            into columns [H, 2H) of out (R, T, 2H).
// kScan:     x_proj (T, R, 4H) time-major, one direction, zero state -> hs (T, R, H).
// kStateful: the same from the caller's (h0, c0), each (R, H) -> hs and cs.
// Types: every tensor float32 or every tensor bfloat16; the state and every
// sum float32. h is rounded to the weight type as stored and the recurrent
// product reads it back rounded (the `_hdot` rule, pallas_lstm.py:36-43); c is
// carried in float32 and stored rounded.
//
// What bounds it. BSRNN-L (C = H = 256) at a B = 8 x 1024 decode runs the
// fused BiLSTM at 272 rows x 1024 steps (the time BiLSTM) and 8192 x 34 (the
// band BiLSTM): each 584 GFLOP on 0.3-1.1 GB, operations, not bytes (8.7 ms of
// the f32 peak). The time BiLSTM is besides a chain of 1024 dependent steps,
// the band BiLSTM one of 34 steps over 8192 rows. W_ih and W_hh of one
// direction are 1 MB each in float32: no block's shared memory holds them.
//
// Design: the rows are split into row groups and the hidden units into
// slices of U = 8 units; a block owns one (direction, row group, unit slice).
// It keeps the float32 (C + H, 32) column slice of [W_ih; W_hh] for its units'
// four gates in shared memory for the whole launch (64 KB at C = H = 256),
// computes all four gates of its units for every row of its group, so c stays
// with the thread that owns (row, unit) (in a float32 scratch only that
// thread touches), and writes h_t rounded into the output. At the next step
// every block of the group reads back the whole h_{t-1} of its rows from the
// output through L2 (`__ldcg`: L1 is not coherent across SMs); one
// cooperative grid barrier separates the steps, so a grid that cannot be
// co-resident is a launch error, never a hang. The launcher takes as many row
// groups as fit one block an SM (2 for the fused BiLSTM at H = 256: 128
// blocks; 4 for a scan), at least 16 rows a group.
// Inside a block, 512 threads as 8 unit lanes x 64 row lanes: a thread owns
// one unit (its four gate columns, a float4 of the slice) and RM rows (1 or
// 2, so up to 128 rows a tile); a group's rows run as tiles, and each tile
// stages its rows of x_t, then of h_{t-1}, in chunks of 256 k into shared
// memory as float32. The product is f32 FMAs on CUDA cores: per 4 k, 4 float4
// weight reads and RM float4 row reads for 16 RM FMAs. x @ W_ih + b is
// computed inside the recurrence, tile by tile, never written to memory.
// Tensor cores (wgmma), TMA and a barrier per row group are later work.
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

enum Mode : int { kFused = 0, kScan = 1, kStateful = 2 };

struct Args {
  const void* x;          // kFused: x (R, Tn, C); else x_proj (Tn, R, 4H)
  const void* w_ih[2];    // kFused: (C, 4H) of each direction
  const void* b[2];       // kFused: (4H) of each direction
  const void* w_hh[2];    // (H, 4H) of each direction (one for the scans)
  const void* h0;         // kStateful: (R, H)
  const void* c0;         // kStateful: (R, H)
  void* out;              // kFused: (R, Tn, 2H); else hs (Tn, R, H)
  void* cs;               // kStateful: (Tn, R, H)
  float* c_state;         // float32 (directions, R, H) scratch
  int R, Tn, C, H;
  int groups;             // row groups
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
  constexpr bool FUSED = MODE == kFused, STATEFUL = MODE == kStateful;
  cg::grid_group grid = cg::this_grid();
  const int H = a.H, R = a.R, Tn = a.Tn, G = 4 * H;
  const int Cw = FUSED ? a.C : 0;                  // W_ih rows of the staged slice
  const int ns = H / U;                            // unit slices (H % 8 == 0)
  const int slice = blockIdx.x % ns, rest = blockIdx.x / ns;
  const int grp = rest % a.groups, dir = rest / a.groups;
  const int u0 = slice * U;
  const int gr0 = (int)((long)R * grp / a.groups);
  const int gr = (int)((long)R * (grp + 1) / a.groups) - gr0;
  const int n_tile = (gr + TY * RM - 1) / (TY * RM);
  const int tid = threadIdx.x, tx = tid % U, ty = tid / U, unit = u0 + tx;

  const T* xin = static_cast<const T*>(a.x);
  const T* w_ih = static_cast<const T*>(a.w_ih[dir]);
  const T* w_hh = static_cast<const T*>(a.w_hh[dir]);
  T* out = static_cast<T*>(a.out);                 // read back at the next step: no __restrict__
  float* cst = a.c_state + (size_t)dir * R * H;

  extern __shared__ float4 smem_f4[];
  float* w_s = reinterpret_cast<float*>(smem_f4);  // [Cw + H][NC]
  float* b_s = w_s + (size_t)(Cw + H) * NC;        // [NC]
  float* a_s = b_s + NC;                           // [TY * RM][PITCH]
  for (int i = tid; i < (Cw + H) * NC; i += THREADS) {
    const int k = i / NC, col = i - k * NC;
    const size_t src = (size_t)(col & 3) * H + u0 + (col >> 2);
    w_s[i] = to_f<T>(k < Cw ? w_ih[(size_t)k * G + src] : w_hh[(size_t)(k - Cw) * G + src]);
  }
  if (FUSED && tid < NC) {
    b_s[tid] = to_f<T>(static_cast<const T*>(a.b[dir])[(size_t)(tid & 3) * H + u0 + (tid >> 2)]);
  }
  // the first chunk's barrier publishes w_s and b_s; a scan's first step has
  // no chunk and reads neither

  for (int n = 0; n < Tn; ++n) {
    const int t = dir ? Tn - 1 - n : n;
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
          xv[i][q] = 0.0f;
          if (!FUSED && on) xv[i][q] = to_f<T>(xin[((size_t)t * R + row) * G + q * H + unit]);
        }
      }
      const bool act = ty * RM < np;               // the thread's first row is in the tile

      if (FUSED) {                                 // x_t @ W_ih, chunk by chunk
        for (int k0 = 0; k0 < Cw; k0 += KC) {
          const int kc = min(KC, Cw - k0);
          __syncthreads();                         // the previous chunk's readers are done
          stage_tile(a_s, xin + ((size_t)row0 * Tn + t) * Cw + k0, (size_t)Tn * Cw, np, kc);
          __syncthreads();
          if (act) tile_product<RM>(acc, a_s, w_s + (size_t)k0 * NC, kc, tx, ty);
        }
      }
      if (n > 0 || STATEFUL) {                     // h_{t-1} @ W_hh (h_{-1} = 0 without a state)
        const T* hsrc;
        size_t stride;
        if (n == 0) {
          hsrc = static_cast<const T*>(a.h0) + (size_t)row0 * H;
          stride = H;
        } else if (FUSED) {
          const int tp = dir ? t + 1 : t - 1;
          hsrc = out + ((size_t)row0 * Tn + tp) * 2 * H + (size_t)dir * H;
          stride = (size_t)Tn * 2 * H;
        } else {
          hsrc = out + ((size_t)(t - 1) * R + row0) * H;
          stride = H;
        }
        for (int k0 = 0; k0 < H; k0 += KC) {
          const int kc = min(KC, H - k0);
          __syncthreads();
          stage_tile(a_s, hsrc + k0, stride, np, kc);
          __syncthreads();
          if (act) tile_product<RM>(acc, a_s, w_s + (size_t)(Cw + k0) * NC, kc, tx, ty);
        }
      }

#pragma unroll
      for (int i = 0; i < RM; ++i) {               // the cell of (row, unit)
        const int lr = ty * RM + i, row = row0 + lr;
        if (lr >= np) continue;
        float gt[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) gt[q] = acc[i][q] + (FUSED ? b_s[tx * 4 + q] : xv[i][q]);
        const float c = sigmoid(gt[1]) * c_prev[i] + sigmoid(gt[0]) * tanhf(gt[2]);
        const float h = sigmoid(gt[3]) * tanhf(c);
        if (FUSED) {
          out[((size_t)row * Tn + t) * 2 * H + (size_t)dir * H + unit] = from_f<T>(h);
        } else {
          const size_t o = ((size_t)t * R + row) * H + unit;
          out[o] = from_f<T>(h);
          if (STATEFUL) static_cast<T*>(a.cs)[o] = from_f<T>(c);
        }
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
// sets *launched when it tried.
template <typename T, int MODE, int RM>
cudaError_t try_launch(const Args& a0, int n_sm, int max_smem, cudaStream_t stream,
                       bool* launched) {
  const int dirs = MODE == kFused ? 2 : 1;
  const int kw = (MODE == kFused ? a0.C : 0) + a0.H;
  const size_t smem = sizeof(float) * ((size_t)kw * NC + NC + (size_t)TY * RM * PITCH);
  if (smem > (size_t)max_smem) return cudaSuccess;
  auto kernel = lstm_grid_kernel<T, MODE, RM>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return e;
  const int per_group = dirs * (a0.H / U);
  const int max_groups = per_sm * n_sm / per_group;
  if (max_groups < 1) return cudaSuccess;
  Args a = a0;
  a.groups = min(max_groups, (a.R + MIN_GROUP_ROWS - 1) / MIN_GROUP_ROWS);
  if (RM > 1 && (a.R + a.groups - 1) / a.groups <= TY) return cudaSuccess;   // one row a lane
  *launched = true;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(a.groups * per_group),
                                  dim3(THREADS), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Picks RM (2 where a row group has more rows than row lanes and the larger
// staged tile fits, else 1) and the row groups, and launches. Returns the
// cudaError_t of the launch; cudaErrorCooperativeLaunchTooLarge when no grid
// of whole row groups is co-resident on this device.
template <typename T, int MODE>
int launch(const Args& a, cudaStream_t stream) {
  if (a.R <= 0 || a.Tn <= 0 || a.H <= 0 || a.H % U || (MODE == kFused && (a.C <= 0 || a.C % 4)))
    return cudaErrorInvalidValue;
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
