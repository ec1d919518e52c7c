// ConvTasNet's fused TCN block tail for Hopper (sm_90a).
//
// Replaces the TPU kernel of nvse_tpu/ops/pallas_tcn.py: `_tcn_kernel`,
// launched by `_pallas_tail` (pallas_tcn.py:136).
//
// Contract (channels-last, per batch element b, time step t, the gLN already
// folded into per-batch scale and shift (a, b2) by the caller):
//   n[t, k]   = c[t, k] * a[k] + b2[k]  for 0 <= t < T, and exactly 0 outside
//               (the conv's zero padding applies AFTER the norm: a tap outside
//               [0, T) reads 0, not b2)
//   q[t, k]   = n[t - d, k] w_dw[0, k] + n[t, k] w_dw[1, k] + n[t + d, k] w_dw[2, k]
//               + b_dw[k]                          (float32)
//   out[t, j] = sum_k round(q[t, k]) w_rs[k, j] + b_rs[j]   (float32 sums)
//   e[t, j]   = x[t, j] + out[t, j]                for j < Bc
//   skip[t, j - Bc] = out[t, j]                    for Bc <= j < 2 Bc
// round() is the rounding to w_rs's type (a no-op in float32). c, x, w_dw,
// b_dw, w_rs, b_rs, e and skip are all float32 or all bfloat16; a and b2 are
// float32. Shapes: c (B, T, H), x (B, T, Bc), w_dw (3, H), b_dw (H),
// w_rs (H, 2 Bc), b_rs (2 Bc), a and b2 (B, H), e and skip (B, T, Bc).
//
// What bounds it. At ConvTasNet's decode shape (B = 8, T = 32,735 encoder
// frames, H = 512, Bc = 128) one call is 68.7 GFLOP of res|skip product on
// 0.94 GB (float32): 1.03 ms of operations at the card's 67 TFLOP/s float32
// rate against 0.28 ms of bytes. In bfloat16 the bytes halve (0.14 ms) and
// the tensor cores would make it bytes-bound; this first version runs the
// product on CUDA cores in float32 in both types.
//
// Design (right and simple first): the TPU kernel's 128-row halo blocks are
// not carried over. A block owns 64 time steps of one batch element and 256
// output columns (all of res|skip at Bc = 128); 256 threads, each a 8 x 8
// register tile of float32 sums. It walks H in chunks of 32 channels: for each
// chunk it builds q (64 x 32) in shared memory from the three tap rows t - d,
// t, t + d of c, read from global memory (any dilation: the taps are plain
// loads, masked at the sequence ends), and stages the matching 32 x 256 slice
// of w_rs beside it; then every thread accumulates its tile. The epilogue adds
// b_rs and the residual and writes both outputs. Ragged ends in T, H and 2 Bc
// are masked. Tensor cores (wgmma), TMA and a pipelined ring of tiles are
// later work.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with a
// plain C entry (tcn_tail_launch), loaded through ctypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // time steps of a block
constexpr int BN = 256;       // output columns of a block
constexpr int BK = 32;        // channels of a chunk
constexpr int QS = BM + 4;    // q tile row stride: float4-aligned, fewer bank conflicts
constexpr int THREADS = 256;  // 8 row groups x 32 column groups

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
tcn_tail_kernel(const T* __restrict__ c, const T* __restrict__ x,
                const float* __restrict__ a, const float* __restrict__ b2,
                const T* __restrict__ w_dw, const T* __restrict__ b_dw,
                const T* __restrict__ w_rs, const T* __restrict__ b_rs,
                T* __restrict__ e_out, T* __restrict__ s_out,
                int Tn, int H, int Bc, int d) {
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int N2 = 2 * Bc;
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;

  __shared__ __align__(16) float q_s[BK * QS];   // [k][row]
  __shared__ __align__(16) float w_s[BK * BN];   // [k][column]

  const T* cb = c + (size_t)b * Tn * H;
  const float* ab = a + (size_t)b * H;
  const float* bb = b2 + (size_t)b * H;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < H; k0 += BK) {
    // q tile: each item is 4 consecutive channels of one row (coalesced reads of c)
    for (int p = tid; p < BM * (BK / 4); p += THREADS) {
      const int r = p / (BK / 4), kq = (p % (BK / 4)) * 4;
      const long long t = (long long)t0 + r;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + kq + i;
        float q = 0.0f;
        if (t < Tn && k < H) {
          const float ak = ab[k], bk = bb[k];
          float s = 0.0f;
#pragma unroll
          for (int tap = 0; tap < 3; ++tap) {
            const long long tt = t + (long long)(tap - 1) * d;
            const float n = (tt >= 0 && tt < Tn) ? to_f<T>(cb[(size_t)tt * H + k]) * ak + bk
                                                 : 0.0f;
            s += n * to_f<T>(w_dw[(size_t)tap * H + k]);
          }
          q = to_f<T>(from_f<T>(s + to_f<T>(b_dw[k])));   // rounded once to w_rs's type
        }
        q_s[(kq + i) * QS + r] = q;
      }
    }
    // w_rs slice: rows k0 .. k0 + BK, columns n0 .. n0 + BN
    for (int p = tid; p < BK * BN; p += THREADS) {
      const int kk = p / BN, n = p % BN;
      const int k = k0 + kk, col = n0 + n;
      w_s[p] = (k < H && col < N2) ? to_f<T>(w_rs[(size_t)k * N2 + col]) : 0.0f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 qa = *reinterpret_cast<const float4*>(&q_s[kk * QS + ty * 4]);
      const float4 qb = *reinterpret_cast<const float4*>(&q_s[kk * QS + 32 + ty * 4]);
      const float4 wa = *reinterpret_cast<const float4*>(&w_s[kk * BN + tx * 4]);
      const float4 wb = *reinterpret_cast<const float4*>(&w_s[kk * BN + 128 + tx * 4]);
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: rows ty*4 + i and 32 + ty*4 + i, columns tx*4 + j and 128 + tx*4 + j
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + (i - 4));
    if (t >= Tn) continue;
    const size_t row = (size_t)b * Tn + t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 128 + tx * 4 + (j - 4));
      if (col >= N2) continue;
      const float v = acc[i][j] + to_f<T>(b_rs[col]);
      if (col < Bc) {
        e_out[row * Bc + col] = from_f<T>(to_f<T>(x[row * Bc + col]) + v);
      } else {
        s_out[row * Bc + (col - Bc)] = from_f<T>(v);
      }
    }
  }
}

template <typename T>
int launch(const void* c, const void* x, const float* a, const float* b2, const void* w_dw,
           const void* b_dw, const void* w_rs, const void* b_rs, void* e, void* s, int B,
           int Tn, int H, int Bc, int d, cudaStream_t stream) {
  const dim3 grid((Tn + BM - 1) / BM, (2 * Bc + BN - 1) / BN, B);
  tcn_tail_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(x), a, b2, static_cast<const T*>(w_dw),
      static_cast<const T*>(b_dw), static_cast<const T*>(w_rs), static_cast<const T*>(b_rs),
      static_cast<T*>(e), static_cast<T*>(s), Tn, H, Bc, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0: float32, 1: bfloat16. Returns the CUDA error of the launch (0 on success).
// The caller checks shapes: B <= 65535, (2 Bc + 255) / 256 <= 65535, d >= 1.
extern "C" int tcn_tail_launch(int dtype, const void* c, const void* x, const float* a,
                               const float* b2, const void* w_dw, const void* b_dw,
                               const void* w_rs, const void* b_rs, void* e, void* s, int B,
                               int Tn, int H, int Bc, int d, cudaStream_t stream) {
  if (dtype == 0) return launch<float>(c, x, a, b2, w_dw, b_dw, w_rs, b_rs, e, s, B, Tn, H, Bc, d, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(c, x, a, b2, w_dw, b_dw, w_rs, b_rs, e, s, B, Tn, H, Bc, d, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
