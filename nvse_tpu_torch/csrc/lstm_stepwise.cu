// Step-wise LSTM recurrences for the shapes that no resident-weight kernel of
// csrc/ takes: H > 768, and the float16 inference scans at any H (float16
// training takes the resident training kernels up to H = 768). For Hopper (sm_90a).
//
// Replaces, past the resident kernels, the TPU kernels of
// nvse_tpu/ops/pallas_lstm.py (`_pallas_lstm_scan` :212, `_pallas_lstm_scan_stateful`
// :297, `_pallas_lstm_scan_bidir` :427, `_pallas_lstm_scan_bidir2` :499, and the
// scans `lstm_scan_fused` takes past its fused kernel, :815) and of
// nvse_tpu/ops/pallas_lstm_bwd.py (`lstm_fwd_hc` :181, `lstm_bwd` :339). The JAX
// functions compute these shapes on XLA's `lax.scan` (pallas_lstm.py:46-63,
// 324-338); the port computes them here.
//
// Contract (time-major, gate order i, f, g, o, state in float32):
//   forward (lstm_stepwise_fwd_launch), for each of `nscans` independent scans s:
//     gates_t = x_proj[s][t] + h~_{t-1} @ W_hh[s]          (float32 sums)
//     c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g);  h_t = sigmoid(o) tanh(c_t)
//     hs[s][t] = h_t and, where asked, cs[s][t] = c_t, stored in the input type;
//   h~ is h rounded to the weights' type where `round_h` (the inference scans'
//   `_hdot` rule, pallas_lstm.py:36-43), else the float32 h (the residual-saving
//   forward `lstm_fwd_hc`, pallas_lstm_bwd.py:139-159). The scan starts from the
//   float32 state the caller puts in hstate[0] and cstate (zeros, or a streaming
//   decoder's (h0, c0)); cstate ends holding c_{T-1}.
//   backward (lstm_stepwise_bwd_launch), t = T-1 ... 0, h_{-1} = c_{-1} = 0:
//     gates recomputed from h_{t-1} = hs[t-1] as stored; dh = dhs[t] + dh_carry;
//     dc = dc_carry + dh o (1 - tanh(c_t)^2);
//     dgates = [dc g i (1-i), dc c_{t-1} f (1-f), dc i (1-g^2), dh tanh(c_t) o (1-o)]
//     dx_proj[t] = dgates (stored in the input type);
//     dh_carry = dgates @ W_hh^T (the float32 dgates);  dc_carry = dc f
//   dW_hh is not summed here: ops/lstm.py runs the dW reduction of csrc/lstm_bwd.cu.
// x_proj, W_hh, hs, cs, dhs and dx_proj are all float32, all bfloat16 or all
// float16. Any R, T >= 1 and H >= 1 (the wrapper pads H to a multiple of 8).
//
// What bounds it. A step is a (R x H) . (H x 4H) product (two in the backward)
// that needs the whole previous step: T dependent steps. W_hh is 16 H^2 bytes in
// float32 (16.8 MB at H = 1024), too large for one block's or one cluster's
// shared memory past the resident kernels' H = 768 (ROADMAP "Held": a resident
// float32 instance at H = 1024 would need 279,552 of 232,448 bytes), but within
// the H100's 50 MB of L2. Each step re-reads W_hh from L2: at a few rows the
// step is bound by that read (16.8 MB at a few TB/s of L2, some microseconds),
// and by the launch of one kernel a step.
//
// Design, simple first: one launch a time step (the host loop in the C entry;
// a launch boundary is the grid-wide barrier the recurrence needs). A block owns
// a tile of BR = 16 rows x BU = 16 hidden units of one scan (blockIdx.z) and
// thread (row, unit) computes that unit's four gates: the product walks k in
// chunks of 32, the h rows and W_hh's four gate columns of the block's units
// staged in shared memory as float32, CUDA-core FMAs (no tensor cores, no TF32).
// The float32 h ping-pongs between two buffers by step parity (every block reads
// all of h_{t-1} and writes its units of h_t); c stays in one buffer, each
// (row, unit) read and written by its one thread. The backward's step first
// forms dh_carry = dgates_{t+1} @ W_hh^T for the block's units (dgates in a
// float32 ping-pong pair, W_hh's rows of the units staged in shared memory), then
// recomputes the gates as the forward, then the cell backward.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// plain C entries (lstm_stepwise_fwd_launch, lstm_stepwise_bwd_launch), loaded
// through ctypes; ops/lstm.py routes to it (`train_route`, `bidir2_plan`,
// `_fused_route`, the scans) by shape and dtype before any launch.
#include <type_traits>

#include "lstm_cell.cuh"

namespace {

using namespace lstm;

constexpr int BR = 16;          // rows of a tile
constexpr int BU = 16;          // hidden units of a tile
constexpr int THREADS = BR * BU;
constexpr int BK = 32;          // k of a staged chunk of the forward product
constexpr int BJ = 64;          // columns of a staged chunk of the carry product

__device__ __forceinline__ float tanh_f(float v) { return tanhf(v); }

// gates[g] = sum_k hrow[k] W[k][g H + u] for the block's (row, unit) of thread
// (ty, tx): h (R, H) read as float32 from `h` (float32 state, rounded to T where
// `round_h`) or from `hT` (stored in T), one of which is null.
template <typename T>
__device__ __forceinline__ void gate_product(float (&acc)[4], const float* __restrict__ h,
                                             const T* __restrict__ hT, bool round_h,
                                             const T* __restrict__ w, int R, int H, int r0,
                                             int u0, float (*hs_)[BK + 1], float (*ws_)[4 * BU]) {
  const int tid = threadIdx.x, ty = tid / BU, tx = tid % BU;
  for (int k0 = 0; k0 < H; k0 += BK) {
    for (int i = tid; i < BR * BK; i += THREADS) {
      const int r = i / BK, k = i % BK, row = r0 + r, kk = k0 + k;
      float v = 0.0f;
      if (row < R && kk < H) {
        if (hT) v = to_f<T>(hT[(size_t)row * H + kk]);
        else {
          v = h[(size_t)row * H + kk];
          if (round_h) v = to_f<T>(from_f<T>(v));
        }
      }
      hs_[r][k] = v;
    }
    for (int i = tid; i < BK * 4 * BU; i += THREADS) {
      const int k = i / (4 * BU), c = i % (4 * BU), g = c / BU, uu = c % BU;
      const int kk = k0 + k, u = u0 + uu;
      ws_[k][c] = kk < H && u < H ? to_f<T>(w[(size_t)kk * 4 * H + (size_t)g * H + u]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float hv = hs_[ty][k];
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g] = fmaf(hv, ws_[k][g * BU + tx], acc[g]);
    }
    __syncthreads();
  }
}

struct FwdArgs {
  const void* xp[2];   // x_proj[s] + t R 4H
  const void* w[2];    // W_hh[s] (H, 4H)
  void* hs[2];         // hs[s] + t R H
  void* cs[2];         // cs[s] + t R H, or null
  const float* h_in;   // (nscans, R, H) float32 h_{t-1}
  float* h_out;        // (nscans, R, H) float32 h_t
  float* c;            // (nscans, R, H) float32 c, updated in place
  int R, H, round_h;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) lstm_stepwise_fwd_kernel(const FwdArgs a) {
  __shared__ float hs_[BR][BK + 1];
  __shared__ float ws_[BK][4 * BU];
  const int s = blockIdx.z, R = a.R, H = a.H;
  const int r0 = blockIdx.x * BR, u0 = blockIdx.y * BU;
  const int tid = threadIdx.x, ty = tid / BU, tx = tid % BU;
  const size_t plane = (size_t)R * H;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  gate_product<T>(acc, a.h_in + s * plane, nullptr, a.round_h != 0, static_cast<const T*>(a.w[s]),
                  R, H, r0, u0, hs_, ws_);
  const int row = r0 + ty, u = u0 + tx;
  if (row >= R || u >= H) return;
  const T* xp = static_cast<const T*>(a.xp[s]) + (size_t)row * 4 * H + u;
  const float gi = acc[0] + to_f<T>(xp[0]), gf = acc[1] + to_f<T>(xp[H]);
  const float gg = acc[2] + to_f<T>(xp[2 * H]), go = acc[3] + to_f<T>(xp[3 * H]);
  const size_t o = s * plane + (size_t)row * H + u;
  const float c = sigmoid(gf) * a.c[o] + sigmoid(gi) * tanh_f(gg);
  const float h = sigmoid(go) * tanh_f(c);
  a.c[o] = c;
  a.h_out[o] = h;
  static_cast<T*>(a.hs[s])[(size_t)row * H + u] = from_f<T>(h);
  if (a.cs[s]) static_cast<T*>(a.cs[s])[(size_t)row * H + u] = from_f<T>(c);
}

struct BwdArgs {
  const void* xp;      // x_proj + t R 4H
  const void* h_prev;  // hs + (t - 1) R H, or null at t = 0
  const void* c_prev;  // cs + (t - 1) R H, or null at t = 0
  const void* c_t;     // cs + t R H
  const void* dh_t;    // dhs + t R H
  const void* w;       // W_hh (H, 4H)
  void* dx;            // dx_proj + t R 4H
  const float* dg_in;  // (R, 4H) float32 dgates of step t + 1, or null at t = T - 1
  float* dg_out;       // (R, 4H) float32 dgates of step t
  float* dc;           // (R, H) float32 dc carry, updated in place
  int R, H;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) lstm_stepwise_bwd_kernel(const BwdArgs a) {
  __shared__ float hs_[BR][BK + 1];
  __shared__ float ws_[BK][4 * BU];
  __shared__ float dg_[BR][BJ + 1];
  __shared__ float wu_[BU][BJ + 1];
  const int R = a.R, H = a.H, G = 4 * H;
  const int r0 = blockIdx.x * BR, u0 = blockIdx.y * BU;
  const int tid = threadIdx.x, ty = tid / BU, tx = tid % BU;
  const T* w = static_cast<const T*>(a.w);
  // dh_carry of (row, unit) = sum_j dgates_{t+1}[row][j] W_hh[unit][j]
  float carry = 0.0f;
  if (a.dg_in) {
    for (int j0 = 0; j0 < G; j0 += BJ) {
      for (int i = tid; i < BR * BJ; i += THREADS) {
        const int r = i / BJ, j = i % BJ, row = r0 + r, jj = j0 + j;
        dg_[r][j] = row < R && jj < G ? a.dg_in[(size_t)row * G + jj] : 0.0f;
      }
      for (int i = tid; i < BU * BJ; i += THREADS) {
        const int uu = i / BJ, j = i % BJ, u = u0 + uu, jj = j0 + j;
        wu_[uu][j] = u < H && jj < G ? to_f<T>(w[(size_t)u * G + jj]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int j = 0; j < BJ; ++j) carry = fmaf(dg_[ty][j], wu_[tx][j], carry);
      __syncthreads();
    }
  }
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (a.h_prev)
    gate_product<T>(acc, nullptr, static_cast<const T*>(a.h_prev), false, w, R, H, r0, u0, hs_,
                    ws_);
  const int row = r0 + ty, u = u0 + tx;
  if (row >= R || u >= H) return;
  const size_t ou = (size_t)row * H + u, og = (size_t)row * G + u;
  const T* xp = static_cast<const T*>(a.xp) + og;
  const float i = sigmoid(acc[0] + to_f<T>(xp[0])), f = sigmoid(acc[1] + to_f<T>(xp[H]));
  const float g = tanh_f(acc[2] + to_f<T>(xp[2 * H])), o = sigmoid(acc[3] + to_f<T>(xp[3 * H]));
  const float tc = tanh_f(to_f<T>(static_cast<const T*>(a.c_t)[ou]));
  const float cp = a.c_prev ? to_f<T>(static_cast<const T*>(a.c_prev)[ou]) : 0.0f;
  const float dh = to_f<T>(static_cast<const T*>(a.dh_t)[ou]) + carry;
  const float dcc = a.dg_in ? a.dc[ou] : 0.0f;
  const float dc = dcc + dh * o * (1.0f - tc * tc);
  const float d[4] = {dc * g * i * (1.0f - i), dc * cp * f * (1.0f - f), dc * i * (1.0f - g * g),
                      dh * tc * o * (1.0f - o)};
  T* dx = static_cast<T*>(a.dx);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    a.dg_out[og + (size_t)q * H] = d[q];
    dx[og + (size_t)q * H] = from_f<T>(d[q]);
  }
  a.dc[ou] = dc * f;
}

template <typename F>
int with_type(int dtype, F&& f) {
  if (dtype == 0) return f((float*)nullptr);
  if (dtype == 1) return f((__nv_bfloat16*)nullptr);
  if (dtype == 2) return f((__half*)nullptr);
  return cudaErrorInvalidValue;
}

dim3 grid_of(int R, int H, int nscans) {
  return dim3((R + BR - 1) / BR, (H + BU - 1) / BU, nscans);
}

bool bad_shape(int R, int Tn, int H) {
  return R < 1 || Tn < 1 || H < 1 || (R + BR - 1) / BR > 0x7fffffff || (H + BU - 1) / BU > 65535;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. nscans (1 or 2) scans of x_proj[s]
// (T, R, 4H) with W_hh[s] (H, 4H), advancing in the same launch each step, into
// hs[s] (T, R, H) and, where cs[s] is not null, cs[s] (T, R, H). hstate: float32
// (2, nscans, R, H), its first half holding the initial h (the scans' parity
// buffers); cstate: float32 (nscans, R, H) holding the initial c, and c_{T-1} at
// the end. round_h: round h to the weights' type before the product. One launch
// a step on `stream`; returns the CUDA error of the first launch that failed (0
// on success).
extern "C" int lstm_stepwise_fwd_launch(int dtype, int nscans, int round_h, const void* xp0,
                                        const void* xp1, const void* w0, const void* w1,
                                        void* hs0, void* hs1, void* cs0, void* cs1,
                                        float* hstate, float* cstate, int R, int Tn, int H,
                                        void* stream) {
  if (bad_shape(R, Tn, H) || nscans < 1 || nscans > 2) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(dtype, [&](auto* ty) {
    using T = std::remove_pointer_t<decltype(ty)>;
    const size_t step_x = (size_t)R * 4 * H, step_h = (size_t)R * H;
    const size_t half = (size_t)nscans * step_h;
    const void* xps[2] = {xp0, xp1};
    void* hss[2] = {hs0, hs1};
    void* css[2] = {cs0, cs1};
    for (int t = 0; t < Tn; ++t) {
      FwdArgs a{};
      for (int s = 0; s < nscans; ++s) {
        a.xp[s] = static_cast<const T*>(xps[s]) + t * step_x;
        a.w[s] = s ? w1 : w0;
        a.hs[s] = static_cast<T*>(hss[s]) + t * step_h;
        a.cs[s] = css[s] ? static_cast<void*>(static_cast<T*>(css[s]) + t * step_h) : nullptr;
      }
      a.h_in = hstate + (t & 1) * half;
      a.h_out = hstate + ((t + 1) & 1) * half;
      a.c = cstate;
      a.R = R;
      a.H = H;
      a.round_h = round_h;
      lstm_stepwise_fwd_kernel<T><<<grid_of(R, H, nscans), THREADS, 0, st>>>(a);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    return 0;
  });
}

// dtype as above. x_proj (T, R, 4H), hs / cs / dhs (T, R, H), w_hh (H, 4H) ->
// dx_proj (T, R, 4H); dgates: float32 (2, R, 4H) scratch (step parity), dc:
// float32 (R, H) scratch. One launch a step, t = T-1 ... 0; returns the CUDA
// error of the first launch that failed (0 on success).
extern "C" int lstm_stepwise_bwd_launch(int dtype, const void* xp, const void* hs,
                                        const void* cs, const void* dhs, const void* w,
                                        void* dx, float* dgates, float* dc, int R, int Tn,
                                        int H, void* stream) {
  if (bad_shape(R, Tn, H)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(dtype, [&](auto* ty) {
    using T = std::remove_pointer_t<decltype(ty)>;
    const size_t step_x = (size_t)R * 4 * H, step_h = (size_t)R * H;
    for (int t = Tn - 1; t >= 0; --t) {
      BwdArgs a{};
      a.xp = static_cast<const T*>(xp) + t * step_x;
      a.h_prev = t ? static_cast<const void*>(static_cast<const T*>(hs) + (t - 1) * step_h) : nullptr;
      a.c_prev = t ? static_cast<const void*>(static_cast<const T*>(cs) + (t - 1) * step_h) : nullptr;
      a.c_t = static_cast<const T*>(cs) + t * step_h;
      a.dh_t = static_cast<const T*>(dhs) + t * step_h;
      a.w = w;
      a.dx = static_cast<T*>(dx) + t * step_x;
      a.dg_in = t + 1 < Tn ? dgates + ((t + 1) & 1) * step_x : nullptr;
      a.dg_out = dgates + (t & 1) * step_x;
      a.dc = dc;
      a.R = R;
      a.H = H;
      lstm_stepwise_bwd_kernel<T><<<grid_of(R, H, 1), THREADS, 0, st>>>(a);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    return 0;
  });
}
