// Fused-projection bidirectional LSTM for wide hidden sizes (128 < H), for
// Hopper (sm_90a).
//
// Replaces, at those sizes, the TPU kernel family of nvse_tpu/ops/pallas_lstm.py
// `lstm_scan_fused`: `_fused_kernel` (launched by `_pallas_lstm_fused`,
// pallas_lstm.py:815) and `_fused_kernel_unrolled` (launched by
// `_pallas_lstm_fused_unrolled`, pallas_lstm.py:727), one function at two TPU
// unroll factors. csrc/lstm_fused.cu (one thread per gate column) takes H <= 128.
// At the same sizes it also holds the per-step ablation variants of the TPU
// harness `build` / `_variant_kernel` (scripts/profile_lstm_step.py:99 / :44):
// this kernel with a compile-time STEP (lstm_cell.cuh), launched for one
// direction, behind scripts/profile_torch_lstm_step.py.
//
// Contract: that of csrc/lstm_fused.cu. x (R, T, C) -> out (R, T, 2H), both
// directions in one launch, zero state, gates_t = x_t @ W_ih + b + h_{t-1} @ W_hh
// computed inside the kernel at each step and accumulated in float32 from the
// input-type values; the backward direction at its original time index; h
// rounded to the weight type before the recurrent product; float32 or bfloat16.
//
// What bounds it and the design: csrc/lstm_grid.cuh, mode kFused. The block's
// shared memory holds the float32 column slices of W_ih and W_hh of its 8
// units, (C + H) x 32 floats, and a staged tile of up to 128 rows x 256 k:
// that takes C + H <= 1280 (the wrapper's limit), and both directions' H / 8
// slices of one row group must be co-resident (H <= 512 on 128 SMs).
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// plain C entries (lstm_fused_wide_launch, lstm_step_variant_wide_launch),
// loaded through ctypes.
#include "lstm_grid.cuh"

// dtype: 0 float32, 1 bfloat16. x (R, T, C), w_ih (C, 4H), b (4H), w_hh (H, 4H),
// out (R, T, 2H), c_state float32 (2, R, H) scratch, all contiguous and
// 16-byte aligned on the current device; H % 8 == 0, C % 4 == 0. Returns the
// cudaError_t of the launch (0 on success; cudaErrorCooperativeLaunchTooLarge
// when no grid of whole row groups is co-resident on this device).
extern "C" int lstm_fused_wide_launch(int dtype, const void* x, const void* w_ih_f,
                                      const void* w_ih_b, const void* b_f, const void* b_b,
                                      const void* w_hh_f, const void* w_hh_b, void* out,
                                      void* c_state, int R, int Tn, int C, int H, void* stream) {
  lstm_grid::Args a{};
  a.x = x;
  a.w_ih[0] = w_ih_f;
  a.w_ih[1] = w_ih_b;
  a.b[0] = b_f;
  a.b[1] = b_b;
  a.w_hh[0] = w_hh_f;
  a.w_hh[1] = w_hh_b;
  a.out = out;
  a.c_state = static_cast<float*>(c_state);
  a.R = R;
  a.Tn = Tn;
  a.C = C;
  a.H = H;
  return lstm_grid::launch_dtype<lstm_grid::kFused>(dtype, a, stream);
}

// The per-step ablation: one direction (the forward one) of the kernel above
// with step = lstm::Step (0 kFull, the production kernel, ... 4 kEmpty), its
// row groups those of a two-direction launch. x (R, T, C), w_ih (C, 4H), b (4H),
// w_hh (H, 4H), out (R, T, 2H) (columns [0, H) written), c_state float32 (R, H)
// scratch, as lstm_fused_wide_launch; kNoDot needs C == H.
extern "C" int lstm_step_variant_wide_launch(int dtype, int step, const void* x,
                                             const void* w_ih, const void* b, const void* w_hh,
                                             void* out, void* c_state, int R, int Tn, int C,
                                             int H, void* stream) {
  using namespace lstm_grid;
  Args a{};
  a.x = x;
  a.w_ih[0] = a.w_ih[1] = w_ih;
  a.b[0] = a.b[1] = b;
  a.w_hh[0] = a.w_hh[1] = w_hh;
  a.out = out;
  a.c_state = static_cast<float*>(c_state);
  a.R = R;
  a.Tn = Tn;
  a.C = C;
  a.H = H;
  a.ndir = 1;
  switch (step) {
    case lstm::kFull: return launch_dtype<kFused, lstm::kFull>(dtype, a, stream);
    case lstm::kNoInDma: return launch_dtype<kFused, lstm::kNoInDma>(dtype, a, stream);
    case lstm::kNoDot:
      return C == H ? launch_dtype<kFused, lstm::kNoDot>(dtype, a, stream) : cudaErrorInvalidValue;
    case lstm::kNoVpu: return launch_dtype<kFused, lstm::kNoVpu>(dtype, a, stream);
    case lstm::kEmpty: return launch_dtype<kFused, lstm::kEmpty>(dtype, a, stream);
    default: return cudaErrorInvalidValue;
  }
}
