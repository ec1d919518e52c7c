// Unidirectional LSTM scans over a projected input for wide hidden sizes
// (128 < H), for Hopper (sm_90a).
//
// Replaces, at those sizes, the TPU kernels of nvse_tpu/ops/pallas_lstm.py:
//   mode kScan     <- `_lstm_kernel` / `_lstm_kernel_unrolled`
//                     (launched by `_pallas_lstm_scan`, pallas_lstm.py:212)
//   mode kStateful <- `_lstm_kernel_stateful`
//                     (launched by `_pallas_lstm_scan_stateful`, pallas_lstm.py:297)
// csrc/lstm_scan.cu (one thread per gate column) takes H <= 128.
//
// Contract: that of csrc/lstm_scan.cu. x_proj (T, R, 4H) time-major ->
// hs (T, R, H) from zero state, or from the caller's (h0, c0) -> hs and cs;
// h rounded to the weight type as stored, and the product reads it back
// rounded (the inference rule; the residual-saving forward of
// csrc/lstm_wide.cu multiplies the unrounded h: the two differ in bfloat16
// only); cs is written only by the stateful entry; float32 or bfloat16.
//
// What bounds it and the design: csrc/lstm_grid.cuh, modes kScan and
// kStateful, with W_ih outside (x_proj comes projected): a block's shared
// memory holds the float32 W_hh column slice of its 8 units (H x 32 floats)
// and a staged tile of h_{t-1}; H / 8 blocks a row group, so H <= 768 takes 96
// blocks and one row group on a 132-SM card, H = 256 four row groups.
//
// Built with nvcc by nvse_tpu_torch/ops/_build.py into a shared library with
// plain C entries (lstm_scan_wide_launch, lstm_scan_stateful_wide_launch),
// loaded through ctypes.
#include "lstm_grid.cuh"

// dtype: 0 float32, 1 bfloat16. x_proj (T, R, 4H), w_hh (H, 4H), hs (T, R, H),
// c_state float32 (R, H) scratch, all contiguous and 16-byte aligned on the
// current device; H % 8 == 0. Each entry returns the cudaError_t of the launch
// (0 on success; cudaErrorCooperativeLaunchTooLarge when no grid of whole row
// groups is co-resident on this device).
extern "C" int lstm_scan_wide_launch(int dtype, const void* xp, const void* w_hh, void* hs,
                                     void* c_state, int R, int Tn, int H, void* stream) {
  lstm_grid::Args a{};
  a.x = xp;
  a.w_hh[0] = w_hh;
  a.out = hs;
  a.c_state = static_cast<float*>(c_state);
  a.R = R;
  a.Tn = Tn;
  a.H = H;
  return lstm_grid::launch_dtype<lstm_grid::kScan>(dtype, a, stream);
}

// + h0 / c0 (R, H) and cs (T, R, H).
extern "C" int lstm_scan_stateful_wide_launch(int dtype, const void* xp, const void* w_hh,
                                              const void* h0, const void* c0, void* hs, void* cs,
                                              void* c_state, int R, int Tn, int H, void* stream) {
  lstm_grid::Args a{};
  a.x = xp;
  a.w_hh[0] = w_hh;
  a.h0 = h0;
  a.c0 = c0;
  a.out = hs;
  a.cs = cs;
  a.c_state = static_cast<float*>(c_state);
  a.R = R;
  a.Tn = Tn;
  a.H = H;
  return lstm_grid::launch_dtype<lstm_grid::kStateful>(dtype, a, stream);
}
