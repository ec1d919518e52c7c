"""Per-step ablation variants of the fused LSTM kernels.

Counterpart of the TPU harness scripts/profile_lstm_step.py (`build`,
`_variant_kernel`, its `pallas_call` at :99): one direction of a fused
LSTM (x @ W_ih + h @ W_hh + b, then the cell) with one part of the step
taken out, so that timing each variant splits a step's time into its
parts. The modes, as `_variant_kernel` computes them at one step a grid
step:

    full      x[t] @ W_ih + h @ W_hh + b, then the cell
    no_indma  every step reads x[0] (the input block pinned)
    no_dot    gates = tile(x[t], 4) * 0.25 + b, which needs C == H
    no_vpu    c = g_i + 0.5 c; h = g_f + 0.5 c (no sigmoid, no tanh)
    empty     the zero state written at every step

On a CUDA tensor `lstm_step_variant` launches the port's production fused
kernel with the mode as a compile-time parameter (lstm_cell.cuh `Step`),
for the forward direction only, at the plan of a two-direction launch: that
of csrc/lstm_fused.cu for H <= 128 (its clusters, tiles and instance: ops/lstm.py
`fused_narrow_plan`) and that of csrc/lstm_fused_wide.cu for 128 < H <= 512
with C + H <= 1280 (its unit slice and row groups: `fused_wide_plan`). `full`
is the production kernel itself. Each variant keeps the launch, the step
loop with its synchronisation (the h exchange between a cluster's blocks in
the narrow kernel, a grid barrier in the wide one) and the output writes. On
a CPU tensor it runs `lstm_step_variant_plain`. Launches are counted in
`lstm_step_variant.launches`, per (T, R, C, H, mode, dtype) in
`lstm_step_variant.launches_by_shape` and per kernel source in
`lstm_step_variant.launches_by_kernel`.

Layouts, those of lstm_scan_fused: x (R, T, C) batch-first, w_ih (C, 4H),
w_hh (H, 4H), b (4H,), gate order (i, f, g, o), zero initial state; the
output is (R, T, H) in x's dtype.
"""
from __future__ import annotations

import torch

from .lstm import (_DTYPE_CODE, _FUSED_WIDE_MAX_H, _FUSED_WIDE_MAX_K, _MAX_H, _check_kernel_args,
                   _count, _fused_narrow_launch_plan, _fused_wide_launch_plan, _fused_wide_lib,
                   _kernel_lib, _raise_on, _reset_counts)

__all__ = ["MODES", "lstm_step_variant", "lstm_step_variant_plain"]

MODES = ("full", "no_indma", "no_dot", "no_vpu", "empty")   # lstm_cell.cuh Step, in order


def lstm_step_variant_plain(x, w_ih, w_hh, b, mode: str) -> torch.Tensor:
    """Plain version of the variant kernels: x (R, T, C) -> (R, T, H) in x's
    dtype. The fused kernels' numerics: the projection in float32 from the
    input-dtype values, the state float32, h rounded to the weight dtype
    before the recurrent product (the `_hdot` rule)."""
    _check_mode(mode, x.shape[-1], w_hh.shape[0])
    R, T, _ = x.shape
    H = w_hh.shape[0]
    hs = x.new_zeros(R, T, H)
    if mode == "empty":
        return hs
    xs = x.float()
    if mode == "no_indma":                  # the input pinned at x[:, 0]
        xs = xs[:, :1].expand_as(xs).contiguous()
    bias = b.float()
    w = w_hh.float()
    if mode == "no_dot":
        gx = xs.repeat(1, 1, 4) * 0.25 + bias
    else:
        gx = xs @ w_ih.float() + bias
    h = xs.new_zeros(R, H)
    c = torch.zeros_like(h)
    for t in range(T):
        gates = gx[:, t]
        if mode != "no_dot":
            gates = gates + h.to(w_hh.dtype).float() @ w
        if mode == "no_vpu":
            c = gates[:, :H] + 0.5 * c
            h = gates[:, H:2 * H] + 0.5 * c
        else:
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        hs[:, t] = h
    return hs


def _check_mode(mode: str, C: int, H: int) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "no_dot" and C != H:
        raise ValueError(f"no_dot tiles x over the 4 gates: it needs C == H, got C={C}, H={H}")


def _check_fused_shape(C: int, H: int, dtype: torch.dtype) -> None:
    """The variants are compile-time steps of the fused kernels and take what
    those take, unpadded: H <= 128 (csrc/lstm_fused.cu) or 128 < H <= 512 with
    C + H <= 1280 (csrc/lstm_fused_wide.cu), H % 8 == 0, C % 4 == 0, float32 or
    bfloat16."""
    if (H % 8 or C % 4 or H > _FUSED_WIDE_MAX_H or (H > _MAX_H and C + H > _FUSED_WIDE_MAX_K)
            or dtype not in (torch.float32, torch.bfloat16)):
        raise NotImplementedError(
            f"lstm_step_variant kernels handle H <= {_MAX_H} (csrc/lstm_fused.cu) and "
            f"{_MAX_H} < H <= {_FUSED_WIDE_MAX_H} with C + H <= {_FUSED_WIDE_MAX_K} "
            f"(csrc/lstm_fused_wide.cu), H % 8 == 0 and C % 4 == 0, in float32 or bfloat16; "
            f"got C={C}, H={H}, {dtype}")


def _kernel_source(H: int) -> str:
    return "lstm_fused" if H <= _MAX_H else "lstm_fused_wide"


def lstm_step_variant(x, w_ih, w_hh, b, mode: str) -> torch.Tensor:
    """x (R, T, C) -> (R, T, H): the variant `mode` of one fused LSTM
    direction. CPU tensors run lstm_step_variant_plain. CUDA tensors launch
    the variant kernel and get a view of its (R, T, 2H) output, of which the
    forward direction's columns are written; what the fused kernels do not
    take raises (`_check_fused_shape`). Inference only: the
    variants have no gradient."""
    if x.device.type == "cpu":
        return lstm_step_variant_plain(x, w_ih, w_hh, b, mode)
    return _launch_variant(x, w_ih, w_hh, b, mode)


def _launch_variant(x, w_ih, w_hh, b, mode: str) -> torch.Tensor:
    """Validate, then launch the variant kernel; raises, never falls back."""
    _check_mode(mode, x.shape[-1], w_hh.shape[0])
    _check_fused_shape(x.shape[-1], w_hh.shape[0], x.dtype)
    R, T, C, H = _check_kernel_args(x, w_ih, w_ih, b, b, w_hh, w_hh)
    source = _kernel_source(H)
    out = torch.empty(R, T, 2 * H, device=x.device, dtype=x.dtype)
    if R == 0 or T == 0:
        return out[..., :H]
    ptrs = [a.data_ptr() for a in (x, w_ih, b, w_hh, out)]
    step, dtype = MODES.index(mode), _DTYPE_CODE[x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if source == "lstm_fused_wide":
            # the plan of a two-direction launch, blocks per SM those of this variant
            plan = _fused_wide_launch_plan(x, C, H, step)
            # kernel scratch: the float32 c of each (row, unit)
            c_state = torch.empty(R, H, device=x.device, dtype=torch.float32)
            err = _fused_wide_lib().lstm_step_variant_wide_launch(
                dtype, step, *ptrs, c_state.data_ptr(), R, T, C, H, plan["units"],
                plan["tile_rows"], plan["groups"], plan["kc"], plan["stages"], plan["smem_bytes"],
                stream)
        else:
            # the plan of a two-direction launch, clusters those of this variant
            plan = _fused_narrow_launch_plan(x, C, H, step)
            err = _kernel_lib().lstm_step_variant_launch(
                dtype, step, *ptrs, R, T, C, H, plan["units"], plan["inst"], plan["ntiles"],
                plan["clusters"], plan["stages"], plan["smem_bytes"], stream)
    _raise_on(err, f"lstm_step_variant {mode} ({source})")
    _count(lstm_step_variant, (T, R, C, H, mode, str(x.dtype).replace("torch.", "")), source)
    return out[..., :H]


_reset_counts(lstm_step_variant)
