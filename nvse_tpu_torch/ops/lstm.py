"""LSTM recurrences: the fused bidirectional LSTM, the unidirectional
scans and their training path.

Counterpart of nvse_tpu/ops/pallas_lstm.py (`lstm_scan_fused`,
`lstm_scan`, `lstm_scan_stateful`, `lstm_scan_bidir2`, `lstm_scan_bidir`)
and nvse_tpu/ops/pallas_lstm_bwd.py (`lstm_fwd_hc`, `lstm_bwd`).

`lstm_scan_fused` is the switch between two routes:
  * inference (grad disabled, or no input requires grad): a fused kernel
    with x @ W_ih inside the recurrence, picked from (C, H, dtype) and the
    card by `_fused_route`: that of csrc/lstm_fused.cu (thread-block clusters
    that keep the weights in shared memory and pass h through distributed
    shared memory, tensor cores in bfloat16, the plan of `fused_narrow_plan`)
    for H <= 128 where a cluster of its weight slices fits the card, that of
    csrc/lstm_fused_wide.cu (row groups x slices of 8-32 hidden units over the
    card, tensor cores in bfloat16, the plan of `fused_wide_plan`) for
    128 < H <= 512 with C + H <= 1280; past them, up to H = 768 (HD-Demucs's
    bottleneck BiLSTM), and at H <= 128 where no cluster fits (C + H past
    about 590 on an H100), the decomposition the JAX function takes past its
    fused kernel's VMEM budget (pallas_lstm.py:864-880): x @ W_ih + b per
    direction as torch matmuls, then the two scans of lstm_scan_bidir2;
  * training: `_BiLSTMSaving`, an autograd Function mirroring the JAX
    custom_vjp's `_fused_fwd_saving` / `_fused_bwd_saved`
    (pallas_lstm.py:904-952): torch matmuls for x @ W_ih + b, then
    `lstm_fwd_hc` per direction saving hs and cs; its backward runs
    `lstm_bwd` per direction (the reverse-time recurrence and the dW_hh
    reduction) and torch matmuls for dx, dW_ih and db.
`lstm_scan` (the time LSTM of a causal config) switches the same way:
a scan kernel for inference, `_ScanSaving` (`lstm_fwd_hc` forward,
`lstm_bwd` backward, as the JAX custom_vjp at pallas_lstm.py:331-351)
under autograd. `lstm_scan_stateful` (streaming decode: the scan from a
caller's (h0, c0), returning hs and cs) has no gradient. Both scans pick
their kernel from H: csrc/lstm_scan.cu for H <= 128 (the cluster layout of
csrc/lstm_fused.cu without the input product: W_hh in registers, h by
st.async, tensor cores in bfloat16, the plan of `scan_narrow_plan`),
csrc/lstm_scan_wide.cu for 128 < H <= 768 (the layout of
csrc/lstm_bwd_wide.cu: row groups x slices of hidden units over the card,
W_hh resident, tensor cores in bfloat16, the plan of `scan_wide_plan`).
`lstm_scan_bidir2` (two independent scans in one launch: the grouped
LSTM of GCRN, H = 448 over batch rows) takes the route `bidir2_plan` picks
before the launch: for 128 < H the cluster kernel of csrc/lstm_bidir2.cu
(one thread-block cluster of up to 16 blocks a scan keeps its W_hh resident
and passes h through distributed shared memory; tensor cores in bfloat16)
where one wave of its clusters fits the card, else mode kScanBidir of
csrc/lstm_scan_wide.cu (to H = 768); for H <= 128 the two-direction cluster
scan of csrc/lstm_scan.cu; the two scan kernels through entries that take a
pointer for each scan. Under autograd it is `_Bidir2Saving` (`lstm_fwd_hc`
and `lstm_bwd` per scan, as the JAX custom_vjp at pallas_lstm.py:545-563).
`lstm_scan_bidir` (both directions of a BiLSTM as stacked rows of one
scan; no model calls it, as in the JAX package) is the kernel of
csrc/lstm_scan.cu for H <= 128 and of csrc/lstm_scan_wide.cu (mode
kScanBidir) for 128 < H <= 768; under autograd it is
`_BidirRecompute`, whose backward differentiates the plain version
recomputed (the JAX custom_vjp at pallas_lstm.py:959-981).
The training kernels pick theirs by `train_route` before any launch: for
H <= 128 the residual-saving forward as mode kFwdHc of csrc/lstm_scan.cu (the
plan of `scan_narrow_plan`; h multiplied unrounded, as hi + lo planes in
bfloat16) and the backward recurrence of csrc/lstm_bwd.cu (clusters of H / U
blocks, W_hh resident, the carry's shares exchanged in distributed shared
memory, tensor cores in bfloat16, the plan of `bwd_narrow_plan`); for
128 < H <= 768, and at H <= 128 where no cluster of a narrow kernel is held,
the forward as mode kFwdHc of csrc/lstm_scan_wide.cu and the backward of
csrc/lstm_bwd_wide.cu (row groups x slices of hidden units over the card,
W_hh resident, tensor cores in bfloat16, the plans of `scan_wide_plan` and
`bwd_wide_plan`); the dW_hh reduction of csrc/lstm_bwd.cu (a GEMM: tensor
cores in bfloat16, CUDA cores in float32, split over the rows by `dw_plan`)
takes both.
Past the resident kernels' H = 768, and in float16 at any H (no resident
kernel is built for it), every route takes the step-wise kernels of
csrc/lstm_stepwise.cu: one launch a time step with W_hh read from L2, the
forward (both scans of lstm_scan_bidir2 / lstm_scan_bidir in each step's launch;
h rounded to the weights' type for the inference scans, not for lstm_fwd_hc)
and the reverse-time backward (`_stepwise`, `stepwise_plan`); dW_hh stays
csrc/lstm_bwd.cu's reduction (tensor cores in bfloat16 and float16).
The kernels take H % 8 == 0 (and the fused ones C % 4 == 0): on a CUDA tensor
each wrapper zero-pads H to a multiple of 8 and C to one of 4 once at its
entry (`pad_lstm_args`) and slices its results back (`slice_lstm_results`);
a padded unit's W_hh row and W_ih column are zero, so its h and c stay 0 and
its gradients are 0, and the routes pick on the padded shape. Launches are
counted at the caller's shape.
Every wrapper launches its CUDA kernel on a CUDA tensor or raises, and
runs its plain PyTorch version only on a CPU tensor. The inference entries
of lstm_scan_fused (without `lengths`), lstm_scan and lstm_scan_bidir2 (its
route and plan not given) call registered operators (ops/library.py:
`nvse_torch::lstm_scan_fused`, `::lstm_scan`, `::lstm_scan_bidir2`), which
dispatch on the tensor's device to the routes below or to the plain
versions, so that a torch.export graph holds each as one node. Each counts its
launches in `<wrapper>.launches`, per shape in
`<wrapper>.launches_by_shape` and per kernel source (the `csrc/<name>.cu`
stem) in `<wrapper>.launches_by_kernel`, so that a run shows which kernel
ran.

Layouts follow the JAX package, in float32, bfloat16 or float16: x (B, T, C) batch-first, w_ih (C, 4H),
w_hh (H, 4H), b (4H,) = b_ih + b_hh, gate order (i, f, g, o); the
output is (B, T, 2H) with the forward direction in [:H] and the
backward direction, at its original time index, in [H:]. The scans and
the training kernels are time-major: x_proj (T, R, 4H), h0 / c0 (R, H),
hs / cs / dhs (T, R, H).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

__all__ = ["lstm_bwd", "lstm_bwd_plain", "lstm_dw_hh", "lstm_dw_hh_plain", "lstm_fwd_hc",
           "lstm_fwd_hc_plain", "lstm_scan", "lstm_scan_fused", "lstm_scan_fused_plain",
           "lstm_scan_bidir", "lstm_scan_bidir_plain", "lstm_scan_bidir2", "bidir2_plan",
           "lstm_scan_bidir2_plain", "lstm_scan_plain", "lstm_scan_stateful",
           "lstm_scan_stateful_plain", "pad_lstm_args", "prefix_reversal", "slice_lstm_results"]

_MAX_H = 128                    # lstm_fused.cu, lstm_scan.cu, lstm_bwd.cu: a cluster's
                                # blocks hold the weights
_WIDE_MAX_H = 768               # lstm_bwd_wide.cu, lstm_scan_wide.cu: hidden units
                                # spread over the card (and lstm_scan_bidir2's routes)
# lstm_fused_wide.cu: both directions' H / 8 blocks co-resident on 128 SMs, and the
# float32 (C + H, 32) weight slice of 8 units beside its staging ring in 227 KB
_FUSED_WIDE_MAX_H, _FUSED_WIDE_MAX_K = 512, 1280
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ITEM = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}      # bytes an element
# the kernels take H a multiple of 8 and (the fused ones) C of 4: the wrappers pad to them
_H_ALIGN, _C_ALIGN = 8, 4
# csrc/lstm_stepwise.cu: one launch a step, W_hh read from L2; every wrapper's route
# past _WIDE_MAX_H and in float16 (`_stepwise`)
_STEPWISE = "lstm_stepwise"
# the csrc/<stem>.cu whose kernel each wrapper launches: (H <= _MAX_H, H > _MAX_H)
# (lstm_scan_bidir2's is the route `bidir2_plan` picks)
_SOURCES = {"lstm_scan_fused": ("lstm_fused", "lstm_fused_wide"),
            "lstm_scan": ("lstm_scan", "lstm_scan_wide"),
            "lstm_scan_stateful": ("lstm_scan", "lstm_scan_wide"),
            "lstm_fwd_hc": ("lstm_scan", "lstm_scan_wide"),
            "lstm_bwd": ("lstm_bwd", "lstm_bwd_wide"),
            "lstm_dw_hh": ("lstm_bwd", "lstm_bwd"),
            "lstm_scan_bidir": ("lstm_scan", "lstm_scan_wide")}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _stepwise(H: int, dtype: torch.dtype | None) -> bool:
    """Whether a recurrence at H (padded to a multiple of 8) in dtype takes the
    step-wise kernel of csrc/lstm_stepwise.cu: past the resident kernels'
    H = 768, and in float16, which no resident kernel is built for."""
    return dtype == torch.float16 or _round_up(H, _H_ALIGN) > _WIDE_MAX_H


def _kernel_source(name: str, H: int, dtype: torch.dtype | None = None) -> str:
    """The csrc/<stem>.cu stem of the kernel that the wrapper `name` launches at H
    (padded to a multiple of 8) in dtype."""
    if name != "lstm_dw_hh" and _stepwise(H, dtype):
        return _STEPWISE
    return _SOURCES[name][_round_up(H, _H_ALIGN) > _MAX_H]


# ---------------------------------------------------------------------------
# padding: the kernels take H % 8 == 0 and C % 4 == 0; on CUDA tensors each
# wrapper zero-pads its arguments to them once at its entry and slices its results
# back. Exact: a padded unit's W_hh row and W_ih column are zero, so from a zero
# state its gates are 0 (i = f = o = 1/2, g = 0) and its h and c stay 0, it feeds
# nothing into the real units, and its gradients are 0.
# ---------------------------------------------------------------------------

def _pad_last(t: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(t, (0, n - t.shape[-1])) if n != t.shape[-1] else t


def _pad_gates(t: torch.Tensor, H: int, Hp: int) -> torch.Tensor:
    """(..., 4H) in gate blocks i, f, g, o -> (..., 4Hp), each block zero-padded."""
    lead = t.shape[:-1]
    return F.pad(t.reshape(*lead, 4, H), (0, Hp - H)).reshape(*lead, 4 * Hp)


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(t, (0, 0, 0, n - t.shape[0]))


_PAD = {
    "x": lambda t, H, Hp, C, Cp: _pad_last(t, Cp),                        # (..., C)
    "w_ih": lambda t, H, Hp, C, Cp: _pad_rows(_pad_gates(t, H, Hp), Cp),  # (C, 4H)
    "gates": lambda t, H, Hp, C, Cp: _pad_gates(t, H, Hp),                # (..., 4H): x_proj, b
    "w_hh": lambda t, H, Hp, C, Cp: _pad_rows(_pad_gates(t, H, Hp), Hp),  # (H, 4H)
    "w_stack": lambda t, H, Hp, C, Cp: torch.cat([_PAD["w_hh"](w, H, Hp, C, Cp)
                                                  for w in (t[:H], t[H:])]),   # (2H, 4H)
    "hidden": lambda t, H, Hp, C, Cp: _pad_last(t, Hp),                   # (..., H): hs, h0
}


def lstm_padding(H: int, C: int | None = None) -> tuple:
    """(Hp, Cp): H rounded up to a multiple of 8, C (None: no input) to one of 4."""
    return _round_up(H, _H_ALIGN), None if C is None else _round_up(C, _C_ALIGN)


def pad_lstm_args(args, roles, H: int, C: int | None = None) -> tuple:
    """The arguments of an LSTM kernel zero-padded to Hp, Cp = `lstm_padding`(H, C),
    each by its role: "x" (..., C) along C; "w_ih" (C, 4H) along its rows and each
    gate block; "gates" (..., 4H: x_proj, a bias, dx_proj) each gate block; "w_hh"
    (H, 4H) its rows and each gate block; "w_stack" (2H, 4H) each half as w_hh;
    "hidden" (..., H: hs, cs, dhs, h0, c0) along H. A pure function: the CPU tests
    run it around the plain versions."""
    Hp, Cp = lstm_padding(H, C)
    return tuple(_PAD[role](a, H, Hp, C, Cp) for a, role in zip(args, roles))


_SLICE = {
    "gates": lambda t, H, Hp: t.reshape(*t.shape[:-1], 4, Hp)[..., :H].reshape(
        *t.shape[:-1], 4 * H),
    "w_hh": lambda t, H, Hp: _SLICE["gates"](t[:H], H, Hp),
    "hidden": lambda t, H, Hp: t[..., :H].contiguous(),
    "bidir_out": lambda t, H, Hp: t.reshape(*t.shape[:-1], 2, Hp)[..., :H].reshape(
        *t.shape[:-1], 2 * H),                                           # (..., 2H)
}


def slice_lstm_results(outs, roles, H: int) -> tuple:
    """The results of a kernel run on `pad_lstm_args`' arguments sliced back to H,
    each by its role: "gates" (..., 4Hp) and "w_hh" (Hp, 4Hp: dW_hh) to the real
    gate columns (and rows), "hidden" (..., Hp) to the real units, "bidir_out"
    (..., 2Hp: the fused BiLSTM's output) to each direction's real units."""
    Hp = _round_up(H, _H_ALIGN)
    return tuple(_SLICE[role](t, H, Hp) for t, role in zip(outs, roles))


def _needs_padding(H: int, C: int | None = None) -> bool:
    return lstm_padding(H, C) != (H, C)


def _dtype_key(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _cell(gates: torch.Tensor, c: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _scan_plain(xg: torch.Tensor, w_hh: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                reverse: bool = False):
    """xg (T, R, 4H) float32 projected input, h / c (R, H) float32 initial
    state -> (hs, cs), each (T, R, H) float32.

    State stays float32; h is cast to the weight dtype before the
    recurrent product, which accumulates in float32 (the `_hdot` rule,
    nvse_tpu/ops/pallas_lstm.py:36-43).
    """
    T = xg.shape[0]
    w = w_hh.float()
    hs = xg.new_empty(T, *h.shape)
    cs = xg.new_empty(T, *h.shape)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xg[t] + h.to(w_hh.dtype).float() @ w
        h, c = _cell(gates, c)
        hs[t] = h
        cs[t] = c
    return hs, cs


def prefix_reversal(T: int, lengths, device) -> torch.Tensor:
    """(T, B) time index reversing each row's first lengths[b] steps and
    keeping the rest in place: t -> lengths[b] - 1 - t for t < lengths[b],
    else t. Its own inverse. Raises unless 0 <= lengths[b] <= T."""
    L = torch.as_tensor(lengths, dtype=torch.long, device=device).reshape(1, -1)
    if bool(((L < 0) | (L > T)).any()):
        raise ValueError(f"lengths must lie in [0, {T}], got {L.flatten().tolist()}")
    t = torch.arange(T, device=device).reshape(-1, 1)
    return torch.where(t < L, L - 1 - t, t)


def _take_time(xt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """xt (T, B, ...) gathered along time per row: out[t, b] = xt[idx[t, b], b]."""
    return xt[idx, torch.arange(xt.shape[1], device=xt.device)[None, :]]


def lstm_scan_fused_plain(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b,
                          lengths=None) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: (B, T, C) -> (B, T, 2H).

    Mirrors `_xla_lstm_fused_ref` with the kernel's numerics: the input
    projection x @ W_ih + b accumulates in float32 from the input-dtype
    values, the state is float32, and the output has the input dtype.
    With `lengths` (B,) the backward direction of row b scans its first
    lengths[b] steps only, from the last of them (`prefix_reversal`); the
    outputs past lengths[b] are undefined in both directions.
    """
    outs = []
    for w_ih, b, w_hh, reverse in ((w_ih_f, b_f, w_hh_f, False),
                                   (w_ih_b, b_b, w_hh_b, True)):
        xg = (x.float() @ w_ih.float() + b.float()).transpose(0, 1)
        zero = xg.new_zeros(x.shape[0], w_hh.shape[0])
        if reverse and lengths is not None:
            idx = prefix_reversal(xg.shape[0], lengths, xg.device)
            hs = _take_time(_scan_plain(_take_time(xg, idx), w_hh, zero, zero)[0], idx)
        else:
            hs = _scan_plain(xg, w_hh, zero, zero, reverse)[0]
        outs.append(hs.transpose(0, 1))
    return torch.cat(outs, dim=-1).to(x.dtype)


def _fused_route(C: int, H: int, narrow_fits: bool = True,
                 dtype: torch.dtype | None = None) -> str:
    """The inference route of lstm_scan_fused on the card at (C, H) (each padded
    to the kernels' multiple, `lstm_padding`) in dtype: "lstm_fused"
    (csrc/lstm_fused.cu) for H <= 128 where a cluster of its
    weight slices fits the card (`narrow_fits`: `fused_narrow_plan`'s
    co_resident, which is False past C + H of about 590 on an H100),
    "lstm_fused_wide" (csrc/lstm_fused_wide.cu) for 128 < H <= 512 with
    C + H <= 1280, and past them, up to H = 768, "projection+lstm_bidir2":
    x @ W_ih + b as torch matmuls, then lstm_scan_bidir2 (the kernel its
    `bidir2_plan` picks), as the JAX function does past its fused kernel's VMEM
    budget (pallas_lstm.py:864-880; it takes B5 in bfloat16 and two B4 scans in
    float32 by another VMEM rule: both are the same two independent scans, and
    the port takes B5 in both); past H = 768 and in float16
    "projection+lstm_stepwise", the same composition on whose lstm_scan_bidir2 the
    step-wise kernel of csrc/lstm_stepwise.cu runs. A route by
    shape and dtype, picked before any launch: a failed build or launch of a
    kernel still raises."""
    if _stepwise(H, dtype):
        return f"projection+{_STEPWISE}"
    H, C = lstm_padding(H, C)
    if H <= _MAX_H and narrow_fits:
        return "lstm_fused"
    if _MAX_H < H <= _FUSED_WIDE_MAX_H and C + H <= _FUSED_WIDE_MAX_K:
        return "lstm_fused_wide"
    return "projection+lstm_bidir2"


def fused_route(C: int, H: int, dtype: torch.dtype, n_sm: int, smem_limit: int) -> str:
    """`_fused_route` at (C, H, dtype) on a card with n_sm SMs and smem_limit
    bytes of shared memory a block (a pure function of them)."""
    if _stepwise(H, dtype):
        return _fused_route(C, H, dtype=dtype)
    Hp, Cp = lstm_padding(H, C)
    fits = Hp > _MAX_H or fused_narrow_plan(1, Cp, Hp, dtype, n_sm, smem_limit)["co_resident"]
    return _fused_route(C, H, fits, dtype)


def _card_fused_route(x: torch.Tensor, C: int, H: int) -> str:
    """`_fused_route` for x (B, T, C) on x's card: at H <= 128 from the narrow
    kernel's plan at the padded (C, H) as the card reports it
    (`_fused_narrow_card_plan`)."""
    fits = True
    Hp, Cp = lstm_padding(H, C)
    if Hp <= _MAX_H and x.dtype in _NARROW and x.dim() == 3:
        fits = _fused_narrow_card_plan(_device_index(x.device), max(1, x.shape[0]), Cp, Hp,
                                       x.dtype, 0)["co_resident"]
    return _fused_route(C, H, fits, x.dtype)


def _fused_shapes(name, x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b):
    """One float32, bfloat16 or float16 dtype, x (B, T, C) and weights of one
    (C, H): -> (B, T, C, H)."""
    args = (x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b)
    if x.dtype not in _DTYPE_CODE or any(a.dtype != x.dtype for a in args):
        raise TypeError(f"{name} takes float32, bfloat16 or float16, one dtype for x and all "
                        f"weights; got {sorted({str(a.dtype) for a in args})}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    B, T, C = x.shape
    H = w_hh_f.shape[0]
    shapes = {w_ih_f.shape, w_ih_b.shape}, {w_hh_f.shape, w_hh_b.shape}, {b_f.shape, b_b.shape}
    if shapes != ({(C, 4 * H)}, {(H, 4 * H)}, {(4 * H,)}):
        raise ValueError(f"weight shapes {shapes} do not match C={C}, H={H}")
    return B, T, C, H


def _check_kernel_args(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b):
    """Validate the tensors of a fused kernel's launch (contiguous, one dtype and
    (C, H), one CUDA device, aligned); raises, never falls back. Any (C, H): the
    wrapper pads to the kernels' multiples and `_fused_route` picks a kernel
    that takes the shape."""
    args = (x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b)
    for a in args:
        if not a.is_contiguous():
            raise ValueError("lstm_scan_fused kernel needs contiguous tensors "
                             "(call .contiguous() on the input first)")
    B, T, C, H = _fused_shapes("lstm_scan_fused kernel", *args)
    if any(a.device != x.device for a in args) or x.device.type != "cuda":
        raise ValueError("lstm_scan_fused kernel needs all tensors on one CUDA device")
    _check_aligned("lstm_scan_fused", *args)
    return B, T, C, H


def _check_aligned(name: str, *tensors) -> None:
    """The fused, scan and wide kernels read 16 bytes at a time."""
    if any(a.data_ptr() % 16 for a in tensors):
        raise ValueError(f"{name} kernel needs 16-byte aligned tensors (a contiguous view "
                         "at an odd offset is not: call .clone() on it)")


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("lstm_fused")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_fused_launch.argtypes = [i, *[ptr] * 8, *[i] * 10, ptr]
    lib.lstm_step_variant_launch.argtypes = [i, i, *[ptr] * 5, *[i] * 10, ptr]
    lib.lstm_fused_max_clusters.argtypes = [i, i, i, i, i, i, ptr]
    for fn in (lib.lstm_fused_launch, lib.lstm_step_variant_launch, lib.lstm_fused_max_clusters):
        fn.restype = ctypes.c_int
    return lib


# csrc/lstm_fused.cu's tiles (its `Narrow`): the units a block may own, the rows
# of a tile at one instance and one unit (a tile of instance `inst` at U units
# has rows * inst / U rows), the k of one product step C and H are padded to,
# and the pad of a staged row
_NARROW = {torch.bfloat16: dict(units=(64, 32, 16, 8), rows=1024, kt=16, pad=8),
           torch.float32: dict(units=(32, 16, 8), rows=256, kt=4, pad=4)}
_NARROW_INST = (1, 2, 4)        # m16 tiles of a warp (bfloat16), rows of a thread (float32)
_NARROW_STAGES = (3, 2)         # the x ring, deepest first
_NARROW_MAX_CLUSTER = 8         # the portable cluster size
_NARROW_STATIC_SMEM = 16        # bytes of static shared memory beside the plan's (two mbarriers)


def _narrow_tile_rows(U: int, inst: int, dtype: torch.dtype) -> int:
    return _NARROW[dtype]["rows"] * inst // U


def _narrow_smem(U: int, inst: int, C: int, H: int, dtype: torch.dtype, stages: int) -> int:
    """Dynamic shared memory of the narrow fused kernel: the [W_ih; W_hh] slice
    of U units in the input dtype (C and H padded to the product's k; in
    bfloat16 [column][k] rows 8 values longer), b in float32, two h buffers and
    a ring of `stages` x steps, each of the tile's rows (padded)."""
    d = _NARROW[dtype]
    cp, hp = math.ceil(C / d["kt"]) * d["kt"], math.ceil(H / d["kt"]) * d["kt"]
    bm = _narrow_tile_rows(U, inst, dtype)
    w = (cp + hp) * 4 * U * 4 if dtype == torch.float32 else 4 * U * (cp + hp + 8) * 2
    return w + 16 * U + (2 * bm * (hp + d["pad"]) + stages * bm * (cp + d["pad"])) * _ITEM[dtype]


def fused_narrow_plan(R: int, C: int, H: int, dtype: torch.dtype, n_sm: int, smem_limit: int,
                      max_clusters: int | None = None) -> dict:
    """Launch plan of the narrow fused BiLSTM (csrc/lstm_fused.cu, H <= 128) at
    x (R, T, C) (any T) on a card with n_sm SMs and smem_limit bytes a block,
    holding max_clusters clusters at once (default: one block an SM).

    A cluster of K = ceil(H / U) blocks owns a (direction, row tile); each
    block keeps its U units' weight slice in shared memory. The plan takes the
    widest slice (fewest blocks a cluster, most clusters) that fits beside the
    smallest tile; then as many tiles a direction as half the clusters, each
    of ceil(R / tiles) rows, in the instance with the smallest tile that holds
    them, when the card's clusters hold every row at once (one wave); else
    tiles of the largest instance that fits, a whole number of them for each
    cluster; the clusters walk their tiles with the weights loaded once.
    The x ring is as deep as fits (3 or 2 steps). -> units, cluster (K),
    inst, tile_rows (the instance's), rows (of the largest tile), ntiles,
    clusters (a direction), rounds (tiles a cluster), stages, smem_bytes,
    blocks, tensor_cores; `co_resident` False (and units None) when nothing
    fits: the kernel cannot run."""
    d = _NARROW[dtype]
    none = dict(units=None, co_resident=False, ntiles=0, clusters=0)
    top = min((u for u in d["units"] if u >= H), default=max(d["units"]))

    def depth(U, inst):
        return next((st for st in _NARROW_STAGES if _narrow_smem(U, inst, C, H, dtype, st)
                     + _NARROW_STATIC_SMEM <= smem_limit), 0)

    for U in (u for u in d["units"] if u <= top):
        K = math.ceil(H / U)
        fits = {inst: depth(U, inst) for inst in _NARROW_INST if depth(U, inst)}
        if K <= _NARROW_MAX_CLUSTER and fits:
            break
    else:
        return none
    clusters = n_sm // K if max_clusters is None else max_clusters
    per_dir = clusters // 2
    if per_dir < 1 or R < 1:
        return dict(none, units=U, cluster=K)
    top_rows = _narrow_tile_rows(U, max(fits), dtype)
    if R <= per_dir * top_rows:
        ntiles = min(per_dir, R)
    else:
        ntiles = per_dir * math.ceil(R / (per_dir * top_rows))
    rows = math.ceil(R / ntiles)
    inst = min(i for i in fits if _narrow_tile_rows(U, i, dtype) >= rows)
    ncl = min(per_dir, ntiles)
    return dict(units=U, cluster=K, inst=inst, tile_rows=_narrow_tile_rows(U, inst, dtype),
                rows=rows, ntiles=ntiles, clusters=ncl, rounds=math.ceil(ntiles / ncl),
                stages=fits[inst], smem_bytes=_narrow_smem(U, inst, C, H, dtype, fits[inst]),
                blocks=2 * ncl * K, tensor_cores=dtype == torch.bfloat16, co_resident=True)


@functools.cache
def _fused_narrow_card_plan(index: int, R: int, C: int, H: int, dtype: torch.dtype,
                            step: int) -> dict:
    """fused_narrow_plan on card `index`, its clusters read from the card
    (cudaOccupancyMaxActiveClusters) for the instance the plan picks (step:
    lstm_cell.cuh `Step`); cached, as the wrapper's host time counts."""
    dev = torch.device("cuda", index)
    n_sm, limit = _n_sm(dev), _smem_limit(dev)
    plan = fused_narrow_plan(R, C, H, dtype, n_sm, limit)
    for _ in range(2):                          # until the co-residency agrees with the plan
        if not plan["co_resident"]:
            return plan
        n = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _kernel_lib().lstm_fused_max_clusters(
                _DTYPE_CODE[dtype], step, plan["units"], plan["inst"], H, plan["smem_bytes"],
                ctypes.byref(n))
        _raise_on(err, "lstm_fused (occupancy)")
        again = fused_narrow_plan(R, C, H, dtype, n_sm, limit, n.value)
        if again == plan:
            return again
        plan = again
    return plan


def _fused_narrow_launch_plan(x: torch.Tensor, C: int, H: int, step: int = 0) -> dict:
    """fused_narrow_plan for x (R, T, C) on x's card (step: lstm_cell.cuh `Step`,
    0 for the production kernel); raises when the kernel cannot run there."""
    plan = _fused_narrow_card_plan(_device_index(x.device), x.shape[0], C, H, x.dtype, step)
    if not plan["co_resident"]:
        raise NotImplementedError(f"lstm_fused at C={C}, H={H}, {x.dtype}: no cluster of the "
                                  f"weight slices fits this card ({plan})")
    return plan


@functools.cache
def _fused_wide_lib() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("lstm_fused_wide")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_fused_wide_launch.argtypes = [i, *[ptr] * 9, *[i] * 10, ptr]
    lib.lstm_step_variant_wide_launch.argtypes = [i, i, *[ptr] * 6, *[i] * 10, ptr]
    lib.lstm_fused_wide_blocks_per_sm.argtypes = [i, i, i, i, i, i, i, i, ptr]
    for fn in (lib.lstm_fused_wide_launch, lib.lstm_step_variant_wide_launch,
               lib.lstm_fused_wide_blocks_per_sm):
        fn.restype = ctypes.c_int
    return lib


# csrc/lstm_fused_wide.cu's instances as (units a block, rows a tile), in the
# order the plan prefers them, and the pad of a staged row (its `Cfg`); the
# k-chunk of a stage and the ring's stages are chosen here
_FUSED_TILE = {torch.bfloat16: dict(tiles=((32, 64), (16, 64), (8, 128)), pad=8),
               torch.float32: dict(tiles=((16, 256), (16, 128), (16, 32), (8, 128)), pad=4)}
_FUSED_KC = (256, 128, 64, 32)
_FUSED_MAX_STAGES = 8
_FUSED_STATIC_SMEM = 8 * _FUSED_MAX_STAGES     # bytes of static shared memory beside the plan's
_MIN_GROUP_ROWS = 8             # rows a row group at least (more groups help small R)
_SMALL_GROUP_ROWS = 24          # bf16: fewer rows a group at the widest slice take the next


def _fused_smem(U: int, rows: int, C: int, H: int, dtype: torch.dtype, kc: int,
                stages: int) -> int:
    """Dynamic shared memory of the wide fused kernel at U units a block: the
    [W_ih; W_hh] slice in the input dtype (each part padded to the k-chunk kc;
    in bfloat16 [column][k] rows 8 values longer), b in float32, a ring of
    `stages` tiles of rows x kc."""
    kw = math.ceil(C / kc) * kc + math.ceil(H / kc) * kc
    weights = kw * 4 * U * 4 if dtype == torch.float32 else 4 * U * (kw + 8) * 2
    return weights + 4 * U * 4 + stages * rows * (kc + _FUSED_TILE[dtype]["pad"]) * _ITEM[dtype]


def fused_wide_tile(C: int, H: int, dtype: torch.dtype, smem_limit: int, U: int,
                    rows: int) -> dict | None:
    """The ring of the wide fused kernel's instance (U units, tiles of `rows`):
    the largest k-chunk whose ring holds 2 stages beside the weight slice in
    smem_limit, with as many stages as then fit up to _FUSED_MAX_STAGES. Few
    large chunks keep a step's sequential waits few; they beat deeper rings of
    smaller chunks at BSRNN-L's shapes (scripts/bench_torch_fused_plan.py
    times every plan). -> U, tile rows, kc, stages and bytes; None when U does
    not divide H or not even 2 stages of 32 k fit."""
    if H % U:
        return None
    room = smem_limit - _FUSED_STATIC_SMEM
    depth = {kc: max((st for st in range(2, _FUSED_MAX_STAGES + 1)
                      if _fused_smem(U, rows, C, H, dtype, kc, st) <= room), default=0)
             for kc in _FUSED_KC}
    kc = next((k for k in _FUSED_KC if depth[k] >= 2), None)
    if kc is None:
        return None
    return dict(units=U, tile_rows=rows, kc=kc, stages=depth[kc],
                smem_bytes=_fused_smem(U, rows, C, H, dtype, kc, depth[kc]))


def fused_wide_plan(R: int, C: int, H: int, dtype: torch.dtype, n_sm: int, smem_limit: int,
                    blocks_per_sm: int) -> dict:
    """Launch plan of the wide fused BiLSTM at x (R, T, C), H (any T) on a card with
    n_sm SMs, smem_limit bytes a block and blocks_per_sm blocks an SM: the
    instance (U units a block, rows a tile), its ring (`fused_wide_tile`), and
    as many row groups (each of both directions' H / U blocks; at most one
    for every 8 rows) as are co-resident. bfloat16 takes the widest slice that
    fits (each row of a group is staged H / U times a step), or the next where
    the widest leaves groups of fewer than 24 rows, whose steps are bound by
    latency, not by staging. float32 takes the widest slice that fits, in tiles of
    32 rows for groups of at most 32, of 128 for at most 256, else of 256 (8
    rows a thread): few rows want large k-chunks, which only small tiles leave
    room for, and many rows want fewer bytes read an FMA.
    `co_resident` is False when not even one group is (or nothing fits): the
    kernel cannot run, and its launch fails."""
    tiles = [t for U, rows in _FUSED_TILE[dtype]["tiles"]
             if (t := fused_wide_tile(C, H, dtype, smem_limit, U, rows)) is not None]
    if not tiles:
        return dict(units=None, co_resident=False, groups=0)

    def grouped(tile):
        per_group = 2 * (H // tile["units"])
        groups = min(max(0, blocks_per_sm) * n_sm // per_group, math.ceil(R / _MIN_GROUP_ROWS), R)
        rows = math.ceil(R / groups) if groups else 0
        return dict(tile, co_resident=groups >= 1, groups=groups, blocks=groups * per_group,
                    rows_per_group=rows, tiles_per_group=math.ceil(rows / tile["tile_rows"]))

    if dtype == torch.bfloat16:
        plans = [grouped(t) for t in tiles]
        small = (len(plans) > 1 and plans[1]["co_resident"]
                 and 0 < plans[0]["rows_per_group"] < _SMALL_GROUP_ROWS)
        return plans[1] if small else plans[0]
    plans = [grouped(t) for t in tiles if t["units"] == tiles[0]["units"]]
    if len(plans) == 1:
        return plans[0]
    rows = plans[0]["rows_per_group"]
    want = 32 if rows <= 32 else 128 if rows <= 256 else 256
    return next((p for p in plans if p["tile_rows"] == want), plans[0])


@functools.cache
def _fused_wide_card_plan(index: int, R: int, C: int, H: int, dtype: torch.dtype,
                          step: int) -> dict:
    """fused_wide_plan on card `index`, its blocks per SM read from the card for
    the instance the plan picks (step: lstm_cell.cuh `Step`); cached, as the
    wrapper's host time counts."""
    dev = torch.device("cuda", index)
    n_sm, limit = _n_sm(dev), _smem_limit(dev)
    plan = fused_wide_plan(R, C, H, dtype, n_sm, limit, 1)
    for _ in range(2):                          # until the occupancy agrees with the plan
        if plan["units"] is None:
            return plan
        bps = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _fused_wide_lib().lstm_fused_wide_blocks_per_sm(
                _DTYPE_CODE[dtype], step, plan["units"], plan["tile_rows"], C, H, plan["kc"],
                plan["stages"], ctypes.byref(bps))
        _raise_on(err, "lstm_fused_wide (occupancy)")
        again = fused_wide_plan(R, C, H, dtype, n_sm, limit, bps.value)
        if (again["units"], again["tile_rows"]) == (plan["units"], plan["tile_rows"]):
            return again
        plan = again
    return plan


def _fused_wide_launch_plan(x: torch.Tensor, C: int, H: int, step: int = 0) -> dict:
    """fused_wide_plan for x (R, T, C) on x's card, blocks per SM read from the
    card for the plan's instance (step: lstm_cell.cuh `Step`, 0 for the
    production kernel); raises when the kernel cannot run there."""
    plan = _fused_wide_card_plan(_device_index(x.device), x.shape[0], C, H, x.dtype, step)
    if not plan["co_resident"]:
        raise RuntimeError(f"lstm_fused_wide at C={C}, H={H}, {x.dtype}: no grid of whole row "
                           f"groups is co-resident on this card ({plan})")
    return plan


_FUSED_ROLES = ("x", "w_ih", "w_ih", "gates", "gates", "w_hh", "w_hh")


def _launch_kernel(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b, key=None) -> torch.Tensor:
    """The fused kernel (csrc/lstm_fused.cu at H <= 128, else csrc/lstm_fused_wide.cu)
    on CUDA tensors, padded to (C, H) multiples of (4, 8) and the output sliced
    back; the launch counted at the caller's (B, T, C, H, dtype) (`key`)."""
    B, T, C, H = _check_kernel_args(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b)
    key = key or (B, T, C, H, _dtype_key(x.dtype))
    if _needs_padding(H, C):
        args = pad_lstm_args((x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b), _FUSED_ROLES, H, C)
        return slice_lstm_results((_launch_kernel(*args, key=key),), ("bidir_out",), H)[0]
    out = torch.empty(B, T, 2 * H, device=x.device, dtype=x.dtype)
    if B == 0 or T == 0:
        return out
    ptrs = (x.data_ptr(), w_ih_f.data_ptr(), w_ih_b.data_ptr(), b_f.data_ptr(),
            b_b.data_ptr(), w_hh_f.data_ptr(), w_hh_b.data_ptr(), out.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if H > _MAX_H:
            plan = _fused_wide_launch_plan(x, C, H)
            # kernel scratch: the float32 c of each (direction, row, unit)
            c_state = torch.empty(2, B, H, device=x.device, dtype=torch.float32)
            err = _fused_wide_lib().lstm_fused_wide_launch(
                _DTYPE_CODE[x.dtype], *ptrs, c_state.data_ptr(), B, T, C, H, plan["units"],
                plan["tile_rows"], plan["groups"], plan["kc"], plan["stages"], plan["smem_bytes"],
                stream)
        else:
            plan = _fused_narrow_launch_plan(x, C, H)
            err = _kernel_lib().lstm_fused_launch(
                _DTYPE_CODE[x.dtype], *ptrs, B, T, C, H, plan["units"], plan["inst"],
                plan["ntiles"], plan["clusters"], plan["stages"], plan["smem_bytes"], stream)
    stem = _kernel_source("lstm_scan_fused", H, x.dtype)
    _raise_on(err, stem)
    _count(lstm_scan_fused, key, stem)
    return out


def lstm_scan_fused(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b, lengths=None) -> torch.Tensor:
    """(B, T, C) -> (B, T, 2H) fused-projection bidirectional LSTM.

    When autograd will differentiate the call (grad enabled and any
    input requires grad) it takes the residual-saving training route,
    `_BiLSTMSaving`. Otherwise CUDA tensors take the route `_fused_route`
    picks at (C, H) padded to multiples of (4, 8): a hand-written inference
    kernel that replaces
    nvse_tpu/ops/pallas_lstm.py:lstm_scan_fused, that of csrc/lstm_fused.cu
    for H <= 128 where a cluster of its weight slices fits the card, that of
    csrc/lstm_fused_wide.cu for 128 < H <= 512 (C + H <= 1280), and past them
    (and at H <= 128 where no cluster fits: C + H past about 590 on an H100;
    past H = 768 and in float16 the step-wise kernel) the projection as torch
    matmuls and lstm_scan_bidir2's kernel; CPU tensors go to
    lstm_scan_fused_plain. Counts fused-kernel launches in
    `lstm_scan_fused.launches` (per (B, T, C, H, dtype) in
    `lstm_scan_fused.launches_by_shape`, per kernel in
    `lstm_scan_fused.launches_by_kernel`); the third route's launches are
    lstm_scan_bidir2's, counted there.

    `lengths` (B,), for inference: row b is lengths[b] valid steps followed by
    padding. Its backward direction then scans the valid steps only, from the
    last of them, as a masked scan that leaves the state untouched on padded
    steps would (UTMOS's decoder, nvse_tpu/metrics/utmos_jax.py:_lstm_dir):
    the kernels take no mask, so each row's valid prefix is reversed in time by
    a gather (`prefix_reversal`) before the projection + lstm_scan_bidir2
    route, whatever (C, H), and the backward output is gathered back. Outputs
    past lengths[b] are undefined.
    """
    args = (x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b)
    if lengths is not None:
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            raise NotImplementedError("lstm_scan_fused with lengths is inference only")
        if x.device.type == "cpu":
            return lstm_scan_fused_plain(*args, lengths=lengths)
        return _projected_bidir2(*args, lengths=lengths)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _BiLSTMSaving.apply(*args)
    return torch.ops.nvse_torch.lstm_scan_fused(*args)


def _projected_bidir2(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b, lengths=None) -> torch.Tensor:
    """lstm_scan_fused past the fused kernels: xg = x @ W_ih + b per
    direction as torch matmuls in x's dtype, time-major, the backward
    direction's input flipped in time (pallas_lstm.py:867-868; with `lengths`
    each row's valid prefix reversed), then both scans in one launch of
    lstm_scan_bidir2, the backward output put back in time order."""
    B, T, C, H = _fused_shapes("lstm_scan_fused", x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b)
    xt = x.transpose(0, 1)                                           # (T, B, C)
    if lengths is None:
        back = lambda t: t.flip(0)                                   # noqa: E731
    else:
        idx = prefix_reversal(T, lengths, x.device)
        back = lambda t: _take_time(t, idx)                          # noqa: E731
    xg_f = torch.addmm(b_f, xt.reshape(T * B, C), w_ih_f).view(T, B, 4 * H)
    xg_b = torch.addmm(b_b, back(xt).reshape(T * B, C), w_ih_b).view(T, B, 4 * H)
    hs_f, hs_b = lstm_scan_bidir2(xg_f, xg_b, w_hh_f, w_hh_b)
    return torch.cat([hs_f.transpose(0, 1), back(hs_b).transpose(0, 1)], dim=-1)


def _reset_counts(*fns) -> None:
    for fn in fns:
        fn.launches = 0
        fn.launches_by_shape = {}
        fn.launches_by_kernel = {}


_reset_counts(lstm_scan_fused)


# ---------------------------------------------------------------------------
# training route: residual-saving forward and reverse-time backward
# ---------------------------------------------------------------------------

def lstm_fwd_hc_plain(x_proj: torch.Tensor, w_hh: torch.Tensor):
    """Plain version of the lstm_fwd_hc kernel: (T, R, 4H), (H, 4H) ->
    (hs, cs), each (T, R, H) in the x_proj dtype.

    Zero initial state. As the TPU residual kernel
    (pallas_lstm_bwd.py:139-159): the state is float32 and the recurrent
    product multiplies the float32 h by the weights, with no rounding of h
    to the weight dtype (the inference route's `_hdot` rule does round it).
    """
    T, R, G = x_proj.shape
    H = G // 4
    w = w_hh.float()
    h = x_proj.new_zeros(R, H, dtype=torch.float32)
    c = torch.zeros_like(h)
    hs = x_proj.new_empty(T, R, H)
    cs = x_proj.new_empty(T, R, H)
    for t in range(T):
        h, c = _cell(x_proj[t].float() + h @ w, c)
        hs[t] = h
        cs[t] = c
    return hs, cs


def lstm_dw_hh_plain(hs: torch.Tensor, dx_proj: torch.Tensor) -> torch.Tensor:
    """Plain version of the dW_hh reduction: sum over t and rows of
    h_{t-1}^T dx_proj[t] in float32, h_{-1} = 0 -> float32 (H, 4H)."""
    T, R, H = hs.shape
    h_prev = torch.cat([hs.new_zeros(1, R, H), hs[:-1]]).float().reshape(-1, H)
    return h_prev.T @ dx_proj.float().reshape(-1, 4 * H)


def lstm_bwd_plain(x_proj, hs, cs, dhs, w_hh):
    """Plain version of the lstm_bwd kernels: (x_proj, hs, cs, dhs, w_hh)
    -> (dx_proj (T, R, 4H) in the x_proj dtype, dw_hh (H, 4H) in the w_hh
    dtype). The math of pallas_lstm_bwd.py:11-18, gates recomputed from
    the saved h_{t-1}.

    As the TPU kernel, h_{t-1}, c_t and c_{t-1} are read as stored, both
    products and the carries are float32, and dx_proj is stored in the
    x_proj dtype. dW_hh sums the stored dx_proj in float32 over all
    steps and rows and is cast once; the TPU kernel sums the float32
    dgates and rounds dW per batch tile before adding the tiles. The two
    differ in bfloat16 only.
    """
    T, R, G = x_proj.shape
    H = G // 4
    w = w_hh.float()
    zero = x_proj.new_zeros(R, H, dtype=torch.float32)
    dh_carry, dc_carry = zero, zero
    dx = x_proj.new_empty(T, R, G)
    for t in range(T - 1, -1, -1):
        h_prev = hs[t - 1].float() if t else zero
        c_prev = cs[t - 1].float() if t else zero
        i, f, g, o = (x_proj[t].float() + h_prev @ w).chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        tc = torch.tanh(cs[t].float())
        dh = dhs[t].float() + dh_carry
        dc = dc_carry + dh * o * (1.0 - tc * tc)
        dgates = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=-1)
        dx[t] = dgates
        dh_carry = dgates @ w.T
        dc_carry = dc * f
    return dx, lstm_dw_hh_plain(hs, dx).to(w_hh.dtype)


def _check_seq_args(name: str, x_proj: torch.Tensor, w_hh: torch.Tensor | None, *states,
                    initial=()):
    """Validate the tensors of a scan or training kernel's launch (contiguous,
    one dtype, matching shapes, one CUDA device); raises, never falls back. Any
    H: the wrapper pads it to a multiple of 8 and routes past the resident
    kernels' H = 768, and float16, to csrc/lstm_stepwise.cu. x_proj (T, R, 4H),
    w_hh (H, 4H) or None, states (T, R, H) each, initial states (R, H)
    each. Returns (T, R, H)."""
    args = (x_proj, *states, *initial) if w_hh is None else (x_proj, w_hh, *states, *initial)
    for a in args:
        if not a.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous tensors")
    if x_proj.dtype not in _DTYPE_CODE or any(a.dtype != x_proj.dtype for a in args):
        raise TypeError(f"{name} kernel takes float32, bfloat16 or float16, one dtype for all "
                        f"inputs; got {sorted({str(a.dtype) for a in args})}")
    if x_proj.dim() != 3 or (w_hh is not None and w_hh.dim() != 2):
        raise ValueError(f"{name}: x_proj must be (T, R, 4H) and w_hh (H, 4H), got "
                         f"{[tuple(a.shape) for a in args]}")
    T, R, G = x_proj.shape
    H = G // 4
    if ((w_hh is not None and w_hh.shape != (H, 4 * H)) or G != 4 * H
            or any(s.shape != (T, R, H) for s in states)
            or any(s.shape != (R, H) for s in initial)):
        raise ValueError(f"{name}: shapes {[tuple(a.shape) for a in args]} do not match "
                         f"x_proj (T, R, 4H) = {tuple(x_proj.shape)}")
    if any(a.device != x_proj.device for a in args) or x_proj.device.type != "cuda":
        raise ValueError(f"{name} kernel needs all tensors on one CUDA device")
    return T, R, H


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("lstm_bwd")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_bwd_launch.argtypes = [i, *[ptr] * 6, *[i] * 8, ptr]
    lib.lstm_bwd_max_clusters.argtypes = [i, i, i, i, ptr]
    lib.lstm_dw_launch.argtypes = [i, ptr, ptr, ptr, i, i, i, i, i, i, ptr]
    lib.lstm_dw_blocks_per_sm.argtypes = [i, ptr]
    for fn in (lib.lstm_bwd_launch, lib.lstm_bwd_max_clusters, lib.lstm_dw_launch,
               lib.lstm_dw_blocks_per_sm):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_wide_lib() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("lstm_bwd_wide")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_bwd_wide_launch.argtypes = [i, *[ptr] * 8, *[i] * 7, ptr]
    lib.lstm_bwd_wide_blocks_per_sm.argtypes = [i, i, i, i, ptr]
    for fn in (lib.lstm_bwd_wide_launch, lib.lstm_bwd_wide_blocks_per_sm):
        fn.restype = ctypes.c_int
    return lib


# csrc/lstm_bwd_wide.cu's instances as (units a block, rows a tile), widest
# slice first (its `with_instance`)
_BWD_WIDE = {torch.bfloat16: ((32, 64), (32, 32), (16, 64), (16, 32), (8, 64)),
             torch.float32: ((16, 64), (16, 32), (8, 64), (8, 32))}
_BWD_MIN_GROUP_ROWS = {torch.bfloat16: 4, torch.float32: 8}


def _bwd_wide_smem(U: int, tile_rows: int, H: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the wide backward (its `Lay`): the W_hh column
    slice, the h tile, the gate sums and (bfloat16) the dgates split hi / lo,
    each 16-byte aligned. bfloat16 pads k to 16 and each row of the slice and
    the h tile by 8 values."""
    up = lambda v: -(-v // 16) * 16
    TM, NC = tile_rows, 4 * U
    if dtype == torch.bfloat16:
        kp = up(H) + 8
        parts = (NC * kp * 2, TM * kp * 2, TM * NC * 4, 2 * TM * (NC + 8) * 2)
    else:
        parts = (H * (NC + 1) * 4, TM * (H + 4) * 4, TM * (NC + 4) * 4, 0)
    return sum(up(p) for p in parts)


def bwd_wide_plan(R: int, H: int, dtype: torch.dtype, n_sm: int, smem_limit: int,
                  blocks_per_sm: int | dict = 1) -> dict:
    """Launch plan of the wide backward recurrence (csrc/lstm_bwd_wide.cu,
    128 < H <= 768) at (T, R, H) (any T) on a card with n_sm SMs, smem_limit
    bytes a block and blocks_per_sm blocks an SM (one number, or one for each
    instance (units, tile rows) as the card reports it): the widest slice of U
    units that divides H and fits and whose row groups hold at least
    _BWD_MIN_GROUP_ROWS rows (else the widest that fits), as many row groups
    of H / U blocks as are co-resident (at most one a row), and of its tile
    instances the one that holds the most groups; at a tie, tiles of 32 rows
    where a group has at most 32, else of 64. A narrower slice halves a
    block's products; more rows a group cost a bfloat16 block nothing up to
    an m16 tile, and keep a float32 block's warps (a quarter or an eighth of a
    tile's rows each) busy: GCRN's 16 rows take 8 or 16 units, not 16 or 32
    (scripts/bench_torch_scan_plan.py). -> units, tile_rows, groups,
    rows_per_group, tiles_per_group, smem_bytes, blocks, tensor_cores;
    `co_resident` False when nothing fits: the kernel cannot run, and its
    launch fails."""
    bps = (blocks_per_sm if isinstance(blocks_per_sm, dict)
           else {t: blocks_per_sm for t in _BWD_WIDE[dtype]})
    widest = None
    for U in dict.fromkeys(u for u, _ in _BWD_WIDE[dtype]):
        if H % U or H > _WIDE_MAX_H:
            continue
        per_group = H // U
        plans = []
        for TM in (tm for u, tm in _BWD_WIDE[dtype] if u == U):
            smem = _bwd_wide_smem(U, TM, H, dtype)
            groups = min(max(0, bps.get((U, TM), 0)) * n_sm // per_group, R)
            if smem > smem_limit or groups < 1:
                continue
            rows = math.ceil(R / groups)
            plans.append(dict(units=U, tile_rows=TM, groups=groups, rows_per_group=rows,
                              tiles_per_group=math.ceil(rows / TM), smem_bytes=smem,
                              blocks=groups * per_group, tensor_cores=dtype == torch.bfloat16,
                              co_resident=True))
        if plans:
            plan = max(plans, key=lambda p: (p["groups"],
                                             (p["tile_rows"] == 32) == (p["rows_per_group"] <= 32)))
            if plan["rows_per_group"] >= _BWD_MIN_GROUP_ROWS[dtype]:
                return plan
            widest = widest or plan
    return widest or dict(units=None, co_resident=False, groups=0)


@functools.cache
def _bwd_wide_card_plan(index: int, R: int, H: int, dtype: torch.dtype) -> dict:
    """bwd_wide_plan on card `index`, the blocks per SM of every instance that
    fits read from the card; cached, as the wrapper's host time counts."""
    dev = torch.device("cuda", index)
    n_sm, limit = _n_sm(dev), _smem_limit(dev)
    bps = {}
    for U, TM in _BWD_WIDE[dtype]:
        smem = _bwd_wide_smem(U, TM, H, dtype)
        if H % U or smem > limit:
            continue
        n = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _bwd_wide_lib().lstm_bwd_wide_blocks_per_sm(_DTYPE_CODE[dtype], U, TM, smem,
                                                              ctypes.byref(n))
        _raise_on(err, "lstm_bwd_wide (occupancy)")
        bps[(U, TM)] = n.value
    return bwd_wide_plan(R, H, dtype, n_sm, limit, bps)


# csrc/lstm_bwd.cu's backward recurrence for H <= 128 (its `rec::Cfg`): the units a
# block owns, the most blocks a cluster, its tile instances (rows), the pitches
# of an h row, of a slice row and of a dgates hi / lo row (bfloat16), the rows of
# the slice; then the ring's depths, deepest first
_BWD_NARROW = {torch.bfloat16: dict(units=64, max_cluster=2, tiles=(16,), kp=136, wp=136, dp=264,
                                    wrows=256),
               torch.float32: dict(units=32, max_cluster=4, tiles=(16, 32, 48), kp=132, wp=0, dp=0,
                                   wrows=0)}
_BWD_NARROW_STAGES = (3, 2)
_BWD_NARROW_STATIC_SMEM = 16    # bytes of static shared memory beside the plan's (two mbarriers)


def _bwd_narrow_smem(tile_rows: int, dtype: torch.dtype, stages: int) -> int:
    """Dynamic shared memory of the narrow backward recurrence at tiles of
    `tile_rows` and a ring of `stages` steps (its `rec::smem_bytes`): the W_hh
    column slice of U units (bfloat16 [4U][136]; float32 keeps it in registers); the
    ring, a step of h_{t-1} (rows of 136 / 132), x_proj (4U) and dhs, c_t and
    c_{t-1} (U each) for each row; the float32 gate sums (rows of 4U + 4); the
    bfloat16 dgates hi and lo (rows of 4U + 8); the float32 carry shares, two
    parities x the most blocks a cluster, rows of U + 4; each 16-byte aligned."""
    d = _BWD_NARROW[dtype]
    U, BM, item = d["units"], tile_rows, _ITEM[dtype]
    up = lambda v: -(-v // 16) * 16
    parts = (d["wrows"] * d["wp"] * item, stages * BM * (d["kp"] + 7 * U) * item,
             BM * (4 * U + 4) * 4, 2 * BM * d["dp"] * 2, 2 * d["max_cluster"] * BM * (U + 4) * 4)
    return sum(up(p) for p in parts)


def bwd_narrow_plan(R: int, H: int, dtype: torch.dtype, n_sm: int, smem_limit: int,
                    max_clusters: int | None = None) -> dict:
    """Launch plan of the narrow backward recurrence (csrc/lstm_bwd.cu, H <= 128)
    at (T, R, H) (any T) on a card with n_sm SMs and smem_limit bytes a block,
    holding max_clusters clusters at once (default: one block an SM).

    A cluster of K = ceil(H / U) blocks owns a row tile (U = 64 units a block in
    bfloat16, 32 in float32); each block keeps its units' W_hh column slice in
    shared memory. As `scan_narrow_plan`: a tile for each cluster, each of
    ceil(R / tiles) rows in the smallest instance that holds them (bfloat16:
    16 rows, float32: 16, 32 or 48), when the card's clusters hold every row at
    once; else tiles of the largest instance, a whole number for each cluster,
    walked with the slice loaded once. The ring is as deep as fits (3 or 2
    steps). -> units, cluster (K), tile_rows, rows (of the largest tile),
    ntiles, clusters, rounds (tiles a cluster), stages, smem_bytes, blocks,
    tensor_cores; `co_resident` False when the kernel cannot run (H > 128,
    nothing fits or no cluster is held)."""
    d = _BWD_NARROW[dtype]
    U = d["units"]
    K = math.ceil(H / U)
    none = dict(units=U, cluster=K, co_resident=False, ntiles=0, clusters=0)

    def depth(BM):
        return next((st for st in _BWD_NARROW_STAGES if _bwd_narrow_smem(BM, dtype, st)
                     + _BWD_NARROW_STATIC_SMEM <= smem_limit), 0)

    fits = {BM: depth(BM) for BM in d["tiles"] if depth(BM)}
    clusters = n_sm // K if max_clusters is None else max_clusters
    if H > _MAX_H or not fits or clusters < 1 or R < 1:
        return none
    top = max(fits)
    if R <= clusters * top:
        ntiles = min(clusters, R)
    else:
        ntiles = clusters * math.ceil(R / (clusters * top))
    rows = math.ceil(R / ntiles)
    BM = min(b for b in fits if b >= rows)
    ncl = min(clusters, ntiles)
    return dict(units=U, cluster=K, tile_rows=BM, rows=rows, ntiles=ntiles, clusters=ncl,
                rounds=math.ceil(ntiles / ncl), stages=fits[BM],
                smem_bytes=_bwd_narrow_smem(BM, dtype, fits[BM]), blocks=ncl * K,
                tensor_cores=dtype == torch.bfloat16, co_resident=True)


@functools.cache
def _bwd_narrow_card_plan(index: int, R: int, H: int, dtype: torch.dtype) -> dict:
    """bwd_narrow_plan on card `index`, its clusters read from the card
    (cudaOccupancyMaxActiveClusters) for the instance the plan picks; cached,
    as the wrapper's host time counts."""
    dev = torch.device("cuda", index)
    n_sm, limit = _n_sm(dev), _smem_limit(dev)
    plan = bwd_narrow_plan(R, H, dtype, n_sm, limit)
    for _ in range(2):                          # until the co-residency agrees with the plan
        if not plan["co_resident"]:
            return plan
        n = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _bwd_lib().lstm_bwd_max_clusters(_DTYPE_CODE[dtype], plan["tile_rows"], H,
                                                   plan["smem_bytes"], ctypes.byref(n))
        _raise_on(err, "lstm_bwd (occupancy)")
        again = bwd_narrow_plan(R, H, dtype, n_sm, limit, n.value)
        if again == plan:
            return again
        plan = again
    return plan


# the training wrappers' kernels (csrc/<stem>.cu): narrow (H <= 128) and wide
_TRAIN_KERNELS = {"lstm_fwd_hc": ("lstm_scan", "lstm_scan_wide"),
                  "lstm_bwd": ("lstm_bwd", "lstm_bwd_wide")}


def train_route(name: str, H: int, narrow_plan: dict, dtype: torch.dtype | None = None) -> str:
    """The kernel (csrc/<stem>.cu) that the training wrapper `name`
    (lstm_fwd_hc, lstm_bwd) launches at H (padded to a multiple of 8) in dtype,
    given its narrow kernel's plan (`scan_narrow_plan` with mode lstm_fwd_hc,
    `bwd_narrow_plan`): for H <= 128
    the narrow kernel (csrc/lstm_scan.cu mode kFwdHc, csrc/lstm_bwd.cu) where
    its plan runs, else the wide one (csrc/lstm_scan_wide.cu mode kFwdHc,
    csrc/lstm_bwd_wide.cu), which takes every H % 8 == 0 up to 768; the wide one
    past 128; past 768 and in float16 the step-wise kernels of
    csrc/lstm_stepwise.cu. A route by shape, dtype and card, picked before any
    launch: a failed build or launch still raises."""
    if _stepwise(H, dtype):
        return _STEPWISE
    narrow, wide = _TRAIN_KERNELS[name]
    return narrow if H <= _MAX_H and narrow_plan["co_resident"] else wide


def stepwise_plan(R: int, H: int, scans: int = 1) -> dict:
    """Launch plan of csrc/lstm_stepwise.cu at R rows, H units and `scans` scans
    a launch: one launch a step, blocks of 16 rows x 16 units (its BR, BU)."""
    return dict(tile_rows=16, units=16, blocks=math.ceil(R / 16) * math.ceil(H / 16) * scans,
                launches_per_step=1, scans=scans, co_resident=True)


def _card_train_route(name: str, x_proj: torch.Tensor, R: int, H: int) -> tuple:
    """train_route on x_proj's card -> (kernel stem, the plan it launches with)."""
    index, dtype = _device_index(x_proj.device), x_proj.dtype
    if _stepwise(H, dtype):
        return _STEPWISE, stepwise_plan(R, H)
    narrow = dict(co_resident=False)
    if H <= _MAX_H:
        narrow = (_scan_card_plan(index, R, H, dtype, 1, name) if name == "lstm_fwd_hc"
                  else _bwd_narrow_card_plan(index, R, H, dtype))
    stem = train_route(name, H, narrow)
    if stem == _TRAIN_KERNELS[name][0]:
        return stem, narrow
    if name == "lstm_fwd_hc":
        return stem, _scan_wide_launch_plan(name, x_proj, R, H)
    plan = _bwd_wide_card_plan(index, R, H, dtype)
    if not plan["co_resident"]:
        raise RuntimeError(f"lstm_bwd_wide at R={R}, H={H}, {dtype}: no row group is "
                           f"co-resident on this card ({plan})")
    return stem, plan


def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _count(fn, key, kernel: str) -> None:
    """One launch of fn's kernel (the csrc/<kernel>.cu stem) at key."""
    fn.launches += 1
    fn.launches_by_shape[key] = fn.launches_by_shape.get(key, 0) + 1
    fn.launches_by_kernel[kernel] = fn.launches_by_kernel.get(kernel, 0) + 1


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@functools.cache
def _stepwise_lib() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library(_STEPWISE)
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_stepwise_fwd_launch.argtypes = [i, i, i, *[ptr] * 10, i, i, i, ptr]
    lib.lstm_stepwise_bwd_launch.argtypes = [i, *[ptr] * 8, i, i, i, ptr]
    for fn in (lib.lstm_stepwise_fwd_launch, lib.lstm_stepwise_bwd_launch):
        fn.restype = ctypes.c_int
    return lib


def _stepwise_fwd(xps, ws, hss, css=None, initial=None, round_h: bool = True) -> int:
    """The forward of csrc/lstm_stepwise.cu on one or two scans: x_proj xps[s]
    (T, R, 4H) with ws[s] (H, 4H) into hss[s] and, where css is given, css[s]
    (T, R, H), both scans advancing in the same launch each step, from zero or
    from initial = (h0, c0) (one scan, (R, H) each); h rounded to the weights'
    type before the product where round_h (the inference scans), not in the
    residual-saving forward. -> the CUDA error of the launches."""
    T, R, G = xps[0].shape
    H, n = G // 4, len(xps)
    dev = xps[0].device
    # kernel scratch: the float32 h of each (scan, row, unit), two buffers by step
    # parity; the float32 c of each (scan, row, unit)
    hstate = torch.zeros(2, n, R, H, device=dev, dtype=torch.float32)
    cstate = torch.zeros(n, R, H, device=dev, dtype=torch.float32)
    if initial is not None:
        hstate[0, 0].copy_(initial[0])
        cstate[0].copy_(initial[1])
    ptr = lambda seq, s: seq[s].data_ptr() if seq is not None and s < len(seq) else None  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return _stepwise_lib().lstm_stepwise_fwd_launch(
            _DTYPE_CODE[xps[0].dtype], n, int(round_h), ptr(xps, 0), ptr(xps, 1), ptr(ws, 0),
            ptr(ws, 1), ptr(hss, 0), ptr(hss, 1), ptr(css, 0), ptr(css, 1), hstate.data_ptr(),
            cstate.data_ptr(), R, T, H, stream)


def lstm_fwd_hc(x_proj: torch.Tensor, w_hh: torch.Tensor, key=None):
    """(T, R, 4H), (H, 4H) -> (hs, cs), each (T, R, H): the residual-saving
    forward scan from zero state. CUDA tensors launch a hand-written
    kernel that replaces nvse_tpu/ops/pallas_lstm_bwd.py:lstm_fwd_hc, the one
    `train_route` picks: mode kFwdHc of csrc/lstm_scan.cu (H <= 128, the plan
    of `scan_narrow_plan`) or of csrc/lstm_scan_wide.cu (the plan of
    `scan_wide_plan`; 128 < H <= 768, and at H <= 128 where no cluster of the
    narrow kernel is held), or past 768 and in float16 the step-wise forward of
    csrc/lstm_stepwise.cu; H is zero-padded to a multiple of 8 and the results
    sliced back (`pad_lstm_args`). CPU tensors run lstm_fwd_hc_plain. Counts
    launches in `lstm_fwd_hc.launches` (per the caller's (T, R, H, dtype) in
    `lstm_fwd_hc.launches_by_shape`, per kernel in
    `lstm_fwd_hc.launches_by_kernel`)."""
    if x_proj.device.type == "cpu":
        return lstm_fwd_hc_plain(x_proj, w_hh)
    T, R, H = _check_seq_args("lstm_fwd_hc", x_proj, w_hh)
    key = key or (T, R, H, _dtype_key(x_proj.dtype))
    if _needs_padding(H):
        outs = lstm_fwd_hc(*pad_lstm_args((x_proj, w_hh), ("gates", "w_hh"), H), key=key)
        return slice_lstm_results(outs, ("hidden", "hidden"), H)
    _check_aligned("lstm_fwd_hc", x_proj, w_hh)
    hs = torch.empty(T, R, H, device=x_proj.device, dtype=x_proj.dtype)
    cs = torch.empty_like(hs)
    if T == 0 or R == 0:
        return hs, cs
    args = (_DTYPE_CODE[x_proj.dtype], x_proj.data_ptr(), w_hh.data_ptr(), hs.data_ptr(),
            cs.data_ptr())
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream(x_proj.device).cuda_stream
        stem, plan = _card_train_route("lstm_fwd_hc", x_proj, R, H)
        if stem == _STEPWISE:
            err = _stepwise_fwd((x_proj,), (w_hh,), (hs,), (cs,), round_h=False)
        elif stem == "lstm_scan":
            err = _scan_lib().lstm_fwd_hc_launch(*args, R, T, H, plan["inst"], plan["ntiles"],
                                                 plan["clusters"], plan["stages"],
                                                 plan["smem_bytes"], stream)
        else:
            # kernel scratch: in bfloat16 h - bf16(h) of each (row, unit), two
            # slots by step parity (hs holds bf16(h)); the float32 c of each (row, unit)
            lo = (torch.empty(2, R, H, device=x_proj.device, dtype=torch.bfloat16)
                  if x_proj.dtype == torch.bfloat16 else None)
            c_state = torch.empty(R, H, device=x_proj.device, dtype=torch.float32)
            err = _scan_wide_lib().lstm_fwd_hc_wide_launch(
                *args, None if lo is None else lo.data_ptr(), c_state.data_ptr(), R, T, H,
                *_scan_wide_plan_args(plan), stream)
    _raise_on(err, f"lstm_fwd_hc ({stem})")
    _count(lstm_fwd_hc, key, stem)
    return hs, cs


# The dW_hh reduction's tiles, as csrc/lstm_bwd.cu's `dw` namespace builds them:
# 128 x 128 (m, j) output tiles; tile_k rows of [h_{t-1} | dx_proj] a stage, in
# a ring of `stages`, each stage's rows padded to `pitch` elements (A and B alike)
_DW_TILE = {torch.bfloat16: dict(tile_m=128, tile_n=128, tile_k=32, stages=4, pitch=136),
            torch.float32: dict(tile_m=128, tile_n=128, tile_k=8, stages=3, pitch=128)}
_DW_TILE[torch.float16] = _DW_TILE[torch.bfloat16]      # the same tensor-core kernel
_DW_MIN_SPLIT_ROWS = 256        # below this a split's ring barely fills


def dw_plan(T: int, R: int, H: int, dtype: torch.dtype, n_sm: int, smem_limit: int,
            blocks_per_sm: int) -> dict:
    """Launch plan of the dW_hh reduction at (T, R, H) on a card with n_sm SMs,
    smem_limit bytes of shared memory a block and blocks_per_sm blocks an SM:
    the tiles, the dynamic shared memory (`smem_bytes`), and the split of the
    T*R rows into `nsplit` runs of `rows_per_split` (the last one shorter) so
    that tiles x splits fill the card in one wave. `fits` is False when a block's
    shared memory exceeds the limit."""
    tile = _DW_TILE[dtype]
    item = _ITEM[dtype]
    smem = tile["stages"] * tile["tile_k"] * 2 * tile["pitch"] * item
    tiles = math.ceil(H / tile["tile_m"]) * math.ceil(4 * H / tile["tile_n"])
    N = T * R
    want = max(1, max(1, blocks_per_sm) * n_sm // tiles)     # one wave, never a second
    rows = max(_DW_MIN_SPLIT_ROWS, math.ceil(N / want))
    rows = math.ceil(rows / tile["tile_k"]) * tile["tile_k"]
    nsplit = max(1, math.ceil(N / rows))
    return dict(tile, smem_bytes=smem, fits=smem <= smem_limit, tiles=tiles, nsplit=nsplit,
                rows_per_split=rows, blocks=tiles * nsplit)


def _smem_limit(device: torch.device) -> int:
    """Shared memory a block may opt into on the card (232,448 bytes on an H100)."""
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


@functools.cache
def _dw_card_plan(index: int, T: int, R: int, H: int, dtype: torch.dtype) -> dict:
    """dw_plan on card `index`, blocks per SM read from the card; cached, as
    the wrapper's host time counts."""
    dev = torch.device("cuda", index)
    bps = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _bwd_lib().lstm_dw_blocks_per_sm(_DTYPE_CODE[dtype], ctypes.byref(bps))
    _raise_on(err, "lstm_dw_hh (occupancy)")
    plan = dw_plan(T, R, H, dtype, _n_sm(dev), _smem_limit(dev), bps.value)
    if not plan["fits"]:
        raise RuntimeError(f"lstm_dw_hh: {plan['smem_bytes']} bytes of shared memory a block "
                           f"exceed this card's {_smem_limit(dev)}")
    return plan


def lstm_dw_hh(hs: torch.Tensor, dx_proj: torch.Tensor, key=None) -> torch.Tensor:
    """dW_hh = sum_{t, r} h_{t-1}^T dx_proj[t] -> float32 (H, 4H). CUDA
    tensors launch the hand-written reduction of csrc/lstm_bwd.cu (the dW
    sum of nvse_tpu/ops/pallas_lstm_bwd.py:lstm_bwd; any H, zero-padded to a
    multiple of 8 and the result sliced back; tensor cores in bfloat16 and
    float16, CUDA cores in float32) with the split of `dw_plan`: the
    splits add their float32 sums into the zeroed output with atomics, in an
    order that varies from run to run (one split stores). CPU tensors run
    lstm_dw_hh_plain. Counts launches in `lstm_dw_hh.launches`."""
    if hs.device.type == "cpu":
        return lstm_dw_hh_plain(hs, dx_proj)
    T, R, H = _check_seq_args("lstm_dw_hh", dx_proj, None, hs)
    key = key or (T, R, H, _dtype_key(hs.dtype))
    if _needs_padding(H):
        dw = lstm_dw_hh(*pad_lstm_args((hs, dx_proj), ("hidden", "gates"), H), key=key)
        return slice_lstm_results((dw,), ("w_hh",), H)[0]
    _check_aligned("lstm_dw_hh", hs, dx_proj)
    dev = hs.device
    plan = _dw_card_plan(_device_index(dev), T, R, H, hs.dtype)
    dw = (torch.zeros if plan["nsplit"] > 1 else torch.empty)(H, 4 * H, device=dev,
                                                                dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _bwd_lib().lstm_dw_launch(_DTYPE_CODE[hs.dtype], hs.data_ptr(),
                                        dx_proj.data_ptr(), dw.data_ptr(), R, T, H,
                                        plan["nsplit"], plan["rows_per_split"],
                                        plan["smem_bytes"], stream)
    _raise_on(err, "lstm_dw_hh")
    _count(lstm_dw_hh, key, "lstm_bwd")
    return dw


_BWD_ROLES = ("gates", "hidden", "hidden", "hidden", "w_hh")


def lstm_bwd(x_proj, hs, cs, dhs, w_hh):
    """Reverse-time LSTM backward: (x_proj, hs, cs, dhs, w_hh) ->
    (dx_proj (T, R, 4H), dw_hh (H, 4H)), gates recomputed from the saved
    h_{t-1}. CUDA tensors, H zero-padded to a multiple of 8 once here and the
    results sliced back, launch the hand-written recurrence
    (lstm_bwd_recurrence), which replaces nvse_tpu/ops/pallas_lstm_bwd.py:
    lstm_bwd, then the dW_hh reduction (lstm_dw_hh); CPU tensors run
    lstm_bwd_plain. Counts recurrence launches in `lstm_bwd.launches`."""
    if x_proj.device.type == "cpu":
        return lstm_bwd_plain(x_proj, hs, cs, dhs, w_hh)
    T, R, H = _check_seq_args("lstm_bwd", x_proj, w_hh, hs, cs, dhs)
    key = (T, R, H, _dtype_key(x_proj.dtype))
    args = (x_proj, hs, cs, dhs, w_hh)
    if _needs_padding(H):
        args = pad_lstm_args(args, _BWD_ROLES, H)
    dx = lstm_bwd_recurrence(*args, key=key)
    dw = lstm_dw_hh(args[1], dx, key=key).to(w_hh.dtype)
    if _needs_padding(H):
        return slice_lstm_results((dx, dw), ("gates", "w_hh"), H)
    return dx, dw


def lstm_bwd_recurrence(x_proj, hs, cs, dhs, w_hh, key=None) -> torch.Tensor:
    """The reverse-time kernel of lstm_bwd alone (CUDA tensors only):
    -> dx_proj (T, R, 4H); the one `train_route` picks: that of csrc/lstm_bwd.cu
    (H <= 128, the plan of `bwd_narrow_plan`) or that of csrc/lstm_bwd_wide.cu
    (the plan of `bwd_wide_plan`; 128 < H <= 768, and at H <= 128 where no
    cluster of the narrow kernel is held), or past 768 and in float16 the
    step-wise backward of csrc/lstm_stepwise.cu; H zero-padded to a multiple of
    8. Counts in `lstm_bwd.launches` (per kernel in
    `lstm_bwd.launches_by_kernel`)."""
    T, R, H = _check_seq_args("lstm_bwd", x_proj, w_hh, hs, cs, dhs)
    key = key or (T, R, H, _dtype_key(x_proj.dtype))
    if _needs_padding(H):
        args = pad_lstm_args((x_proj, hs, cs, dhs, w_hh), _BWD_ROLES, H)
        return slice_lstm_results((lstm_bwd_recurrence(*args, key=key),), ("gates",), H)[0]
    _check_aligned("lstm_bwd", x_proj, hs, cs, dhs, w_hh)
    dx = torch.empty_like(x_proj)
    if T == 0 or R == 0:
        return dx
    args = (_DTYPE_CODE[x_proj.dtype], x_proj.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            dhs.data_ptr(), w_hh.data_ptr(), dx.data_ptr())
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream(x_proj.device).cuda_stream
        stem, plan = _card_train_route("lstm_bwd", x_proj, R, H)
        if stem == _STEPWISE:
            # kernel scratch: the float32 dgates of a step, two buffers by step
            # parity (the next step's carry reads them); the float32 dc carry
            dg = torch.empty(2, R, 4 * H, device=x_proj.device, dtype=torch.float32)
            dc = torch.empty(R, H, device=x_proj.device, dtype=torch.float32)
            err = _stepwise_lib().lstm_stepwise_bwd_launch(*args, dg.data_ptr(), dc.data_ptr(),
                                                           R, T, H, stream)
        elif stem == "lstm_bwd":
            err = _bwd_lib().lstm_bwd_launch(*args, R, T, H, plan["tile_rows"], plan["ntiles"],
                                             plan["clusters"], plan["stages"], plan["smem_bytes"],
                                             stream)
        else:
            # kernel scratch: each block's float32 share of the next dh carry for
            # its group's rows, two slots by step parity; the float32 dc carry of
            # each (row, unit)
            U = plan["units"]
            share = torch.empty(2, H // U, R, H, device=x_proj.device, dtype=torch.float32)
            dc = torch.empty(R, H, device=x_proj.device, dtype=torch.float32)
            err = _bwd_wide_lib().lstm_bwd_wide_launch(
                *args, share.data_ptr(), dc.data_ptr(), R, T, H, U, plan["tile_rows"],
                plan["groups"], plan["smem_bytes"], stream)
    _raise_on(err, f"lstm_bwd ({stem})")
    _count(lstm_bwd, key, stem)
    return dx


_reset_counts(lstm_fwd_hc, lstm_bwd, lstm_dw_hh)


# ---------------------------------------------------------------------------
# unidirectional scans: causal time LSTM and streaming decode
# ---------------------------------------------------------------------------

def lstm_scan_plain(x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Plain version of the lstm_scan kernel: the unidirectional scan from
    zero state, (T, R, 4H), (H, 4H) -> hs (T, R, H) in the x_proj dtype.
    Mirrors `_xla_lstm_scan` with the kernel's numerics (`_scan_plain`)."""
    zero = x_proj.new_zeros(x_proj.shape[1], w_hh.shape[0], dtype=torch.float32)
    return _scan_plain(x_proj.float(), w_hh, zero, zero)[0].to(x_proj.dtype)


def lstm_scan_stateful_plain(x_proj, w_hh, h0, c0):
    """Plain version of the lstm_scan_stateful kernel: the scan started from
    the caller's (h0, c0), each (R, H) -> (hs, cs), each (T, R, H) in the
    x_proj dtype. Mirrors `_xla_lstm_scan_stateful` with the kernel's
    numerics: h0 and c0 are cast to float32 and the state stays float32."""
    hs, cs = _scan_plain(x_proj.float(), w_hh, h0.float(), c0.float())
    return hs.to(x_proj.dtype), cs.to(x_proj.dtype)


@functools.cache
def _scan_lib() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("lstm_scan")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_scan_launch.argtypes = [i, ptr, ptr, ptr, *[i] * 8, ptr]
    lib.lstm_scan_stateful_launch.argtypes = [i, *[ptr] * 6, *[i] * 8, ptr]
    lib.lstm_scan_bidir_launch.argtypes = [i, ptr, ptr, ptr, *[i] * 8, ptr]
    lib.lstm_scan_bidir2_launch.argtypes = [i, *[ptr] * 6, *[i] * 8, ptr]
    lib.lstm_fwd_hc_launch.argtypes = [i, *[ptr] * 4, *[i] * 8, ptr]
    lib.lstm_scan_max_clusters.argtypes = [i, i, i, i, i, ptr]
    for fn in (lib.lstm_scan_launch, lib.lstm_scan_stateful_launch, lib.lstm_scan_bidir_launch,
               lib.lstm_scan_bidir2_launch, lib.lstm_fwd_hc_launch, lib.lstm_scan_max_clusters):
        fn.restype = ctypes.c_int
    return lib


# csrc/lstm_scan.cu's tiles (its `Scan`): the units a block owns (its W_hh
# columns in registers), the rows of a tile at instance 1 (a tile of instance
# `inst` has rows * inst), the instances (and those of mode kFwdHc: float32 adds
# tiles of 32 and 48 rows, run in passes of 16), the pitch of an h row in shared
# memory and the bytes of the warps' gate scratch
_SCAN = {torch.bfloat16: dict(units=64, rows=16, insts=(1, 2, 4), fwd_hc_insts=(1, 2, 4),
                              hpp=136, scratch=16 * 16 * 24 * 4),
         torch.float32: dict(units=32, rows=1, insts=(1, 2, 4, 8, 16),
                             fwd_hc_insts=(1, 2, 4, 8, 16, 32, 48), hpp=128, scratch=0)}
_SCAN_STAGES = 3                # the x ring
_SCAN_STATIC_SMEM = 16          # bytes of static shared memory beside the plan's (two mbarriers)
# csrc/lstm_scan.cu's modes (its `Mode`): the wrapper that launches each
_SCAN_MODE = {"lstm_scan": 0, "lstm_scan_stateful": 1, "lstm_scan_bidir": 0, "lstm_fwd_hc": 2}


def _scan_insts(dtype: torch.dtype, mode: str = "lstm_scan") -> tuple:
    """The narrow scan's instances for the wrapper `mode`."""
    return _SCAN[dtype]["fwd_hc_insts" if mode == "lstm_fwd_hc" else "insts"]


def _scan_smem(inst: int, dtype: torch.dtype, stages: int, mode: str = "lstm_scan") -> int:
    """Dynamic shared memory of the narrow scan at instance `inst` for the
    wrapper `mode`: two h buffers (and two of lo, h - bf16(h), for lstm_fwd_hc
    in bfloat16), a ring of `stages` x steps (the 4 gates x U units of each row)
    and the warps' gate scratch (bfloat16)."""
    d = _SCAN[dtype]
    bm = d["rows"] * inst
    planes = 4 if dtype == torch.bfloat16 and mode == "lstm_fwd_hc" else 2
    return (planes * bm * d["hpp"] + stages * bm * 4 * d["units"]) * _ITEM[dtype] + d["scratch"]


def scan_narrow_plan(R: int, H: int, dtype: torch.dtype, n_sm: int, smem_limit: int,
                     max_clusters: int | None = None, directions: int = 1,
                     mode: str = "lstm_scan") -> dict:
    """Launch plan of the narrow scan (csrc/lstm_scan.cu, H <= 128) for the
    wrapper `mode` (lstm_scan, lstm_scan_stateful, lstm_scan_bidir, lstm_fwd_hc)
    at x_proj (T, directions x R, 4H) (any T) on a card with n_sm SMs and
    smem_limit bytes a block, holding max_clusters clusters at once (default:
    one block an SM).

    A cluster of K = ceil(H / U) blocks owns a (direction, row tile); each block
    keeps its U units' W_hh columns in registers (U = 64 in bfloat16, 32 in
    float32). As `fused_narrow_plan`: as many tiles a direction as its share
    of the clusters, each of ceil(R / tiles) rows in the smallest instance that
    holds them, when the card's clusters hold every row at once (one wave:
    few rows spread over many clusters, 34 rows over 33 or 34); else tiles of
    the largest instance, a whole number for each cluster, walked with the
    weights loaded once. -> units, cluster (K), inst, tile_rows (the
    instance's), rows (of the largest tile), ntiles, clusters (a direction),
    rounds (tiles a cluster), stages, smem_bytes, blocks, tensor_cores;
    `co_resident` False when the kernel cannot run (H > 128, no instance fits
    or no cluster is held)."""
    d = _SCAN[dtype]
    U = d["units"]
    K = math.ceil(H / U)
    none = dict(units=U, cluster=K, co_resident=False, ntiles=0, clusters=0)
    fits = [i for i in _scan_insts(dtype, mode)
            if _scan_smem(i, dtype, _SCAN_STAGES, mode) + _SCAN_STATIC_SMEM <= smem_limit]
    clusters = n_sm // K if max_clusters is None else max_clusters
    per_dir = clusters // directions
    if H > _MAX_H or not fits or per_dir < 1 or R < 1:
        return none
    top_rows = d["rows"] * max(fits)
    if R <= per_dir * top_rows:
        ntiles = min(per_dir, R)
    else:
        ntiles = per_dir * math.ceil(R / (per_dir * top_rows))
    rows = math.ceil(R / ntiles)
    inst = min(i for i in fits if d["rows"] * i >= rows)
    ncl = min(per_dir, ntiles)
    return dict(units=U, cluster=K, inst=inst, tile_rows=d["rows"] * inst, rows=rows,
                ntiles=ntiles, clusters=ncl, rounds=math.ceil(ntiles / ncl), stages=_SCAN_STAGES,
                smem_bytes=_scan_smem(inst, dtype, _SCAN_STAGES, mode), blocks=directions * ncl * K,
                tensor_cores=dtype == torch.bfloat16, co_resident=True)


@functools.cache
def _scan_card_plan(index: int, R: int, H: int, dtype: torch.dtype, directions: int,
                    mode: str = "lstm_scan") -> dict:
    """scan_narrow_plan on card `index` for the wrapper `mode`, its clusters read
    from the card (cudaOccupancyMaxActiveClusters) for the instance the plan
    picks; cached, as the wrapper's host time counts."""
    dev = torch.device("cuda", index)
    n_sm, limit = _n_sm(dev), _smem_limit(dev)
    plan = scan_narrow_plan(R, H, dtype, n_sm, limit, directions=directions, mode=mode)
    for _ in range(2):                          # until the co-residency agrees with the plan
        if not plan["co_resident"]:
            return plan
        n = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _scan_lib().lstm_scan_max_clusters(_DTYPE_CODE[dtype], _SCAN_MODE[mode],
                                                     plan["inst"], H, plan["smem_bytes"],
                                                     ctypes.byref(n))
        _raise_on(err, f"{mode} (occupancy)")
        again = scan_narrow_plan(R, H, dtype, n_sm, limit, n.value, directions, mode)
        if again == plan:
            return again
        plan = again
    return plan


def _scan_launch_plan(x_proj: torch.Tensor, R: int, H: int, directions: int = 1) -> dict:
    """scan_narrow_plan for R rows a direction on x_proj's card; raises when
    the kernel cannot run there."""
    plan = _scan_card_plan(_device_index(x_proj.device), R, H, x_proj.dtype, directions)
    if not plan["co_resident"]:
        raise RuntimeError(f"lstm_scan at R={R}, H={H}, {x_proj.dtype}: no cluster of the "
                           f"narrow scan is held by this card ({plan})")
    return plan


@functools.cache
def _scan_wide_lib() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("lstm_scan_wide")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_fwd_hc_wide_launch.argtypes = [i, *[ptr] * 6, *[i] * 7, ptr]
    lib.lstm_scan_wide_launch.argtypes = [i, *[ptr] * 4, *[i] * 7, ptr]
    lib.lstm_scan_stateful_wide_launch.argtypes = [i, *[ptr] * 7, *[i] * 7, ptr]
    lib.lstm_scan_bidir_wide_launch.argtypes = [i, *[ptr] * 5, *[i] * 8, ptr]
    lib.lstm_scan_bidir2_wide_launch.argtypes = [i, *[ptr] * 7, *[i] * 8, ptr]
    lib.lstm_scan_wide_blocks_per_sm.argtypes = [i, i, i, i, i, ptr]
    for fn in (lib.lstm_fwd_hc_wide_launch, lib.lstm_scan_wide_launch,
               lib.lstm_scan_stateful_wide_launch, lib.lstm_scan_bidir_wide_launch,
               lib.lstm_scan_bidir2_wide_launch, lib.lstm_scan_wide_blocks_per_sm):
        fn.restype = ctypes.c_int
    return lib


# csrc/lstm_scan_wide.cu's instances as (units a block, rows a tile), widest
# slice first (its `with_instance`), and its modes (its `Mode`): the wrapper
# that launches each
_SCAN_WIDE = {torch.bfloat16: ((32, 64), (32, 32), (16, 64), (16, 32), (8, 64), (8, 32)),
              torch.float32: ((16, 64), (16, 32), (8, 64), (8, 32))}
# and those lstm_scan_bidir2 takes: float32 adds (16 units, 8 rows) at H >= 512 (its
# product's k-slice sums fill the h tile's memory), whose slice and h tile fit beside
# each other at H = 768, so that both directions' 48-block groups run in one launch
# (HD-Demucs's bottleneck, 8 rows)
_SCAN_WIDE_BIDIR2 = {torch.bfloat16: _SCAN_WIDE[torch.bfloat16],
                     torch.float32: (*_SCAN_WIDE[torch.float32], (16, 8))}
_SCAN_WIDE_MIN_H8 = 512


def _bidir2_wide_instances(H: int, dtype: torch.dtype) -> tuple:
    """The wide scan's instances lstm_scan_bidir2 takes at H."""
    return _SCAN_WIDE_BIDIR2[dtype] if H >= _SCAN_WIDE_MIN_H8 else _SCAN_WIDE[dtype]
_SCAN_WIDE_MODE = {"lstm_scan": 1, "lstm_scan_stateful": 2, "lstm_scan_bidir": 3,
                   "lstm_fwd_hc": 4}


def _scan_wide_min_group_rows(dtype: torch.dtype, mode: str) -> int:
    """Rows a row group of the wide scan at least (where R has them): 8; 4 for
    lstm_fwd_hc in bfloat16, whose h goes in as two products (hi + lo)."""
    return 4 if dtype == torch.bfloat16 and mode == "lstm_fwd_hc" else 8


def _scan_wide_smem(U: int, tile_rows: int, H: int, dtype: torch.dtype,
                    mode: str = "lstm_scan") -> int:
    """Dynamic shared memory of the wide scan (its `Lay`): the W_hh column
    slice, the h tile (two planes, hi and lo, for lstm_fwd_hc in bfloat16), the
    gate sums and the ring of two x tiles, each 16-byte aligned. bfloat16 pads k
    to 16 and each row of the slice and the h tile by 8 values, each row of the
    gate sums by 8 floats."""
    up = lambda v: -(-v // 16) * 16
    TM, NC, item = tile_rows, 4 * U, _ITEM[dtype]
    if dtype == torch.bfloat16:
        kp = up(H) + 8
        planes = 2 if mode == "lstm_fwd_hc" else 1
        parts = (NC * kp * 2, planes * TM * kp * 2, TM * (NC + 8) * 4)
    else:
        parts = (H * (NC + 1) * 4, TM * (H + 4) * 4, TM * (NC + 4) * 4)
    return sum(up(p) for p in (*parts, 2 * TM * NC * item))


def scan_wide_plan(R: int, H: int, dtype: torch.dtype, n_sm: int, smem_limit: int,
                   blocks_per_sm: int | dict = 1, directions: int = 1,
                   mode: str = "lstm_scan", instances: tuple | None = None) -> dict:
    """Launch plan of the wide forward scans (csrc/lstm_scan_wide.cu, 128 < H <=
    768) for the wrapper `mode` (lstm_scan, lstm_scan_stateful, lstm_scan_bidir,
    lstm_fwd_hc) at R rows a direction (any T) on a card with n_sm SMs,
    smem_limit bytes a block and blocks_per_sm blocks an SM (one number, or one
    for each instance (units, tile rows) as the card reports it). Of every
    instance that fits, row groups of H / U blocks a direction: as many as are
    co-resident, at most one block an SM and at least 8 rows a group (4 for
    lstm_fwd_hc in bfloat16; one group where R is fewer); the plan within one
    block an SM (where a group alone needs more, past H of about 520: a second
    block an SM was 20 % slower at H = 768), then with the most blocks, at a
    tie the widest slice, then tiles of 32 rows
    where a group has at most 32, else of 64. A step is a product, a cell and a
    grid barrier: more blocks share the product, while a second block on an SM
    or a group of fewer rows buys nothing (scripts/bench_torch_scan_plan.py
    --kernel scan_wide). Two directions run in one launch where both
    directions' groups are co-resident, else one launch a direction
    (`launch_dirs` 1). `instances`: the (units, tile rows) to choose from
    (default `_SCAN_WIDE[dtype]`). -> units, tile_rows, groups (a direction),
    rows_per_group, tiles_per_group, launch_dirs, blocks (a launch),
    smem_bytes, tensor_cores; `co_resident` False when nothing fits: the
    kernel cannot run, and its launch fails."""
    inst = instances or _SCAN_WIDE[dtype]
    bps = (blocks_per_sm if isinstance(blocks_per_sm, dict) else {t: blocks_per_sm for t in inst})
    plans = []
    for U, TM in inst:
        smem = _scan_wide_smem(U, TM, H, dtype, mode)
        if H % U or H > _WIDE_MAX_H or R < 1 or smem > smem_limit:
            continue
        per_group = H // U
        slots = max(0, bps.get((U, TM), 0)) * n_sm // per_group
        dirs = directions if slots >= directions else 1
        groups = min(slots // dirs, max(1, n_sm // (per_group * dirs)),
                     max(1, R // _scan_wide_min_group_rows(dtype, mode)))
        if groups < 1:
            continue
        rows = math.ceil(R / groups)
        plans.append(dict(units=U, tile_rows=TM, groups=groups, rows_per_group=rows,
                          tiles_per_group=math.ceil(rows / TM), launch_dirs=dirs,
                          smem_bytes=smem, blocks=dirs * groups * per_group,
                          tensor_cores=dtype == torch.bfloat16, co_resident=True))
    if not plans:
        return dict(units=None, co_resident=False, groups=0)
    return max(plans, key=lambda p: (p["launch_dirs"], p["blocks"] <= n_sm, p["blocks"], p["units"],
                                     (p["tile_rows"] == 32) == (p["rows_per_group"] <= 32)))


@functools.cache
def _scan_wide_card_plan(index: int, R: int, H: int, dtype: torch.dtype, directions: int = 1,
                         mode: str = "lstm_scan", instances: tuple | None = None) -> dict:
    """scan_wide_plan on card `index`, the blocks per SM of every instance that
    fits read from the card; cached, as the wrapper's host time counts."""
    dev = torch.device("cuda", index)
    n_sm, limit = _n_sm(dev), _smem_limit(dev)
    bps = {}
    for U, TM in instances or _SCAN_WIDE[dtype]:
        smem = _scan_wide_smem(U, TM, H, dtype, mode)
        if H % U or smem > limit:
            continue
        n = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _scan_wide_lib().lstm_scan_wide_blocks_per_sm(
                _DTYPE_CODE[dtype], _SCAN_WIDE_MODE[mode], U, TM, smem, ctypes.byref(n))
        _raise_on(err, f"{mode} (occupancy)")
        bps[(U, TM)] = n.value
    return scan_wide_plan(R, H, dtype, n_sm, limit, bps, directions, mode, instances)


def _scan_wide_launch_plan(name: str, x_proj: torch.Tensor, R: int, H: int,
                           directions: int = 1) -> dict:
    """scan_wide_plan for the wrapper `name` at R rows a direction on x_proj's
    card; raises when nothing fits there."""
    plan = _scan_wide_card_plan(_device_index(x_proj.device), R, H, x_proj.dtype, directions,
                                name)
    if not plan["co_resident"]:
        raise RuntimeError(f"{name} at R={R}, H={H}, {x_proj.dtype}: no row group of the wide "
                           f"scan (csrc/lstm_scan_wide.cu) is co-resident on this card ({plan})")
    return plan


def _scan_wide_plan_args(plan: dict) -> tuple:
    """(units, tile rows, row groups, smem bytes): the plan as the C entries
    take it (the bidir entry takes the directions a launch before the smem)."""
    return plan["units"], plan["tile_rows"], plan["groups"], plan["smem_bytes"]


def _launch_scan(fn, x_proj, w_hh, initial=(), key=None):
    """Launches, for the wrapper fn, the scan kernel that H and the dtype pick:
    csrc/lstm_scan.cu for H <= 128, csrc/lstm_scan_wide.cu for
    128 < H <= 768, csrc/lstm_stepwise.cu past 768 and in float16; H zero-padded
    to a multiple of 8 and the results sliced back. -> (hs,), or (hs, cs) when
    `initial` is (h0, c0)."""
    name = fn.__name__
    T, R, H = _check_seq_args(name, x_proj, w_hh, initial=initial)
    key = key or (T, R, H, _dtype_key(x_proj.dtype))
    if _needs_padding(H):
        args = pad_lstm_args((x_proj, w_hh, *initial), ("gates", "w_hh", "hidden", "hidden"), H)
        outs = _launch_scan(fn, args[0], args[1], tuple(args[2:]), key=key)
        return slice_lstm_results(outs, ("hidden",) * len(outs), H)
    stem = _kernel_source(name, H, x_proj.dtype)
    _check_aligned(name, x_proj, w_hh, *initial)
    hs = torch.empty(T, R, H, device=x_proj.device, dtype=x_proj.dtype)
    outs = (hs, torch.empty_like(hs)) if initial else (hs,)
    if T == 0 or R == 0:
        return outs
    ptrs = [x_proj.data_ptr(), w_hh.data_ptr(), *(a.data_ptr() for a in (*initial, *outs))]
    dtype = _DTYPE_CODE[x_proj.dtype]
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream(x_proj.device).cuda_stream
        if stem == _STEPWISE:
            err = _stepwise_fwd((x_proj,), (w_hh,), (hs,), outs[1:] or None,
                                initial=initial or None)
        elif stem == "lstm_scan_wide":
            plan = _scan_wide_launch_plan(name, x_proj, R, H)
            # kernel scratch: the float32 c of each (row, unit)
            c_state = torch.empty(R, H, device=x_proj.device, dtype=torch.float32)
            launch = (_scan_wide_lib().lstm_scan_stateful_wide_launch if initial
                      else _scan_wide_lib().lstm_scan_wide_launch)
            err = launch(dtype, *ptrs, c_state.data_ptr(), R, T, H, *_scan_wide_plan_args(plan),
                         stream)
        else:
            plan = _scan_launch_plan(x_proj, R, H)
            launch = (_scan_lib().lstm_scan_stateful_launch if initial
                      else _scan_lib().lstm_scan_launch)
            err = launch(dtype, *ptrs, R, T, H, plan["inst"], plan["ntiles"], plan["clusters"],
                         plan["stages"], plan["smem_bytes"], stream)
    _raise_on(err, f"{name} ({stem})")
    _count(fn, key, stem)
    return outs


def lstm_scan(x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """(T, R, 4H), (H, 4H) -> hs (T, R, H): the unidirectional LSTM scan
    from zero state (the time LSTM of a causal config).

    When autograd will differentiate the call it takes the
    residual-saving route, `_ScanSaving`. Otherwise CUDA tensors launch a
    hand-written kernel that replaces
    nvse_tpu/ops/pallas_lstm.py:_pallas_lstm_scan, that of
    csrc/lstm_scan.cu for H <= 128, that of csrc/lstm_scan_wide.cu for
    128 < H <= 768, that of csrc/lstm_stepwise.cu past 768 and in float16 (H
    padded to a multiple of 8), and CPU tensors run lstm_scan_plain. Counts
    inference-kernel launches in `lstm_scan.launches` (per (T, R, H,
    dtype) in `lstm_scan.launches_by_shape`, per kernel in
    `lstm_scan.launches_by_kernel`)."""
    if torch.is_grad_enabled() and (x_proj.requires_grad or w_hh.requires_grad):
        return _ScanSaving.apply(x_proj, w_hh)
    return torch.ops.nvse_torch.lstm_scan(x_proj, w_hh)


def lstm_scan_stateful(x_proj, w_hh, h0, c0):
    """(T, R, 4H), (H, 4H), (R, H), (R, H) -> (hs, cs), each (T, R, H): the
    scan started from the caller's state, returning both trajectories so
    that a streaming decoder can take its carry at any step.

    CUDA tensors launch a hand-written kernel that replaces
    nvse_tpu/ops/pallas_lstm.py:_pallas_lstm_scan_stateful, that of
    csrc/lstm_scan.cu for H <= 128, that of csrc/lstm_scan_wide.cu for
    128 < H <= 768, that of csrc/lstm_stepwise.cu past 768 and in float16 (H
    padded to a multiple of 8); CPU tensors run lstm_scan_stateful_plain. Inference
    only, as in the JAX package: the kernels have no backward, so on CUDA
    a call that autograd would differentiate raises. Counts launches in
    `lstm_scan_stateful.launches` (per (T, R, H, dtype) in
    `lstm_scan_stateful.launches_by_shape`, per kernel in
    `lstm_scan_stateful.launches_by_kernel`)."""
    if x_proj.device.type == "cpu":
        return lstm_scan_stateful_plain(x_proj, w_hh, h0, c0)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x_proj, w_hh, h0, c0)):
        raise RuntimeError("lstm_scan_stateful has no gradient (streaming decode is "
                           "inference only): call it under torch.no_grad() or "
                           "torch.inference_mode()")
    return _launch_scan(lstm_scan_stateful, x_proj, w_hh, initial=(h0, c0))


_reset_counts(lstm_scan, lstm_scan_stateful)


# ---------------------------------------------------------------------------
# two independent scans in one launch: the grouped LSTM of GCRN
# ---------------------------------------------------------------------------

def lstm_scan_bidir2_plain(xp_a, xp_b, w_a, w_b):
    """Plain version of the lstm_scan_bidir2 kernel: two unidirectional
    scans from zero state, each in its own time order with its own W_hh:
    (T, R, 4H) x 2, (H, 4H) x 2 -> (hs_a, hs_b), each (T, R, H) in the
    x_proj dtype. Mirrors `_xla_lstm_scan_bidir2` with the kernel's
    numerics (`_scan_plain`)."""
    return lstm_scan_plain(xp_a, w_a), lstm_scan_plain(xp_b, w_b)


@functools.cache
def _bidir2_lib() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("lstm_bidir2")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_bidir2_launch.argtypes = [i, *[ptr] * 6, *[i] * 6, ptr]
    lib.lstm_bidir2_step_launch.argtypes = [i, i, *[ptr] * 6, *[i] * 6, ptr]
    lib.lstm_bidir2_max_clusters.argtypes = [i, i, i, i, ptr]
    for fn in (lib.lstm_bidir2_launch, lib.lstm_bidir2_step_launch, lib.lstm_bidir2_max_clusters):
        fn.restype = ctypes.c_int
    return lib


# csrc/lstm_bidir2.cu's cluster kernel (its `Lay`): the units a block owns, the
# most blocks a cluster (non-portable on an H100), the rows its buffers hold, the
# instances' tile rows (`with_rows`), the k of a float32 thread's slice held in
# registers, the pitch of a row of partial sums, the x ring's steps and the widest H
_BIDIR2 = dict(units=32, max_cluster=16, rows={torch.bfloat16: 16, torch.float32: 8},
               insts={torch.bfloat16: (16,), torch.float32: (4, 8)},
               wr=32, pp=132, stages=3, max_h=512)
_BIDIR2_STATIC_SMEM = 16        # bytes of static shared memory beside the plan's (two mbarriers)


def _bidir2_cluster_smem(H: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the cluster kernel at H (its `smem_bytes`):
    bfloat16, two h buffers of 16 rows (H padded to 16, + 8), the partial sums of
    4 k-quarters (two sets, by step parity) and the x ring; float32, the part of
    the W_hh slice past a thread's 32 registers' k (KSL = ceil(H / 32) 4 k a
    slice, 8 slices x 128 columns), two k-major h buffers of 8 rows, the partial
    sums of 8 k-slices (two sets) and the x ring (rows of 32 + 4 units)."""
    up = lambda v: -(-v // 16) * 16
    U, pp, st = _BIDIR2["units"], _BIDIR2["pp"], _BIDIR2["stages"]
    rows = _BIDIR2["rows"][dtype]
    if dtype == torch.bfloat16:
        return up(2 * rows * (up(H) + 8) * 2) + 2 * 4 * rows * pp * 4 + st * rows * 4 * U * 2
    ksl = math.ceil(math.ceil(H / 8) / 4) * 4
    w = max(0, ksl - _BIDIR2["wr"]) * 8 * 4 * U * 4
    return w + 2 * ksl * 8 * 8 * 4 + 2 * 8 * rows * pp * 4 + st * 4 * rows * (U + 4) * 4


def bidir2_cluster_plan(R: int, H: int, dtype: torch.dtype, n_sm: int, smem_limit: int,
                        max_clusters: int | None = None) -> dict:
    """Launch plan of the cluster kernel of csrc/lstm_bidir2.cu at R rows a scan
    and H (any T) on a card with n_sm SMs and smem_limit bytes a block, holding
    max_clusters clusters at once (default: one block an SM): clusters of
    K = ceil(H / 32) blocks, each owning (scan, row tile), the tiles balanced.
    bfloat16 tiles hold up to 16 rows (one m16 tile of the tensor cores);
    float32, whose product is bound by its shared-memory loads of h, takes as
    many tiles as one wave of clusters holds, of at least 4 rows each (tiles of
    2 were 50 % slower than of 4 at GCRN's 8 rows) and at most 8, in the
    smallest instance of 4 or 8 rows that holds them. `fits`: K <= 16, H <= 512 and the block's shared memory within the
    limit; `co_resident`: it fits and the card holds a cluster (the clusters are
    independent: more than the card holds run in `waves`). -> units, cluster,
    ntiles, rows (of the largest tile), tile_rows (the instance's), clusters,
    waves, smem_bytes, blocks, tensor_cores, fits, co_resident."""
    K = math.ceil(H / _BIDIR2["units"])
    held = n_sm // K if max_clusters is None else max_clusters
    most = _BIDIR2["rows"][dtype]
    ntiles = max(1, math.ceil(R / most))
    if dtype == torch.float32:
        ntiles = max(ntiles, min(math.ceil(R / 4), held // 2))
    rows = math.ceil(R / ntiles)
    inst = min(i for i in _BIDIR2["insts"][dtype] if i >= rows) if rows <= most else most
    smem = _bidir2_cluster_smem(H, dtype)
    fits = (K <= _BIDIR2["max_cluster"] and H <= _BIDIR2["max_h"] and H % 8 == 0
            and smem + _BIDIR2_STATIC_SMEM <= smem_limit)
    return dict(units=_BIDIR2["units"], cluster=K, ntiles=ntiles, rows=rows, tile_rows=inst,
                clusters=2 * ntiles, waves=math.ceil(2 * ntiles / held) if held > 0 else 0,
                smem_bytes=smem, blocks=2 * ntiles * K, tensor_cores=dtype == torch.bfloat16,
                fits=fits, co_resident=fits and R >= 1 and held >= 1)


def bidir2_plan(T: int, R: int, H: int, dtype: torch.dtype, n_sm: int, smem_limit: int,
                max_clusters: int | None = None, blocks_per_sm: int | dict = 1) -> dict:
    """The route and plan of lstm_scan_bidir2 at two scans of (T, R, 4H) (any T)
    on a card with n_sm SMs and smem_limit bytes a block (a pure function of
    them; the wrapper reads max_clusters, the cluster kernel's co-residency, and
    blocks_per_sm, the wide scan's, from the card):
      * H <= 128: "lstm_scan", the two-direction cluster scan of csrc/lstm_scan.cu
        (`scan_narrow_plan`, two directions of R rows);
      * 128 < H: "lstm_bidir2", the cluster kernel of csrc/lstm_bidir2.cu
        (`bidir2_cluster_plan`), where all its clusters run in one wave (GCRN's
        8 rows at H = 448 in both dtypes on an H100);
      * else "lstm_scan_wide", mode kScanBidir of csrc/lstm_scan_wide.cu
        (`scan_wide_plan`, two directions, the instances of `_bidir2_wide_instances`),
        to H = 768 (HD-Demucs's); where that
        does not fit the card either, the cluster kernel in waves;
      * past H = 768 and in float16: "lstm_stepwise", csrc/lstm_stepwise.cu
        (`stepwise_plan`, both scans in each step's launch).
    H is taken padded to a multiple of 8, as the wrapper pads it.
    -> {"route": the csrc stem, "plan": that kernel's plan}; the plan's
    `co_resident` False when the route cannot run on this card."""
    if _stepwise(H, dtype):
        return dict(route=_STEPWISE, plan=stepwise_plan(R, H, 2))
    H = _round_up(H, _H_ALIGN)
    if H <= _MAX_H:
        return dict(route="lstm_scan", plan=scan_narrow_plan(R, H, dtype, n_sm, smem_limit,
                                                             directions=2))
    cluster = bidir2_cluster_plan(R, H, dtype, n_sm, smem_limit, max_clusters)
    return _bidir2_pick(cluster, lambda: scan_wide_plan(R, H, dtype, n_sm, smem_limit,
                                                        blocks_per_sm, 2, "lstm_scan_bidir",
                                                        _bidir2_wide_instances(H, dtype)))


def _bidir2_pick(cluster: dict, wide) -> dict:
    """The cluster kernel in one wave, else the wide scan (`wide()`, its plan)
    where it runs, else the cluster kernel in waves where it runs."""
    if cluster["co_resident"] and cluster["waves"] == 1:
        return dict(route="lstm_bidir2", plan=cluster)
    plan = wide()
    if plan["co_resident"] or not cluster["co_resident"]:
        return dict(route="lstm_scan_wide", plan=plan)
    return dict(route="lstm_bidir2", plan=cluster)


@functools.cache
def _bidir2_card_plan(index: int, R: int, H: int, dtype: torch.dtype) -> dict:
    """bidir2_plan on card `index`: the cluster kernel's clusters read from the
    card (cudaOccupancyMaxActiveClusters), the narrow scan's as `_scan_card_plan`
    reads them, the wide scan's blocks per SM as `_scan_wide_card_plan`; cached,
    as the wrapper's host time counts."""
    dev = torch.device("cuda", index)
    n_sm, limit = _n_sm(dev), _smem_limit(dev)
    if _stepwise(H, dtype):
        return dict(route=_STEPWISE, plan=stepwise_plan(R, H, 2))
    if H <= _MAX_H:
        return dict(route="lstm_scan", plan=_scan_card_plan(index, R, H, dtype, 2))
    cluster = bidir2_cluster_plan(R, H, dtype, n_sm, limit)
    for _ in range(2):                          # until the co-residency agrees with the plan
        if not cluster["fits"]:
            break
        n = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _bidir2_lib().lstm_bidir2_max_clusters(
                _DTYPE_CODE[dtype], H, cluster["tile_rows"], cluster["smem_bytes"], ctypes.byref(n))
        _raise_on(err, "lstm_bidir2 (occupancy)")
        again = bidir2_cluster_plan(R, H, dtype, n_sm, limit, n.value)
        if again == cluster:
            break
        cluster = again
    return _bidir2_pick(cluster, lambda: _scan_wide_card_plan(index, R, H, dtype, 2,
                                                              "lstm_scan_bidir",
                                                              _bidir2_wide_instances(H, dtype)))


def _bidir2_launch_plan(xp: torch.Tensor, R: int, H: int) -> tuple:
    """(route, plan) of lstm_scan_bidir2 on xp's card; raises when it cannot run there."""
    got = _bidir2_card_plan(_device_index(xp.device), R, H, xp.dtype)
    if not got["plan"]["co_resident"]:
        raise RuntimeError(f"lstm_scan_bidir2 at R={R}, H={H}, {xp.dtype}: the route "
                           f"{got['route']} cannot run on this card ({got['plan']})")
    return got["route"], got["plan"]


def _launch_bidir2(route: str, plan: dict, xp_a, xp_b, w_a, w_b, hs_a, hs_b) -> int:
    """Launches lstm_scan_bidir2's two scans on the route and plan given; -> the
    CUDA error of the launch."""
    T, R, H = hs_a.shape
    if route == _STEPWISE:
        return _stepwise_fwd((xp_a, xp_b), (w_a, w_b), (hs_a, hs_b))
    ptrs = [t.data_ptr() for t in (xp_a, xp_b, w_a, w_b, hs_a, hs_b)]
    dtype = _DTYPE_CODE[xp_a.dtype]
    with torch.cuda.device(xp_a.device):
        stream = torch.cuda.current_stream(xp_a.device).cuda_stream
        if route == "lstm_bidir2":
            return _bidir2_lib().lstm_bidir2_launch(dtype, *ptrs, R, T, H, plan["ntiles"],
                                                    plan["tile_rows"], plan["smem_bytes"], stream)
        if route == "lstm_scan":
            return _scan_lib().lstm_scan_bidir2_launch(
                dtype, *ptrs, R, T, H, plan["inst"], plan["ntiles"], plan["clusters"],
                plan["stages"], plan["smem_bytes"], stream)
        # kernel scratch: the float32 c of each (scan, row, unit)
        c_state = torch.empty(2, R, H, device=xp_a.device, dtype=torch.float32)
        U, TM, groups, smem = _scan_wide_plan_args(plan)
        return _scan_wide_lib().lstm_scan_bidir2_wide_launch(
            dtype, *ptrs, c_state.data_ptr(), R, T, H, U, TM, groups, plan["launch_dirs"], smem,
            stream)


def lstm_scan_bidir2(xp_a, xp_b, w_a, w_b, route: str | None = None, plan: dict | None = None):
    """(T, R, 4H) x 2, (H, 4H) x 2 -> (hs_a, hs_b), each (T, R, H): two
    independent unidirectional LSTM scans from zero state that advance in
    the same launch (GCRN's pairs of group LSTMs). A caller that wants a
    reversed direction flips that scan's input and output.

    When autograd will differentiate the call it takes the
    residual-saving route, `_Bidir2Saving`. Otherwise CUDA tensors launch
    the hand-written kernel that `bidir2_plan` picks on this card (or the
    route and plan given: the plan bench), each replacing
    nvse_tpu/ops/pallas_lstm.py:_pallas_lstm_scan_bidir2: the
    cluster kernel of csrc/lstm_bidir2.cu, mode kScanBidir of
    csrc/lstm_scan_wide.cu or the cluster scan of csrc/lstm_scan.cu (H <= 768),
    each with a pointer for each scan, or past 768 and in float16 the step-wise
    kernel of csrc/lstm_stepwise.cu (H padded to a multiple of 8); CPU tensors
    run lstm_scan_bidir2_plain. Counts
    launches in `lstm_scan_bidir2.launches` (per (T, R, H, dtype) in
    `lstm_scan_bidir2.launches_by_shape`, per route's kernel in
    `lstm_scan_bidir2.launches_by_kernel`)."""
    args = (xp_a, xp_b, w_a, w_b)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _Bidir2Saving.apply(*args)
    if route is None and plan is None:
        return torch.ops.nvse_torch.lstm_scan_bidir2(*args)
    if xp_a.device.type == "cpu":
        return lstm_scan_bidir2_plain(*args)
    return _launch_bidir2_entry(*args, route, plan)


def _launch_bidir2_entry(xp_a, xp_b, w_a, w_b, route: str | None = None,
                         plan: dict | None = None, key=None):
    """lstm_scan_bidir2 on CUDA tensors: checks, H zero-padded to a multiple of 8
    (the results sliced back), the route and plan (this card's unless given),
    one launch counted on the route's kernel at the caller's shape."""
    args = (xp_a, xp_b, w_a, w_b)
    T, R, H = _check_seq_args("lstm_scan_bidir2", xp_a, w_a)
    if (xp_b.shape != xp_a.shape or xp_b.dtype != xp_a.dtype or xp_b.device != xp_a.device
            or _check_seq_args("lstm_scan_bidir2", xp_b, w_b) != (T, R, H)):
        raise ValueError("lstm_scan_bidir2: the two scans must agree in shape, dtype and "
                         f"device; got {[(tuple(a.shape), a.dtype, a.device) for a in args]}")
    key = key or (T, R, H, _dtype_key(xp_a.dtype))
    if _needs_padding(H):
        padded = pad_lstm_args(args, ("gates", "gates", "w_hh", "w_hh"), H)
        outs = _launch_bidir2_entry(*padded, route, plan, key=key)
        return slice_lstm_results(outs, ("hidden", "hidden"), H)
    _check_aligned("lstm_scan_bidir2", *args)
    hs_a = torch.empty(T, R, H, device=xp_a.device, dtype=xp_a.dtype)
    hs_b = torch.empty_like(hs_a)
    if T == 0 or R == 0:
        return hs_a, hs_b
    if route is None:
        route, plan = _bidir2_launch_plan(xp_a, R, H)
    err = _launch_bidir2(route, plan, xp_a, xp_b, w_a, w_b, hs_a, hs_b)
    _raise_on(err, f"lstm_scan_bidir2 ({route})")
    _count(lstm_scan_bidir2, key, route)
    return hs_a, hs_b


_reset_counts(lstm_scan_bidir2)


# ---------------------------------------------------------------------------
# both directions as stacked rows of one scan (no model calls it)
# ---------------------------------------------------------------------------

def lstm_scan_bidir_plain(xp_cat: torch.Tensor, w_stack: torch.Tensor) -> torch.Tensor:
    """Plain version of the lstm_scan_bidir kernel: (T, 2B, 4H), (2H, 4H) ->
    (T, 2B, H) in xp_cat's dtype; rows [0, B) scan with w_stack[:H], rows
    [B, 2B) with w_stack[H:], each forward in time from zero state. Mirrors
    `_xla_lstm_scan_bidir` with the kernel's numerics (`_scan_plain`)."""
    B, H = xp_cat.shape[1] // 2, xp_cat.shape[-1] // 4
    return torch.cat([lstm_scan_plain(xp_cat[:, :B], w_stack[:H]),
                      lstm_scan_plain(xp_cat[:, B:], w_stack[H:])], dim=1)


def _launch_scan_bidir(xp_cat: torch.Tensor, w_stack: torch.Tensor, key=None) -> torch.Tensor:
    """The kernel of lstm_scan_bidir on CUDA tensors: csrc/lstm_scan.cu for
    H <= 128 (each direction's clusters on its own tiles, with its own W_hh),
    csrc/lstm_scan_wide.cu for 128 < H <= 768, csrc/lstm_stepwise.cu (each
    direction's rows as one of its two scans) past 768 and in float16; H
    zero-padded to a multiple of 8 and the result sliced back."""
    name = "lstm_scan_bidir"
    if w_stack.dtype != xp_cat.dtype:
        raise TypeError(f"{name} kernel takes one dtype for xp_cat and w_stack; got "
                        f"{xp_cat.dtype} and {w_stack.dtype}")
    T, R2, H = _check_seq_args(name, xp_cat, None)
    if (R2 % 2 or tuple(w_stack.shape) != (2 * H, 4 * H) or not w_stack.is_contiguous()
            or w_stack.device != xp_cat.device):
        raise ValueError(f"{name}: xp_cat (T, 2B, 4H) = {tuple(xp_cat.shape)} needs an even "
                         f"row count and a contiguous w_stack (2H, 4H) on its device; got "
                         f"{tuple(w_stack.shape)} on {w_stack.device}")
    B = R2 // 2
    key = key or (T, R2, H, _dtype_key(xp_cat.dtype))
    if _needs_padding(H):
        padded = pad_lstm_args((xp_cat, w_stack), ("gates", "w_stack"), H)
        return slice_lstm_results((_launch_scan_bidir(*padded, key=key),), ("hidden",), H)[0]
    stem = _kernel_source(name, H, xp_cat.dtype)
    _check_aligned(name, xp_cat, w_stack)
    hs = torch.empty(T, R2, H, device=xp_cat.device, dtype=xp_cat.dtype)
    if T == 0 or B == 0:
        return hs
    dtype = _DTYPE_CODE[xp_cat.dtype]
    with torch.cuda.device(xp_cat.device):
        stream = torch.cuda.current_stream(xp_cat.device).cuda_stream
        if stem == _STEPWISE:
            # the step-wise kernel takes each scan's rows contiguous a step
            halves = (xp_cat[:, :B].contiguous(), xp_cat[:, B:].contiguous())
            outs = (torch.empty(T, B, H, device=hs.device, dtype=hs.dtype),
                    torch.empty(T, B, H, device=hs.device, dtype=hs.dtype))
            err = _stepwise_fwd(halves, (w_stack[:H], w_stack[H:]), outs)
            torch.cat(outs, dim=1, out=hs)
        elif stem == "lstm_scan_wide":
            plan = _scan_wide_launch_plan(name, xp_cat, B, H, directions=2)
            # kernel scratch: the float32 c of each (direction, row, unit)
            c_state = torch.empty(2, B, H, device=xp_cat.device, dtype=torch.float32)
            U, TM, groups, smem = _scan_wide_plan_args(plan)
            err = _scan_wide_lib().lstm_scan_bidir_wide_launch(
                dtype, xp_cat.data_ptr(), w_stack.data_ptr(), w_stack[H:].data_ptr(),
                hs.data_ptr(), c_state.data_ptr(), B, T, H, U, TM, groups, plan["launch_dirs"],
                smem, stream)
        else:
            plan = _scan_launch_plan(xp_cat, B, H, directions=2)
            err = _scan_lib().lstm_scan_bidir_launch(
                dtype, xp_cat.data_ptr(), w_stack.data_ptr(), hs.data_ptr(), B, T, H,
                plan["inst"], plan["ntiles"], plan["clusters"], plan["stages"],
                plan["smem_bytes"], stream)
    _raise_on(err, f"{name} ({stem})")
    _count(lstm_scan_bidir, key, stem)
    return hs


def _scan_bidir(xp_cat, w_stack):
    if xp_cat.device.type == "cpu":
        return lstm_scan_bidir_plain(xp_cat, w_stack)
    return _launch_scan_bidir(xp_cat, w_stack)


class _BidirRecompute(torch.autograd.Function):
    """lstm_scan_bidir under autograd, as the JAX custom_vjp
    (pallas_lstm.py:959-981): the forward is the kernel's (the plain version
    on the CPU), the backward differentiates the plain version recomputed, as
    `_bidir_bwd` differentiates `_xla_lstm_scan_bidir`. The TPU kernel has no
    backward kernel, and neither has the port."""

    @staticmethod
    def forward(ctx, xp_cat, w_stack):
        ctx.save_for_backward(xp_cat, w_stack)
        return _scan_bidir(xp_cat, w_stack)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = lstm_scan_bidir_plain(*leaves)
            got = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, need) if n], g))
        return tuple(next(got) if n else None for n in need)


def lstm_scan_bidir(xp_cat: torch.Tensor, w_stack: torch.Tensor) -> torch.Tensor:
    """(T, 2B, 4H), (2H, 4H) -> (T, 2B, H): both directions of a BiLSTM
    as stacked rows of one scan from zero state. Rows [0, B) use
    w_stack[:H], rows [B, 2B) w_stack[H:]; every row runs forward in time, so
    the caller flips the backward rows' input and output.

    CUDA tensors launch the hand-written kernel that replaces
    nvse_tpu/ops/pallas_lstm.py:_pallas_lstm_scan_bidir (csrc/lstm_scan.cu
    for H <= 128, csrc/lstm_scan_wide.cu for 128 < H <= 768,
    csrc/lstm_stepwise.cu past 768 and in float16), CPU tensors run
    lstm_scan_bidir_plain, and a call that autograd will differentiate goes
    through `_BidirRecompute`. Counts launches in `lstm_scan_bidir.launches`
    (per (T, 2B, H, dtype) in `lstm_scan_bidir.launches_by_shape`, per kernel
    in `lstm_scan_bidir.launches_by_kernel`)."""
    if torch.is_grad_enabled() and (xp_cat.requires_grad or w_stack.requires_grad):
        return _BidirRecompute.apply(xp_cat, w_stack)
    return _scan_bidir(xp_cat, w_stack)


_reset_counts(lstm_scan_bidir)


class _ScanSaving(torch.autograd.Function):
    """lstm_scan under autograd, as the JAX custom_vjp on the TPU
    (nvse_tpu/ops/pallas_lstm.py:331-351): lstm_fwd_hc forward saving hs
    and cs, lstm_bwd backward."""

    @staticmethod
    def forward(ctx, x_proj, w_hh):
        x_proj = x_proj.contiguous()
        hs, cs = lstm_fwd_hc(x_proj, w_hh)
        ctx.save_for_backward(x_proj, w_hh, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, g):
        x_proj, w_hh, hs, cs = ctx.saved_tensors
        return lstm_bwd(x_proj, hs, cs, g.to(x_proj.dtype).contiguous(), w_hh)


class _Bidir2Saving(torch.autograd.Function):
    """lstm_scan_bidir2 under autograd, as the TPU branch of the JAX
    custom_vjp (nvse_tpu/ops/pallas_lstm.py:554-563): lstm_fwd_hc per scan
    forward saving hs and cs, lstm_bwd per scan backward, in both dtypes
    at every H the training kernels take (the JAX package's VMEM rule,
    which sends f32 at H = 448 to XLA's recompute autodiff on the TPU, is
    a TPU tiling heuristic; both compute the same gradient). As with
    lstm_scan, this route multiplies the unrounded float32 h where the
    inference kernel rounds it as stored; they differ in bfloat16 only."""

    @staticmethod
    def forward(ctx, xp_a, xp_b, w_a, w_b):
        xp_a, xp_b = xp_a.contiguous(), xp_b.contiguous()
        hs_a, cs_a = lstm_fwd_hc(xp_a, w_a)
        hs_b, cs_b = lstm_fwd_hc(xp_b, w_b)
        ctx.save_for_backward(xp_a, xp_b, w_a, w_b, hs_a, cs_a, hs_b, cs_b)
        return hs_a, hs_b

    @staticmethod
    def backward(ctx, g_a, g_b):
        xp_a, xp_b, w_a, w_b, hs_a, cs_a, hs_b, cs_b = ctx.saved_tensors
        dx_a, dw_a = lstm_bwd(xp_a, hs_a, cs_a, g_a.to(xp_a.dtype).contiguous(), w_a)
        dx_b, dw_b = lstm_bwd(xp_b, hs_b, cs_b, g_b.to(xp_b.dtype).contiguous(), w_b)
        return dx_a, dx_b, dw_a, dw_b


class _BiLSTMSaving(torch.autograd.Function):
    """lstm_scan_fused under autograd: the residual-saving decomposition of
    nvse_tpu/ops/pallas_lstm.py `_fused_fwd_saving` / `_fused_bwd_saved`.
    The backward direction runs on time-flipped inputs, as there."""

    @staticmethod
    def forward(ctx, x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b):
        xg_f = (x @ w_ih_f + b_f).transpose(0, 1).contiguous()           # (T, B, 4H)
        xg_b = (x.flip(1) @ w_ih_b + b_b).transpose(0, 1).contiguous()
        hs_f, cs_f = lstm_fwd_hc(xg_f, w_hh_f)
        hs_b, cs_b = lstm_fwd_hc(xg_b, w_hh_b)
        ctx.save_for_backward(x, w_ih_f, w_ih_b, w_hh_f, w_hh_b,
                              xg_f, xg_b, hs_f, cs_f, hs_b, cs_b)
        out = torch.cat([hs_f.transpose(0, 1), hs_b.transpose(0, 1).flip(1)], dim=-1)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w_ih_f, w_ih_b, w_hh_f, w_hh_b, xg_f, xg_b, hs_f, cs_f, hs_b, cs_b = ctx.saved_tensors
        H = w_hh_f.shape[0]
        g = g.to(xg_f.dtype)
        g_f = g[..., :H].transpose(0, 1).contiguous()                    # (T, B, H)
        g_b = g[..., H:].flip(1).transpose(0, 1).contiguous()
        dxg_f, dw_hh_f = lstm_bwd(xg_f, hs_f, cs_f, g_f, w_hh_f)
        dxg_b, dw_hh_b = lstm_bwd(xg_b, hs_b, cs_b, g_b, w_hh_b)
        x_tm = x.transpose(0, 1)                                         # (T, B, C)
        dx = (dxg_f @ w_ih_f.T + (dxg_b @ w_ih_b.T).flip(0)).transpose(0, 1).to(x.dtype)
        C, G = x.shape[-1], 4 * H
        dw_ih_f = x_tm.reshape(-1, C).T @ dxg_f.reshape(-1, G)
        dw_ih_b = x_tm.flip(0).reshape(-1, C).T @ dxg_b.reshape(-1, G)
        return (dx, dw_ih_f.to(w_ih_f.dtype), dw_ih_b.to(w_ih_b.dtype),
                dxg_f.sum((0, 1)), dxg_b.sum((0, 1)),
                dw_hh_f.to(w_hh_f.dtype), dw_hh_b.to(w_hh_b.dtype))
