"""LSTM recurrences: the fused bidirectional LSTM and its training path.

Counterpart of nvse_tpu/ops/pallas_lstm.py (`lstm_scan_fused`) and
nvse_tpu/ops/pallas_lstm_bwd.py (`lstm_fwd_hc`, `lstm_bwd`).

`lstm_scan_fused` is the switch between two routes:
  * inference (grad disabled, or no input requires grad): the fused
    kernel of csrc/lstm_fused.cu, with x @ W_ih inside the recurrence;
  * training: `_BiLSTMSaving`, an autograd Function mirroring the JAX
    custom_vjp's `_fused_fwd_saving` / `_fused_bwd_saved`
    (pallas_lstm.py:904-952): torch matmuls for x @ W_ih + b, then
    `lstm_fwd_hc` per direction saving hs and cs; its backward runs
    `lstm_bwd` per direction (kernels of csrc/lstm_bwd.cu: the
    reverse-time recurrence and the dW_hh reduction) and torch matmuls
    for dx, dW_ih and db.
Every wrapper launches its CUDA kernel on a CUDA tensor or raises, and
runs its plain PyTorch version only on a CPU tensor; each counts its
launches in `<wrapper>.launches`.

Layouts follow the JAX package: x (B, T, C) batch-first, w_ih (C, 4H),
w_hh (H, 4H), b (4H,) = b_ih + b_hh, gate order (i, f, g, o); the
output is (B, T, 2H) with the forward direction in [:H] and the
backward direction, at its original time index, in [H:]. The training
kernels are time-major: x_proj (T, R, 4H), hs / cs / dhs (T, R, H).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

__all__ = ["lstm_bwd", "lstm_bwd_plain", "lstm_dw_hh", "lstm_dw_hh_plain", "lstm_fwd_hc",
           "lstm_fwd_hc_plain", "lstm_scan", "lstm_scan_fused", "lstm_scan_fused_plain",
           "lstm_scan_plain"]

_MAX_H = 128                    # one thread per gate column: 4H <= 512 threads
_ROWS_PER_BLOCK = (2, 4, 8)     # template instances in csrc/lstm_fused.cu and lstm_bwd.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _cell(gates: torch.Tensor, c: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _scan_plain(xg: torch.Tensor, w_hh: torch.Tensor, reverse: bool) -> torch.Tensor:
    """xg (B, T, 4H) float32 projected input -> hs (B, T, H) float32.

    State stays float32; h is cast to the weight dtype before the
    recurrent product, which accumulates in float32 (the `_hdot` rule,
    nvse_tpu/ops/pallas_lstm.py:36-43).
    """
    B, T, G = xg.shape
    H = G // 4
    w = w_hh.float()
    h = xg.new_zeros(B, H)
    c = xg.new_zeros(B, H)
    hs = xg.new_empty(B, T, H)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xg[:, t] + h.to(w_hh.dtype).float() @ w
        h, c = _cell(gates, c)
        hs[:, t] = h
    return hs


def lstm_scan_fused_plain(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: (B, T, C) -> (B, T, 2H).

    Mirrors `_xla_lstm_fused_ref` with the kernel's numerics: the input
    projection x @ W_ih + b accumulates in float32 from the input-dtype
    values, the state is float32, and the output has the input dtype.
    """
    outs = []
    for w_ih, b, w_hh, reverse in ((w_ih_f, b_f, w_hh_f, False),
                                   (w_ih_b, b_b, w_hh_b, True)):
        xg = x.float() @ w_ih.float() + b.float()
        outs.append(_scan_plain(xg, w_hh, reverse))
    return torch.cat(outs, dim=-1).to(x.dtype)


def _check_kernel_args(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b):
    """Validate what csrc/lstm_fused.cu takes; raises, never falls back."""
    args = (x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b)
    for a in args:
        if not a.is_contiguous():
            raise ValueError("lstm_scan_fused kernel needs contiguous tensors "
                             "(call .contiguous() on the input first)")
    if x.dtype not in _DTYPE_CODE or any(a.dtype != x.dtype for a in args):
        raise TypeError("lstm_scan_fused kernel takes float32 or bfloat16, "
                        "one dtype for x and all weights; got "
                        f"{sorted({str(a.dtype) for a in args})}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    B, T, C = x.shape
    H = w_hh_f.shape[0]
    shapes = {w_ih_f.shape, w_ih_b.shape}, {w_hh_f.shape, w_hh_b.shape}, {b_f.shape, b_b.shape}
    if shapes != ({(C, 4 * H)}, {(H, 4 * H)}, {(4 * H,)}):
        raise ValueError(f"weight shapes {shapes} do not match C={C}, H={H}")
    if H > _MAX_H or H % 8 or C % 4:
        raise NotImplementedError(
            f"lstm_scan_fused kernel handles H <= {_MAX_H} with H % 8 == 0 and "
            f"C % 4 == 0; got C={C}, H={H}")
    if any(a.device != x.device for a in args) or x.device.type != "cuda":
        raise ValueError("lstm_scan_fused kernel needs all tensors on one CUDA device")
    return B, T, C, H


def _rows_per_block(rows: int, n_sm: int, directions: int = 2) -> int:
    """Rows of one direction per block: the fewest that fit every
    direction's blocks in one wave on the card, else the most."""
    for rt in _ROWS_PER_BLOCK:
        if directions * math.ceil(rows / rt) <= n_sm:
            return rt
    return _ROWS_PER_BLOCK[-1]


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("lstm_fused")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_fused_launch.argtypes = [i, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                      i, i, i, i, i, ptr]
    lib.lstm_fused_launch.restype = ctypes.c_int
    return lib


def _launch_kernel(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b) -> torch.Tensor:
    B, T, C, H = _check_kernel_args(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b)
    out = torch.empty(B, T, 2 * H, device=x.device, dtype=x.dtype)
    if B == 0 or T == 0:
        return out
    lib = _kernel_lib()
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lstm_fused_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w_ih_f.data_ptr(), w_ih_b.data_ptr(),
            b_f.data_ptr(), b_b.data_ptr(), w_hh_f.data_ptr(), w_hh_b.data_ptr(),
            out.data_ptr(), B, T, C, H, _rows_per_block(B, n_sm), stream)
    if err:
        raise RuntimeError(f"lstm_fused kernel launch failed: CUDA error {err}")
    lstm_scan_fused.launches += 1
    key = (B, T, C, H, str(x.dtype).replace("torch.", ""))
    lstm_scan_fused.launches_by_shape[key] = lstm_scan_fused.launches_by_shape.get(key, 0) + 1
    return out


def lstm_scan_fused(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b) -> torch.Tensor:
    """(B, T, C) -> (B, T, 2H) fused-projection bidirectional LSTM.

    When autograd will differentiate the call (grad enabled and any
    input requires grad) it takes the residual-saving training route,
    `_BiLSTMSaving`. Otherwise CUDA tensors go to the hand-written
    inference kernel (csrc/lstm_fused.cu), which replaces
    nvse_tpu/ops/pallas_lstm.py:lstm_scan_fused, and CPU tensors to
    lstm_scan_fused_plain. Counts inference-kernel launches in
    `lstm_scan_fused.launches` (and per (B, T, C, H, dtype) in
    `lstm_scan_fused.launches_by_shape`).
    """
    args = (x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _BiLSTMSaving.apply(*args)
    if x.device.type == "cpu":
        return lstm_scan_fused_plain(*args)
    return _launch_kernel(*args)


lstm_scan_fused.launches = 0
lstm_scan_fused.launches_by_shape = {}


def lstm_scan_plain(x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Unidirectional scan from zero state: (B, T, 4H), (H, 4H) -> (B, T, H)."""
    return _scan_plain(x_proj.float(), w_hh, reverse=False).to(x_proj.dtype)


def lstm_scan(x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Unidirectional LSTM (causal configs). Only the plain CPU version
    exists so far: its TPU kernel (nvse_tpu/ops/pallas_lstm.py
    `_pallas_lstm_scan`) is not ported to CUDA yet, so a CUDA tensor raises."""
    if x_proj.device.type == "cpu":
        return lstm_scan_plain(x_proj, w_hh)
    raise NotImplementedError(
        "lstm_scan has no CUDA kernel yet (TPU kernel "
        "nvse_tpu/ops/pallas_lstm.py:_pallas_lstm_scan is still to be ported)")


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


def _check_seq_args(name: str, x_proj: torch.Tensor, w_hh: torch.Tensor | None, *states):
    """Validate what csrc/lstm_bwd.cu takes; raises, never falls back.
    x_proj (T, R, 4H), w_hh (H, 4H) or None, states (T, R, H) each.
    Returns (T, R, H)."""
    args = (x_proj, *states) if w_hh is None else (x_proj, w_hh, *states)
    for a in args:
        if not a.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous tensors")
    if x_proj.dtype not in _DTYPE_CODE or any(a.dtype != x_proj.dtype for a in args):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, one dtype for all "
                        f"inputs; got {sorted({str(a.dtype) for a in args})}")
    if x_proj.dim() != 3 or (w_hh is not None and w_hh.dim() != 2):
        raise ValueError(f"{name}: x_proj must be (T, R, 4H) and w_hh (H, 4H), got "
                         f"{[tuple(a.shape) for a in args]}")
    T, R, G = x_proj.shape
    H = G // 4
    if ((w_hh is not None and w_hh.shape != (H, 4 * H)) or G != 4 * H
            or any(s.shape != (T, R, H) for s in states)):
        raise ValueError(f"{name}: shapes {[tuple(a.shape) for a in args]} do not match "
                         f"x_proj (T, R, 4H) = {tuple(x_proj.shape)}")
    if H > _MAX_H or H % 8:
        raise NotImplementedError(f"{name} kernel handles H <= {_MAX_H} with H % 8 == 0; "
                                  f"got H={H}")
    if any(a.device != x_proj.device for a in args) or x_proj.device.type != "cuda":
        raise ValueError(f"{name} kernel needs all tensors on one CUDA device")
    return T, R, H


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("lstm_bwd")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_fwd_hc_launch.argtypes = [i, ptr, ptr, ptr, ptr, i, i, i, i, ptr]
    lib.lstm_bwd_launch.argtypes = [i, ptr, ptr, ptr, ptr, ptr, ptr, i, i, i, i, ptr]
    lib.lstm_dw_launch.argtypes = [i, ptr, ptr, ptr, i, i, i, i, ptr]
    for fn in (lib.lstm_fwd_hc_launch, lib.lstm_bwd_launch, lib.lstm_dw_launch):
        fn.restype = ctypes.c_int
    return lib


def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _count(fn, key) -> None:
    fn.launches += 1
    fn.launches_by_shape[key] = fn.launches_by_shape.get(key, 0) + 1


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def lstm_fwd_hc(x_proj: torch.Tensor, w_hh: torch.Tensor):
    """(T, R, 4H), (H, 4H) -> (hs, cs), each (T, R, H): the residual-saving
    forward scan from zero state. CUDA tensors launch the hand-written
    kernel of csrc/lstm_bwd.cu, which replaces
    nvse_tpu/ops/pallas_lstm_bwd.py:lstm_fwd_hc; CPU tensors run
    lstm_fwd_hc_plain. Counts launches in `lstm_fwd_hc.launches` (and per
    (T, R, H, dtype) in `lstm_fwd_hc.launches_by_shape`)."""
    if x_proj.device.type == "cpu":
        return lstm_fwd_hc_plain(x_proj, w_hh)
    T, R, H = _check_seq_args("lstm_fwd_hc", x_proj, w_hh)
    hs = torch.empty(T, R, H, device=x_proj.device, dtype=x_proj.dtype)
    cs = torch.empty_like(hs)
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream(x_proj.device).cuda_stream
        err = _bwd_lib().lstm_fwd_hc_launch(
            _DTYPE_CODE[x_proj.dtype], x_proj.data_ptr(), w_hh.data_ptr(), hs.data_ptr(),
            cs.data_ptr(), R, T, H, _rows_per_block(R, _n_sm(x_proj.device), 1), stream)
    _raise_on(err, "lstm_fwd_hc")
    _count(lstm_fwd_hc, (T, R, H, str(x_proj.dtype).replace("torch.", "")))
    return hs, cs


def lstm_dw_hh(hs: torch.Tensor, dx_proj: torch.Tensor) -> torch.Tensor:
    """dW_hh = sum_{t, r} h_{t-1}^T dx_proj[t] -> float32 (H, 4H). CUDA
    tensors launch the hand-written reduction of csrc/lstm_bwd.cu (the dW
    sum of nvse_tpu/ops/pallas_lstm_bwd.py:lstm_bwd): per-split float32
    partials, added by a torch sum. CPU tensors run lstm_dw_hh_plain.
    Counts launches in `lstm_dw_hh.launches`."""
    if hs.device.type == "cpu":
        return lstm_dw_hh_plain(hs, dx_proj)
    T, R, H = _check_seq_args("lstm_dw_hh", dx_proj, None, hs)
    tiles = math.ceil(4 * H / 64) * math.ceil(H / 64)
    nsplit = max(1, min(math.ceil(T * R / 256), math.ceil(2 * _n_sm(hs.device) / tiles)))
    partial = torch.empty(nsplit, H, 4 * H, device=hs.device, dtype=torch.float32)
    with torch.cuda.device(hs.device):
        stream = torch.cuda.current_stream(hs.device).cuda_stream
        err = _bwd_lib().lstm_dw_launch(_DTYPE_CODE[hs.dtype], hs.data_ptr(),
                                        dx_proj.data_ptr(), partial.data_ptr(), R, T, H,
                                        nsplit, stream)
    _raise_on(err, "lstm_dw_hh")
    _count(lstm_dw_hh, (T, R, H, str(hs.dtype).replace("torch.", "")))
    return partial.sum(0)


def lstm_bwd(x_proj, hs, cs, dhs, w_hh):
    """Reverse-time LSTM backward: (x_proj, hs, cs, dhs, w_hh) ->
    (dx_proj (T, R, 4H), dw_hh (H, 4H)), gates recomputed from the saved
    h_{t-1}. CUDA tensors launch the hand-written recurrence of
    csrc/lstm_bwd.cu, which replaces nvse_tpu/ops/pallas_lstm_bwd.py:
    lstm_bwd, then the dW_hh reduction (lstm_dw_hh); CPU tensors run
    lstm_bwd_plain. Counts recurrence launches in `lstm_bwd.launches`."""
    if x_proj.device.type == "cpu":
        return lstm_bwd_plain(x_proj, hs, cs, dhs, w_hh)
    dx = lstm_bwd_recurrence(x_proj, hs, cs, dhs, w_hh)
    return dx, lstm_dw_hh(hs, dx).to(w_hh.dtype)


def lstm_bwd_recurrence(x_proj, hs, cs, dhs, w_hh) -> torch.Tensor:
    """The reverse-time kernel of lstm_bwd alone (CUDA tensors only):
    -> dx_proj (T, R, 4H). Counts in `lstm_bwd.launches`."""
    T, R, H = _check_seq_args("lstm_bwd", x_proj, w_hh, hs, cs, dhs)
    dx = torch.empty_like(x_proj)
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream(x_proj.device).cuda_stream
        err = _bwd_lib().lstm_bwd_launch(
            _DTYPE_CODE[x_proj.dtype], x_proj.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            dhs.data_ptr(), w_hh.data_ptr(), dx.data_ptr(), R, T, H,
            _rows_per_block(R, _n_sm(x_proj.device), 1), stream)
    _raise_on(err, "lstm_bwd")
    _count(lstm_bwd, (T, R, H, str(x_proj.dtype).replace("torch.", "")))
    return dx


for _fn in (lstm_fwd_hc, lstm_bwd, lstm_dw_hh):
    _fn.launches = 0
    _fn.launches_by_shape = {}


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
