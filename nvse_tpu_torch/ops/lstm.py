"""Bidirectional LSTM with the input projection fused into the recurrence.

Counterpart of nvse_tpu/ops/pallas_lstm.py for `lstm_scan_fused`, the
one TPU kernel family on the BSRNN mel->wave decode path. On a CUDA
tensor `lstm_scan_fused` launches the hand-written kernel in
csrc/lstm_fused.cu (built and loaded by ops/_build.py) or raises; on a
CPU tensor it runs `lstm_scan_fused_plain`, the plain PyTorch version
with the kernel's numerics.

Layouts follow the JAX package: x (B, T, C) batch-first, w_ih (C, 4H),
w_hh (H, 4H), b (4H,) = b_ih + b_hh, gate order (i, f, g, o); the
output is (B, T, 2H) with the forward direction in [:H] and the
backward direction, at its original time index, in [H:].
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

__all__ = ["lstm_scan", "lstm_scan_fused", "lstm_scan_fused_plain", "lstm_scan_plain"]

_MAX_H = 128                    # one thread per gate column: 4H <= 512 threads
_ROWS_PER_BLOCK = (2, 4, 8)     # template instances in csrc/lstm_fused.cu
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


def _rows_per_block(rows: int, n_sm: int) -> int:
    """Rows of one direction per block: the fewest that fit both
    directions' blocks in one wave on the card, else the most."""
    for rt in _ROWS_PER_BLOCK:
        if 2 * math.ceil(rows / rt) <= n_sm:
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

    CUDA tensors go to the hand-written kernel (csrc/lstm_fused.cu),
    which replaces nvse_tpu/ops/pallas_lstm.py:lstm_scan_fused; CPU
    tensors to lstm_scan_fused_plain. Counts kernel launches in
    `lstm_scan_fused.launches` (and per (B, T, C, H, dtype) in
    `lstm_scan_fused.launches_by_shape`).
    """
    if x.device.type == "cpu":
        return lstm_scan_fused_plain(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b)
    return _launch_kernel(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b)


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
