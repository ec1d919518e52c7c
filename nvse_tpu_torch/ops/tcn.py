"""ConvTasNet's fused TCN block tail: gLN -> dilated depthwise conv (k = 3)
-> concatenated res|skip 1x1 -> residual add.

Counterpart of nvse_tpu/ops/pallas_tcn.py. `tcn_block_tail` folds the
global layer norm into per-batch scale and shift (a, b2) with a plain
PyTorch reduction (one pass, m2 - m1^2 clamped at 0, as `_tail_fwd_impl`,
pallas_tcn.py:168-182), then
  * on a CUDA tensor launches the hand-written kernel of csrc/tcn_tail.cu
    (`tcn_block_tail_kernel`), or raises;
  * on a CPU tensor runs `tcn_block_tail_plain`.
Under autograd it is `_TailRecompute`, whose backward recomputes the fold
and the plain tail and differentiates them (the custom VJP of
pallas_tcn.py:185-205). Launches are counted in `tcn_block_tail.launches`,
per (B, T, H, Bc, dilation, dtype) in `tcn_block_tail.launches_by_shape`
and per kernel source in `tcn_block_tail.launches_by_kernel`.

Layouts follow the JAX package: c (B, T, H) the PReLU'd output of the
block's input 1x1, x (B, T, Bc) the residual stream, gln_w / gln_b (1, H),
w_dw (3, H), b_dw (1, H), w_rs (H, 2 Bc) = [res | skip], b_rs (1, 2 Bc).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .lstm import _DTYPE_CODE, _count, _raise_on, _reset_counts

__all__ = ["tcn_block_tail", "tcn_block_tail_kernel", "tcn_block_tail_plain"]

_SOURCE = "tcn_tail"               # csrc/tcn_tail.cu
_MAX_GRID_YZ = 65535               # the kernel's grid: (T / 64, 2 Bc / 256, B)


def tcn_block_tail_plain(c, x, a, b2, w_dw, b_dw, w_rs, b_rs, dilation: int):
    """Plain PyTorch version of the kernel: (e (B, T, Bc), skip (B, T, Bc)),
    both in x's dtype, from c (B, T, H), x (B, T, Bc) and the folded gLN
    a, b2 (B, H) float32.

    The numerics of the Pallas kernel (`_tcn_kernel`, pallas_tcn.py:85-111):
    n = c * a + b2 in float32; taps outside [0, T) read 0 after the norm;
    the three taps and b_dw in float32; q rounded once to w_rs's dtype, the
    product summed in float32, plus b_rs; e = x + out[..., :Bc]. (In
    bfloat16 the XLA tail `_xla_tail` also rounds n before the depthwise
    conv; this follows the kernel.)
    """
    T, H = c.shape[1:]
    Bc, d = x.shape[-1], int(dilation)
    n = F.pad(c.float() * a[:, None, :] + b2[:, None, :], (0, 0, d, d))
    wd = w_dw.float().reshape(3, H)
    q = (n[:, :T] * wd[0] + n[:, d : d + T] * wd[1] + n[:, 2 * d : 2 * d + T] * wd[2]
         + b_dw.float().reshape(H))
    out = q.to(w_rs.dtype).float() @ w_rs.float() + b_rs.float().reshape(2 * Bc)
    return (x.float() + out[..., :Bc]).to(x.dtype), out[..., Bc:].to(x.dtype)


def _fold(c, gln_w, gln_b, eps: float):
    """gLN as n = c * a + b2 per batch row: a, b2 (B, H) float32."""
    m1 = c.mean(dim=(1, 2), dtype=torch.float32)[:, None]
    m2 = c.float().square().mean(dim=(1, 2))[:, None]
    rstd = torch.rsqrt(torch.clamp(m2 - m1 * m1, min=0.0) + eps)
    a = gln_w.float().reshape(1, -1) * rstd
    return a, gln_b.float().reshape(1, -1) - m1 * a


def _check_kernel_args(c, x, a, b2, w_dw, b_dw, w_rs, b_rs, dilation):
    """Validate what csrc/tcn_tail.cu takes; raises, never falls back.
    Returns (B, T, H, Bc)."""
    if c.dim() != 3 or x.dim() != 3 or x.shape[:2] != c.shape[:2]:
        raise ValueError(f"tcn_block_tail: c must be (B, T, H) and x (B, T, Bc), got "
                         f"{tuple(c.shape)} and {tuple(x.shape)}")
    B, T, H = c.shape
    Bc = x.shape[-1]
    if w_dw.dim() != 2 or w_dw.shape[1] != H or w_dw.shape[0] != 3:
        raise NotImplementedError(f"tcn_tail kernel takes a depthwise kernel of 3 taps, w_dw "
                                  f"(3, H={H}); got {tuple(w_dw.shape)}")
    if (tuple(w_rs.shape) != (H, 2 * Bc) or b_dw.numel() != H or b_rs.numel() != 2 * Bc
            or tuple(a.shape) != (B, H) or tuple(b2.shape) != (B, H)):
        raise ValueError(f"tcn_block_tail: shapes {[tuple(t.shape) for t in (a, b2, b_dw, w_rs, b_rs)]}"
                         f" do not match B={B}, H={H}, Bc={Bc}")
    if B > _MAX_GRID_YZ or (2 * Bc + 255) // 256 > _MAX_GRID_YZ:
        raise NotImplementedError(f"tcn_tail kernel takes B <= {_MAX_GRID_YZ} and "
                                  f"2 Bc <= {256 * _MAX_GRID_YZ}; got B={B}, Bc={Bc}")
    if not isinstance(dilation, int) or dilation < 1:
        raise ValueError(f"tcn_block_tail: dilation must be an int >= 1, got {dilation!r}")
    args = (c, x, w_dw, b_dw, w_rs, b_rs)
    if c.dtype not in _DTYPE_CODE or any(t.dtype != c.dtype for t in args):
        raise TypeError("tcn_tail kernel takes float32 or bfloat16, one dtype for c, x and the "
                        f"weights; got {sorted({str(t.dtype) for t in args})}")
    if a.dtype != torch.float32 or b2.dtype != torch.float32:
        raise TypeError("tcn_tail kernel takes the folded gLN a, b2 in float32")
    if not (c.is_contiguous() and x.is_contiguous()):
        raise ValueError("tcn_tail kernel needs contiguous c and x")
    if any(t.device != c.device for t in (*args, a, b2)) or c.device.type != "cuda":
        raise ValueError("tcn_tail kernel needs all tensors on one CUDA device")
    return B, T, H, Bc


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library(_SOURCE)
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.tcn_tail_launch.argtypes = [i, *[ptr] * 10, i, i, i, i, i, ptr]
    lib.tcn_tail_launch.restype = ctypes.c_int
    return lib


def tcn_block_tail_kernel(c, x, a, b2, w_dw, b_dw, w_rs, b_rs, dilation: int):
    """Launch the kernel of csrc/tcn_tail.cu (replaces
    nvse_tpu/ops/pallas_tcn.py:_pallas_tail) on CUDA tensors: the function
    of tcn_block_tail_plain. Counts the launch on `tcn_block_tail`."""
    B, T, H, Bc = _check_kernel_args(c, x, a, b2, w_dw, b_dw, w_rs, b_rs, dilation)
    e = torch.empty(B, T, Bc, device=c.device, dtype=x.dtype)
    s = torch.empty_like(e)
    if B == 0 or T == 0 or Bc == 0:
        return e, s
    w = [t.contiguous() for t in (w_dw, b_dw, w_rs, b_rs)]
    a, b2 = a.contiguous(), b2.contiguous()
    ptrs = [t.data_ptr() for t in (c, x, a, b2, *w, e, s)]
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = _kernel_lib().tcn_tail_launch(_DTYPE_CODE[c.dtype], *ptrs, B, T, H, Bc,
                                            dilation, stream)
    _raise_on(err, _SOURCE)
    _count(tcn_block_tail, (B, T, H, Bc, dilation, str(c.dtype).replace("torch.", "")), _SOURCE)
    return e, s


def _tail(c, x, gln_w, gln_b, w_dw, b_dw, w_rs, b_rs, dilation, eps):
    a, b2 = _fold(c, gln_w, gln_b, eps)
    if c.device.type == "cpu":
        return tcn_block_tail_plain(c, x, a, b2, w_dw, b_dw, w_rs, b_rs, dilation)
    return tcn_block_tail_kernel(c, x, a, b2, w_dw, b_dw, w_rs, b_rs, dilation)


class _TailRecompute(torch.autograd.Function):
    """The tail under autograd: forward as tcn_block_tail (the kernel on
    the card), backward through the fold and the plain tail recomputed."""

    @staticmethod
    def forward(ctx, c, x, gln_w, gln_b, w_dw, b_dw, w_rs, b_rs, dilation, eps):
        ctx.save_for_backward(c, x, gln_w, gln_b, w_dw, b_dw, w_rs, b_rs)
        ctx.dilation, ctx.eps = dilation, eps
        return _tail(c, x, gln_w, gln_b, w_dw, b_dw, w_rs, b_rs, dilation, eps)

    @staticmethod
    def backward(ctx, de, ds):
        need = ctx.needs_input_grad[:8]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            c, x, gln_w, gln_b, *w = leaves
            a, b2 = _fold(c, gln_w, gln_b, ctx.eps)
            outs = tcn_block_tail_plain(c, x, a, b2, *w, ctx.dilation)
            wanted = [t for t, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(outs, wanted, (de, ds)))
        return (*[next(got) if n else None for n in need], None, None)


def tcn_block_tail(c, x, gln_w, gln_b, w_dw, b_dw, w_rs, b_rs, dilation: int,
                   eps: float = 1e-5):
    """Fused TCN block tail: (e_next, skip), each (B, T, Bc) in x's dtype.
    Shapes as in the module docstring; CUDA tensors go to the kernel of
    csrc/tcn_tail.cu (it raises on what it does not take), CPU tensors to
    tcn_block_tail_plain, differentiable calls to `_TailRecompute`."""
    args = (c, x, gln_w, gln_b, w_dw, b_dw, w_rs, b_rs)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _TailRecompute.apply(*args, dilation, eps)
    return _tail(*args, dilation, eps)


_reset_counts(tcn_block_tail)
