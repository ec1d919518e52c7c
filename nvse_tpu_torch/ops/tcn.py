"""ConvTasNet's fused TCN block tail: gLN -> dilated depthwise conv (k = 3)
-> concatenated res|skip 1x1 -> residual add.

Counterpart of nvse_tpu/ops/pallas_tcn.py. `tcn_block_tail` folds the
global layer norm into per-batch scale and shift (a, b2) (one pass, m2 - m1^2
clamped at 0, as `_tail_fwd_impl`, pallas_tcn.py:168-182), then runs the tail:
  * on a CUDA tensor the fold is the statistics kernel of csrc/tcn_tail.cu
    (`tcn_gln_fold_kernel`: one read of c, two stages in a fixed order) and the
    tail its hand-written kernel (`tcn_block_tail_kernel`: wgmma in bfloat16 and
    float16, register-blocked float32 FMAs, the plan of `tail_plan`); each
    raises on what it does not take;
  * on a CPU tensor the fold is `_fold` (a plain PyTorch reduction) and the
    tail `tcn_block_tail_plain`.
Outside autograd the entry calls the registered operator
`nvse_torch::tcn_block_tail` (ops/library.py), which runs the two above by the
tensor's device: one node of a torch.export graph.
Under autograd it is `_TailRecompute`, whose backward recomputes the fold
and the plain tail and differentiates them (the custom VJP of
pallas_tcn.py:185-205). Tail launches are counted in `tcn_block_tail.launches`,
per (B, T, H, Bc, dilation, dtype) in `tcn_block_tail.launches_by_shape`
and per kernel in `tcn_block_tail.launches_by_kernel`, where the statistics
kernel counts under its own key, "tcn_gln_stats"; `tcn_gln_fold_kernel`
counts its launches per (B, T, H, dtype) too.

Layouts follow the JAX package: c (B, T, H) the PReLU'd output of the
block's input 1x1, x (B, T, Bc) the residual stream, gln_w / gln_b (1, H),
w_dw (3, H), b_dw (1, H), w_rs (H, 2 Bc) = [res | skip], b_rs (1, 2 Bc).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from .lstm import _DTYPE_CODE, _ITEM, _count, _device_index, _n_sm, _raise_on, _reset_counts

__all__ = ["tail_plan", "tcn_block_tail", "tcn_block_tail_kernel", "tcn_block_tail_plain",
           "tcn_gln_fold_kernel"]

_SOURCE = "tcn_tail"               # csrc/tcn_tail.cu
_STATS_KEY = "tcn_gln_stats"       # the statistics kernel's key in launches_by_kernel
_MAX_B = 65535                     # the statistics kernel's grid: (P, B)
_MAX_ROWS = 2 ** 31 - 1            # B x T a tile index can hold
# csrc/tcn_tail.cu's tiles: time steps and output columns of a tile, and its
# instances as (channels a chunk, stages of the ring), in the order the plan
# prefers them (its `with_tail`)
_BM, _BN = 128, 256
_TAIL = {torch.bfloat16: ((64, 3), (32, 3), (16, 3)),
         torch.float16: ((64, 3), (32, 3), (16, 3)),      # the bfloat16 kernel's instances
         torch.float32: ((32, 2), (16, 2), (8, 2))}


def _tail_smem(kc: int, stages: int, d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the tail at a chunk of kc channels, `stages`
    stages and dilation d (its `smem_bytes`): a stage holds the w_rs chunk
    (kc x 256), BM + 2 min(d, BM) staged rows of c (kc + 16 bytes long) and the
    chunk's constants, each part 128-byte aligned; float32 adds the q tile
    [kc][BM + 4]; bfloat16 stages start on 1024 bytes (the swizzle atoms of the
    w_rs chunk), with 1024 bytes of slack to align the first."""
    up = lambda v, m=128: -(-v // m) * m
    item = _ITEM[dtype]
    rows = _BM + 2 * min(d, _BM)
    stage = (kc * _BN * item + up(rows * (kc + 16 // item) * item)
             + up(2 * kc * 4 + 4 * kc * item))
    if dtype == torch.float32:
        return stages * stage + kc * (_BM + 4) * 4
    return stages * up(stage, 1024) + 1024


def tail_plan(B: int, T: int, H: int, Bc: int, d: int, dtype: torch.dtype, n_sm: int,
              smem_limit: int) -> dict:
    """Launch plan of the tail (csrc/tcn_tail.cu) at c (B, T, H), x (B, T, Bc) and
    dilation d on a card with n_sm SMs and smem_limit bytes of shared memory a
    block: tiles of 128 time steps x 256 output columns, one persistent block an
    SM (at most one a tile) walking them in T order, and the first instance
    (channels a chunk, ring stages) whose stages fit: bfloat16 chunks of 64
    channels in 3 stages where d leaves room (d <= 64 on an H100), else of 32;
    float32 chunks of 32 in 2 stages. Larger chunks beat deeper rings (a fourth
    stage of 64 was 3-5 % slower than three, chunks of 32 17-19 % slower than 64
    at d = 32 and 64: scripts/bench_torch_scan_plan.py --kernel tail); float16
    as bfloat16 (the same wgmma kernel). -> kc,
    stages, smem_bytes, tiles, blocks, tensor_cores, fits (False: nothing fits;
    the kernel cannot run)."""
    tiles = B * math.ceil(T / _BM) * math.ceil(2 * Bc / _BN)
    for kc, stages in _TAIL[dtype]:
        smem = _tail_smem(kc, stages, d, dtype)
        if smem <= smem_limit:
            return dict(kc=kc, stages=stages, smem_bytes=smem, tiles=tiles,
                        blocks=max(1, min(tiles, n_sm)), tensor_cores=dtype != torch.float32,
                        fits=True)
    return dict(fits=False, tiles=tiles)


def gln_stats_partials(B: int, T: int, H: int, n_sm: int) -> int:
    """The statistics kernel's runs a batch element (P): four blocks an SM over
    the batch, each of at least 4,096 elements."""
    return max(1, min(math.ceil(4 * n_sm / B), math.ceil(T * H / 4096)))


def tcn_block_tail_plain(c, x, a, b2, w_dw, b_dw, w_rs, b_rs, dilation: int):
    """Plain PyTorch version of the kernel: (e (B, T, Bc), skip (B, T, Bc)),
    both in x's dtype, from c (B, T, H), x (B, T, Bc) and the folded gLN
    a, b2 (B, H) float32.

    The numerics of the Pallas kernel (`_tcn_kernel`, pallas_tcn.py:85-111):
    n = c * a + b2 in float32; taps outside [0, T) read 0 after the norm;
    the three taps and b_dw in float32; q rounded once to w_rs's dtype, the
    product summed in float32, plus b_rs; e = x + out[..., :Bc]. (In
    bfloat16 and float16 the XLA tail `_xla_tail` also rounds n before the depthwise
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
    if B * math.ceil(T / _BM) * math.ceil(2 * Bc / _BN) > _MAX_ROWS:
        raise NotImplementedError(f"tcn_tail kernel takes fewer than 2^31 tiles of "
                                  f"{_BM} x {_BN}; got B={B}, T={T}, Bc={Bc}")
    if not isinstance(dilation, int) or dilation < 1:
        raise ValueError(f"tcn_block_tail: dilation must be an int >= 1, got {dilation!r}")
    args = (c, x, w_dw, b_dw, w_rs, b_rs)
    if c.dtype not in _DTYPE_CODE or any(t.dtype != c.dtype for t in args):
        raise TypeError("tcn_tail kernel takes float32, bfloat16 or float16, one dtype for c, x "
                        f"and the weights; got {sorted({str(t.dtype) for t in args})}")
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
    lib.tcn_tail_launch.argtypes = [i, *[ptr] * 10, *[i] * 10, ptr]
    lib.tcn_gln_stats_launch.argtypes = [i, i, *[ptr] * 6, i, i, i, i, ctypes.c_float, i, ptr]
    for fn in (lib.tcn_tail_launch, lib.tcn_gln_stats_launch):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _card_tail_plan(index: int, B: int, T: int, H: int, Bc: int, d: int,
                    dtype: torch.dtype) -> dict:
    """tail_plan on card `index` (its SMs and shared memory); cached, as the
    wrapper's host time counts."""
    props = torch.cuda.get_device_properties(index)
    return tail_plan(B, T, H, Bc, d, dtype, props.multi_processor_count,
                     props.shared_memory_per_block_optin)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def tcn_block_tail_kernel(c, x, a, b2, w_dw, b_dw, w_rs, b_rs, dilation: int, plan=None):
    """Launch the tail kernel of csrc/tcn_tail.cu (replaces
    nvse_tpu/ops/pallas_tcn.py:_pallas_tail) on CUDA tensors: the function
    of tcn_block_tail_plain, with the plan of `tail_plan` on this card (or the
    given one: the plan bench). Counts the launch on `tcn_block_tail`."""
    B, T, H, Bc = _check_kernel_args(c, x, a, b2, w_dw, b_dw, w_rs, b_rs, dilation)
    e = torch.empty(B, T, Bc, device=c.device, dtype=x.dtype)
    s = torch.empty_like(e)
    if B == 0 or T == 0 or Bc == 0:
        return e, s
    w = [t.contiguous() for t in (w_dw, b_dw, w_rs, b_rs)]
    a, b2 = a.contiguous(), b2.contiguous()
    item = _ITEM[c.dtype]
    vec = int(H % (16 // item) == 0 and (2 * Bc) % (16 // item) == 0
              and _aligned(c, x, a, b2, *w))
    plan = plan or _card_tail_plan(_device_index(c.device), B, T, H, Bc, dilation, c.dtype)
    if not plan["fits"]:
        raise RuntimeError(f"tcn_tail at d={dilation}, {c.dtype}: no instance's shared memory "
                           f"fits this card ({plan})")
    ptrs = [t.data_ptr() for t in (c, x, a, b2, *w, e, s)]
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = _kernel_lib().tcn_tail_launch(
            _DTYPE_CODE[c.dtype], *ptrs, B, T, H, Bc, dilation, plan["kc"], plan["stages"],
            plan["blocks"], plan["smem_bytes"], vec, stream)
    _raise_on(err, _SOURCE)
    _count(tcn_block_tail, (B, T, H, Bc, dilation, str(c.dtype).replace("torch.", "")), _SOURCE)
    return e, s


def tcn_gln_fold_kernel(c, gln_w, gln_b, eps: float):
    """The gLN fold of `_fold` by the statistics kernel of csrc/tcn_tail.cu on
    CUDA tensors: c (B, T, H) read once, a float32 sum and sum of squares a
    batch element in two stages of fixed order (no float atomics: two runs give
    the same bits), then a, b2 (B, H) float32. Counts the launch on
    `tcn_gln_fold_kernel` and under "tcn_gln_stats" in
    `tcn_block_tail.launches_by_kernel`."""
    if c.dim() != 3 or not c.is_contiguous():
        raise ValueError(f"tcn_gln_stats kernel needs a contiguous c (B, T, H), got "
                         f"{tuple(c.shape)}")
    B, T, H = c.shape
    if gln_w.numel() != H or gln_b.numel() != H:
        raise ValueError(f"tcn_gln_stats: gln_w / gln_b of {gln_w.numel()} / {gln_b.numel()} "
                         f"values for H = {H}")
    if c.dtype not in _DTYPE_CODE or gln_w.dtype not in _DTYPE_CODE or gln_b.dtype != gln_w.dtype:
        raise TypeError("tcn_gln_stats kernel takes float32, bfloat16 or float16 c and one of "
                        f"them for gln_w and gln_b; got {c.dtype}, {gln_w.dtype}, {gln_b.dtype}")
    if any(t.device != c.device for t in (gln_w, gln_b)) or c.device.type != "cuda":
        raise ValueError("tcn_gln_stats kernel needs all tensors on one CUDA device")
    if B > _MAX_B:
        raise NotImplementedError(f"tcn_gln_stats kernel takes B <= {_MAX_B}; got B={B}")
    a = torch.empty(B, H, device=c.device, dtype=torch.float32)
    b2 = torch.empty_like(a)
    if B == 0:
        return a, b2
    if T == 0:
        raise ValueError("tcn_gln_stats: the mean over T = 0 steps is not defined")
    gw, gb = gln_w.contiguous(), gln_b.contiguous()
    P = gln_stats_partials(B, T, H, _n_sm(c.device))
    part = torch.empty(B, P, 2, device=c.device, dtype=torch.float32)
    vec = int((T * H * _ITEM[c.dtype]) % 16 == 0 and _aligned(c))
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = _kernel_lib().tcn_gln_stats_launch(
            _DTYPE_CODE[c.dtype], _DTYPE_CODE[gw.dtype], c.data_ptr(), gw.data_ptr(),
            gb.data_ptr(), part.data_ptr(), a.data_ptr(), b2.data_ptr(), B, T, H, P, eps, vec,
            stream)
    _raise_on(err, f"{_SOURCE} ({_STATS_KEY})")
    _count(tcn_gln_fold_kernel, (B, T, H, str(c.dtype).replace("torch.", "")), _STATS_KEY)
    tcn_block_tail.launches_by_kernel[_STATS_KEY] = (
        tcn_block_tail.launches_by_kernel.get(_STATS_KEY, 0) + 1)
    return a, b2


def _tail(c, x, gln_w, gln_b, w_dw, b_dw, w_rs, b_rs, dilation, eps):
    if c.device.type == "cpu":
        a, b2 = _fold(c, gln_w, gln_b, eps)
        return tcn_block_tail_plain(c, x, a, b2, w_dw, b_dw, w_rs, b_rs, dilation)
    a, b2 = tcn_gln_fold_kernel(c, gln_w, gln_b, eps)
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
    Shapes as in the module docstring; CUDA tensors go to the statistics and
    tail kernels of csrc/tcn_tail.cu (each raises on what it does not take), CPU
    tensors to `_fold` and tcn_block_tail_plain, differentiable calls to
    `_TailRecompute`."""
    args = (c, x, gln_w, gln_b, w_dw, b_dw, w_rs, b_rs)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _TailRecompute.apply(*args, dilation, eps)
    return torch.ops.nvse_torch.tcn_block_tail(*args, int(dilation), float(eps))


_reset_counts(tcn_block_tail, tcn_gln_fold_kernel)
