"""The port's inference kernels as registered operators (namespace `nvse_torch`).

Each operator is one node of a `torch.export` graph and one dispatcher call
in eager mode. On a CUDA tensor it takes the route its wrapper in ops/lstm.py
or ops/tcn.py takes (the route and launch plan picked at run time on the card
that serves: `_card_fused_route`, `bidir2_plan`, `tail_plan`) and launches the
hand-written kernel, which counts its launch; on a CPU tensor it runs the plain
PyTorch version. Each has a fake implementation giving the output shapes and
dtypes, so that export traces through it without running a kernel:

  * `nvse_torch::lstm_scan_fused` (x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b)
    -> (B, T, 2H): the bidirectional LSTM of `lstm_scan_fused` without
    `lengths` (csrc/lstm_fused.cu, csrc/lstm_fused_wide.cu, or past them and in
    float16 the projection and `nvse_torch::lstm_scan_bidir2`);
  * `nvse_torch::lstm_scan` (x_proj, w_hh) -> hs (T, R, H): the scan from zero
    state (csrc/lstm_scan.cu, csrc/lstm_scan_wide.cu);
  * `nvse_torch::lstm_scan_bidir2` (xp_a, xp_b, w_a, w_b) -> (hs_a, hs_b): two
    scans in one launch on the route `bidir2_plan` picks;
  * `nvse_torch::tcn_block_tail` (c, x, gln_w, gln_b, w_dw, b_dw, w_rs, b_rs,
    dilation, eps) -> (e_next, skip): the gLN statistics kernel and the tail
    kernel of csrc/tcn_tail.cu.

The wrappers' inference entries call these operators, so an eager decode and
a loaded artifact run the same code. Importing `nvse_tpu_torch.ops` registers
them; a process that loads an exported artifact must import this module (or
the package) first. The training routes (the autograd Functions) and
`lstm_scan_stateful` do not go through them.
"""
from __future__ import annotations

import torch
from torch import Tensor

from . import lstm as _lstm
from . import tcn as _tcn

__all__ = ["NAMESPACE", "lstm_scan", "lstm_scan_bidir2", "lstm_scan_fused", "tcn_block_tail"]

NAMESPACE = "nvse_torch"


@torch.library.custom_op(f"{NAMESPACE}::lstm_scan_fused", mutates_args=())
def lstm_scan_fused(x: Tensor, w_ih_f: Tensor, w_ih_b: Tensor, b_f: Tensor, b_b: Tensor,
                    w_hh_f: Tensor, w_hh_b: Tensor) -> Tensor:
    args = (x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b)
    if x.device.type == "cpu":
        return _lstm.lstm_scan_fused_plain(*args)
    if _lstm._card_fused_route(x, x.shape[-1], w_hh_f.shape[0]).startswith("projection+"):
        return _lstm._projected_bidir2(*args)
    return _lstm._launch_kernel(*args)


@lstm_scan_fused.register_fake
def _(x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b):
    return x.new_empty(x.shape[0], x.shape[1], 2 * w_hh_f.shape[0])


@torch.library.custom_op(f"{NAMESPACE}::lstm_scan", mutates_args=())
def lstm_scan(x_proj: Tensor, w_hh: Tensor) -> Tensor:
    if x_proj.device.type == "cpu":
        return _lstm.lstm_scan_plain(x_proj, w_hh)
    return _lstm._launch_scan(_lstm.lstm_scan, x_proj, w_hh)[0]


@lstm_scan.register_fake
def _(x_proj, w_hh):
    return x_proj.new_empty(x_proj.shape[0], x_proj.shape[1], w_hh.shape[0])


@torch.library.custom_op(f"{NAMESPACE}::lstm_scan_bidir2", mutates_args=())
def lstm_scan_bidir2(xp_a: Tensor, xp_b: Tensor, w_a: Tensor,
                     w_b: Tensor) -> tuple[Tensor, Tensor]:
    if xp_a.device.type == "cpu":
        return _lstm.lstm_scan_bidir2_plain(xp_a, xp_b, w_a, w_b)
    return _lstm._launch_bidir2_entry(xp_a, xp_b, w_a, w_b)


@lstm_scan_bidir2.register_fake
def _(xp_a, xp_b, w_a, w_b):
    shape = (xp_a.shape[0], xp_a.shape[1], w_a.shape[0])
    return xp_a.new_empty(shape), xp_a.new_empty(shape)


@torch.library.custom_op(f"{NAMESPACE}::tcn_block_tail", mutates_args=())
def tcn_block_tail(c: Tensor, x: Tensor, gln_w: Tensor, gln_b: Tensor, w_dw: Tensor,
                   b_dw: Tensor, w_rs: Tensor, b_rs: Tensor, dilation: int,
                   eps: float) -> tuple[Tensor, Tensor]:
    return _tcn._tail(c, x, gln_w, gln_b, w_dw, b_dw, w_rs, b_rs, dilation, eps)


@tcn_block_tail.register_fake
def _(c, x, gln_w, gln_b, w_dw, b_dw, w_rs, b_rs, dilation, eps):
    return x.new_empty(x.shape), x.new_empty(x.shape)
