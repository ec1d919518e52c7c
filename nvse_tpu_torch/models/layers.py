"""Linear, LayerNorm, LSTM, Conv1d, ConvTranspose1d, Conv2d and
ConvTranspose2d with torch.nn semantics.

Counterparts of nvse_tpu/models/layers.py (Linear, LayerNorm, LSTM
:466-608; Conv1d, ConvTranspose1d :138-285; Conv2d, ConvTranspose2d,
leaky_relu, get_padding :37-46, :287-394). Linear and LSTM keep the JAX
package's names and layouts (Linear `kernel` is (in, out); LSTM `w_ih_*`
is (C, 4H), `w_hh_*` (H, 4H)); the weight-normalised Conv2d keeps the
names `v`, `g`, `bias` in torch's OIHW layout, Conv1d, ConvTranspose1d,
PlainConv2d and ConvTranspose2d the names `kernel`, `bias` in torch's
layouts. The 1-D convs take and return the JAX layers' channels-last
(B, T, C). utils/jax_params.py maps a flax
tree onto them one to one. Random init draws from the caller's
torch.Generator with the JAX package's distributions.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.lstm import lstm_scan, lstm_scan_fused, lstm_scan_stateful


def uniform_(shape, bound: float, gen: torch.Generator | None) -> nn.Parameter:
    """U(-bound, bound) parameter drawn on the CPU from `gen`."""
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=gen))


class Linear(nn.Module):
    """torch.nn.Linear semantics, U(+-1/sqrt(fan_in)) init, (in, out) kernel."""

    def __init__(self, in_features: int, out_features: int, gen: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.kernel = uniform_((in_features, out_features), bound, gen)
        self.bias = uniform_((out_features,), bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # follows the params' dtype, keeping a bf16 trunk bf16 through the glue
        return x.to(self.kernel.dtype) @ self.kernel + self.bias


class LayerNorm(nn.Module):
    """torch.nn.LayerNorm over the last dim; stats in float32, output in
    the params' dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return y.to(self.scale.dtype) * self.scale + self.bias


class LSTM(nn.Module):
    """Single-layer (bi)LSTM with torch.nn.LSTM numerics: (B, T, C) ->
    (B, T, H * (2 if bidirectional else 1)).

    The bias of each direction is b_ih + b_hh, summed when the params are
    made. A bidirectional LSTM runs ops.lstm.lstm_scan_fused, a
    unidirectional one ops.lstm.lstm_scan on its time-major projection
    (the CUDA kernels on the card).

    Streaming decode (initial_state / return_state): the forward
    direction starts from `initial_state` (h, c), each (B, H), through
    ops.lstm.lstm_scan_stateful, and the returned state is its (h, c)
    after `carry_idx` steps (default: all), the state the next chunk
    resumes from. The backward direction of a BiLSTM starts from zeros
    over the given window (its true state would need the whole future);
    callers bound that error with a right lookahead. The state is cast to
    the params' dtype on the way in and comes back in it, as in the JAX
    layer. Returns (y, state) when return_state.
    """

    # each holds b_ih + b_hh of the JAX layer and torch.nn.LSTM, two
    # trained tensors in one (see train/trainer.py:make_optimizer)
    summed_biases = ("b_fwd", "b_bwd")

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool,
                 gen: torch.Generator):
        super().__init__()
        self.bidirectional = bidirectional
        H = hidden_size
        bound = 1.0 / math.sqrt(H)
        for d in ("fwd", "bwd") if bidirectional else ("fwd",):
            self.register_parameter(f"w_ih_{d}", uniform_((input_size, 4 * H), bound, gen))
            self.register_parameter(f"w_hh_{d}", uniform_((H, 4 * H), bound, gen))
            b = uniform_((4 * H,), bound, gen).data + uniform_((4 * H,), bound, gen).data
            self.register_parameter(f"b_{d}", nn.Parameter(b))

    def forward(self, x: torch.Tensor, initial_state=None, return_state: bool = False,
                carry_idx: int | None = None):
        x = x.to(self.w_ih_fwd.dtype)
        if initial_state is not None or return_state:
            return self._forward_streaming(x, initial_state, return_state, carry_idx)
        if not self.bidirectional:
            xg = (x.transpose(0, 1) @ self.w_ih_fwd + self.b_fwd).contiguous()   # (T, B, 4H)
            return lstm_scan(xg, self.w_hh_fwd).transpose(0, 1)
        return lstm_scan_fused(x.contiguous(), self.w_ih_fwd, self.w_ih_bwd,
                               self.b_fwd, self.b_bwd, self.w_hh_fwd, self.w_hh_bwd)

    def _forward_streaming(self, x, initial_state, return_state, carry_idx):
        B, S, _ = x.shape
        zero = x.new_zeros(B, self.w_hh_fwd.shape[0])
        if initial_state is None:
            h0 = c0 = zero
        else:
            h0, c0 = (s.to(x.dtype).contiguous() for s in initial_state)
        xt = x.transpose(0, 1)                                               # (S, B, C)
        hs_f, cs_f = lstm_scan_stateful((xt @ self.w_ih_fwd + self.b_fwd).contiguous(),
                                        self.w_hh_fwd, h0, c0)
        ci = S if carry_idx is None else int(carry_idx)
        state = (hs_f[ci - 1], cs_f[ci - 1])
        y = hs_f.transpose(0, 1)
        if self.bidirectional:
            xg_b = (xt @ self.w_ih_bwd + self.b_bwd).flip(0).contiguous()
            hs_b, _ = lstm_scan_stateful(xg_b, self.w_hh_bwd, zero, zero)
            y = torch.cat([y, hs_b.flip(0).transpose(0, 1)], dim=-1)
        return (y, state) if return_state else y


LRELU_SLOPE = 0.1


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=slope)


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    """'same' padding for odd kernels (reference utils.py:47-48)."""
    return (kernel_size * dilation - dilation) // 2


class Conv2d(nn.Module):
    """Weight-normalised torch.nn.Conv2d on NCHW (the discriminators' conv).

    Counterpart of nvse_tpu/models/layers.py:Conv2d with
    use_weight_norm=True (which is NHWC/HWIO). Parameters: `v` (out, in,
    kh, kw), `g` (out, 1, 1, 1) and `bias` (out,); the weight is
    g * v / max(||v||, 1e-12), the norm over every axis but out-channels
    (torch.nn.utils.weight_norm has no 1e-12 floor). Init as torch:
    U(+-1/sqrt(fan_in)) for v and bias, g = ||v||. The input is cast to the
    weight dtype, as the JAX layer follows its params.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=(1, 1),
                 padding=(0, 0), gen: torch.Generator | None = None):
        super().__init__()
        kh, kw = kernel_size
        self.stride, self.padding = tuple(stride), tuple(padding)
        bound = 1.0 / math.sqrt(in_channels * kh * kw)
        self.v = uniform_((out_channels, in_channels, kh, kw), bound, gen)
        self.g = nn.Parameter(self.v.data.flatten(1).norm(dim=1).reshape(-1, 1, 1, 1))
        self.bias = uniform_((out_channels,), bound, gen)

    def kernel(self) -> torch.Tensor:
        norm = self.v.flatten(1).norm(dim=1).reshape(-1, 1, 1, 1)
        return self.g * self.v / torch.clamp(norm, min=1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.kernel(), self.bias, self.stride, self.padding)


def _conv(fn, x, w, bias, stride, padding):
    """fn = F.conv2d or F.conv_transpose2d on NCHW, the input cast to the
    weight dtype as the JAX layers follow their params."""
    if w.dtype == torch.bfloat16 and w.device.type == "cpu":
        # torch's oneDNN bf16 conv2d on the CPU returned NaN for finite
        # inputs (MRD layer 4, (4, 64, 65, 2) * (64, 64, 3, 3), stride 2);
        # float32 of the bf16 values, rounded once, is a bf16 conv with
        # float32 sums
        return fn(x.to(w.dtype).float(), w.float(), bias.float(), stride, padding).to(w.dtype)
    return fn(x.to(w.dtype), w, bias, stride, padding)


def conv2d(x, w, bias, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """torch conv2d: x (B, I, H, W), w (O, I, kh, kw), bias (O,)."""
    return _conv(F.conv2d, x, w, bias, stride, padding)


def conv_transpose2d(x, w, bias, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """torch conv_transpose2d: x (B, I, H, W), w (I, O, kh, kw), bias (O,).
    The JAX layer's form (kernel flipped, input dilated by the stride, padded
    by k - 1 - padding) is this function."""
    return _conv(F.conv_transpose2d, x, w, bias, stride, padding)


class PlainConv2d(nn.Module):
    """torch.nn.Conv2d on NCHW without weight norm (GCRN's convs).
    Counterpart of nvse_tpu/models/layers.py:Conv2d with its defaults;
    parameters `kernel` (out, in, kh, kw) and `bias` (out,), both
    U(+-1/sqrt(in * kh * kw))."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=(1, 1),
                 padding=(0, 0), gen: torch.Generator | None = None):
        super().__init__()
        kh, kw = kernel_size
        self.stride, self.padding = tuple(stride), tuple(padding)
        bound = 1.0 / math.sqrt(in_channels * kh * kw)
        self.kernel = uniform_((out_channels, in_channels, kh, kw), bound, gen)
        self.bias = uniform_((out_channels,), bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.kernel, self.bias, self.stride, self.padding)


class ConvTranspose2d(nn.Module):
    """torch.nn.ConvTranspose2d on NCHW. Counterpart of
    nvse_tpu/models/layers.py:ConvTranspose2d; parameters `kernel`
    (in, out, kh, kw) and `bias` (out,), both U(+-1/sqrt(out * kh * kw)),
    torch's fan-in for a transposed conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=(1, 1),
                 padding=(0, 0), gen: torch.Generator | None = None):
        super().__init__()
        kh, kw = kernel_size
        self.stride, self.padding = tuple(stride), tuple(padding)
        bound = 1.0 / math.sqrt(out_channels * kh * kw)
        self.kernel = uniform_((in_channels, out_channels, kh, kw), bound, gen)
        self.bias = uniform_((out_channels,), bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose2d(x, self.kernel, self.bias, self.stride, self.padding)


class Conv1d(nn.Module):
    """torch.nn.Conv1d on channels-last (B, T, C), without weight norm.
    Counterpart of nvse_tpu/models/layers.py:Conv1d with its defaults;
    parameters `kernel` (out, in / groups, k) and `bias` (out,), both
    U(+-1/sqrt(in / groups * k)). The input is cast to the weight dtype. A
    1x1 conv (stride 1, no padding, one group) is a matrix product over the
    channels; any other runs F.conv1d on (B, C, T)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        bound = 1.0 / math.sqrt(in_channels // groups * kernel_size)
        self.kernel = uniform_((out_channels, in_channels // groups, kernel_size), bound, gen)
        self.bias = uniform_((out_channels,), bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.kernel.dtype)
        if self.kernel.shape[-1] == 1 and self.stride == 1 and self.padding == 0 and self.groups == 1:
            return x @ self.kernel[:, :, 0].T + self.bias
        y = F.conv1d(x.transpose(1, 2), self.kernel, self.bias, self.stride, self.padding,
                     self.dilation, self.groups)
        return y.transpose(1, 2)


class ConvTranspose1d(nn.Module):
    """torch.nn.ConvTranspose1d on channels-last (B, T, C), without weight
    norm: out_len = (T - 1) * stride - 2 * padding + dilation * (k - 1) + 1.
    Counterpart of nvse_tpu/models/layers.py:ConvTranspose1d with its
    defaults (and `dilation`, :193-207); parameters `kernel` (in, out, k) and
    `bias` (out,), both U(+-1/sqrt(out * k)), torch's fan-in for a transposed
    conv. The JAX layer's form (kernel flipped, input dilated by the stride,
    kernel by `dilation`, padded by dilation * (k - 1) - padding) is
    F.conv_transpose1d."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, gen: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        bound = 1.0 / math.sqrt(out_channels * kernel_size)
        self.kernel = uniform_((in_channels, out_channels, kernel_size), bound, gen)
        self.bias = uniform_((out_channels,), bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x.to(self.kernel.dtype).transpose(1, 2), self.kernel, self.bias,
                               self.stride, self.padding, 0, 1, self.dilation)
        return y.transpose(1, 2)
