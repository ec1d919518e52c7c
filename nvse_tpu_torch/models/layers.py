"""Linear, LayerNorm, LSTM and Conv2d with torch.nn semantics.

Counterparts of nvse_tpu/models/layers.py (Linear, LayerNorm, LSTM
:466-608; Conv2d, leaky_relu, get_padding :37-46, :287-342). Linear and
LSTM keep the JAX package's names and layouts (Linear `kernel` is
(in, out); LSTM `w_ih_*` is (C, 4H), `w_hh_*` (H, 4H)); Conv2d keeps the
names `v`, `g`, `bias` in torch's OIHW layout. utils/jax_params.py maps
a flax tree onto them one to one. Random init draws from the caller's
torch.Generator with the JAX package's distributions.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.lstm import lstm_scan, lstm_scan_fused


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
    made. A bidirectional LSTM runs ops.lstm.lstm_scan_fused (the CUDA
    kernel on the card). A unidirectional one runs ops.lstm.lstm_scan,
    which has only its plain CPU version so far. The streaming arguments
    of the JAX layer belong to a later slice.
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
                carry_idx: int | None = None) -> torch.Tensor:
        if initial_state is not None or return_state or carry_idx is not None:
            raise NotImplementedError(
                "streaming LSTM state is not ported yet (TPU kernel "
                "nvse_tpu/ops/pallas_lstm.py:_pallas_lstm_scan_stateful)")
        x = x.to(self.w_ih_fwd.dtype)
        if not self.bidirectional:
            return lstm_scan(x @ self.w_ih_fwd + self.b_fwd, self.w_hh_fwd)
        return lstm_scan_fused(x.contiguous(), self.w_ih_fwd, self.w_ih_bwd,
                               self.b_fwd, self.b_bwd, self.w_hh_fwd, self.w_hh_bwd)


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
        w = self.kernel()
        if w.dtype == torch.bfloat16 and w.device.type == "cpu":
            # torch's oneDNN bf16 conv2d on the CPU returned NaN for finite
            # inputs (MRD layer 4, (4, 64, 65, 2) * (64, 64, 3, 3), stride 2);
            # float32 of the bf16 values, rounded once, is a bf16 conv with
            # float32 sums
            return F.conv2d(x.to(w.dtype).float(), w.float(), self.bias.float(), self.stride,
                            self.padding).to(w.dtype)
        return F.conv2d(x.to(w.dtype), w, self.bias, self.stride, self.padding)
