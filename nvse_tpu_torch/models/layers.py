"""Linear, LayerNorm and LSTM with torch.nn semantics and the JAX layouts.

Counterparts of nvse_tpu/models/layers.py:466-608. Parameters keep the
JAX package's names and layouts (Linear `kernel` is (in, out); LSTM
`w_ih_*` is (C, 4H), `w_hh_*` (H, 4H)), so utils/jax_params.py maps a
flax tree onto them one to one. Random init draws from the caller's
torch.Generator with the JAX package's distributions.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.lstm import lstm_scan, lstm_scan_fused


def uniform_(shape, bound: float, gen: torch.Generator) -> nn.Parameter:
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
