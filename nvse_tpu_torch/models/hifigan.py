"""HiFiGAN's multi-receptive-field residual block, in PyTorch.

Counterpart of nvse_tpu/models/hifigan.py:ResBlock1 (reference
Models/hifigan.py:19-57), the block of APNet's trunks. Channels-last
(B, T, C), weight norm on every conv. The HiFiGAN generator itself is not
ported yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import LRELU_SLOPE, WNConv1d, get_padding, leaky_relu


class ResBlock1(nn.Module):
    """Per dilation d: leaky_relu -> dilated conv -> leaky_relu -> plain
    conv, added to the input. `convs1` holds the dilated convs and `convs2`
    the plain ones, as the reference names them."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3, 5),
                 gen: torch.Generator | None = None):
        super().__init__()
        c, k = channels, kernel_size
        self.convs1 = nn.ModuleList(WNConv1d(c, c, k, dilation=d, padding=get_padding(k, d),
                                             gen=gen) for d in dilation)
        self.convs2 = nn.ModuleList(WNConv1d(c, c, k, padding=get_padding(k), gen=gen)
                                    for _ in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(leaky_relu(c1(leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE)) + x
        return x
