"""HiFiGAN: the MRF residual blocks, the upsampling trunk and the generator,
in PyTorch.

Counterpart of nvse_tpu/models/hifigan.py (reference Models/hifigan.py:19-133):
a weight-normalised conv_pre, then per upsampling rate a leaky ReLU, a
weight-normalised transposed conv and the average of the multi-receptive-field
residual blocks (ResBlock1 or ResBlock2, one per kernel size), then
leaky_relu(0.01), conv_post to one channel and tanh. ResBlock1 is also the
block of APNet's trunks; the trunk (MRFUpsampler) is shared with iSTFTNet
(models/istftnet.py).

Layout: the mel is (B, num_mels, T) as in the reference; inside, everything
is channels-last (B, T, C), as in the JAX package. The modules keep the
reference's names (conv_pre, ups.{i}, resblocks.{k}.convs1 / convs2 /
convs.{j}, conv_post), so utils.torch_import maps a reference g_ checkpoint
onto them by name. Weight norm is not folded in training; the engine folds it
at load (fold_weight_norm), the transposed convs too.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import LRELU_SLOPE, WNConv1d, WNConvTranspose1d, get_padding, leaky_relu


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


class ResBlock2(nn.Module):
    """Per dilation d: leaky_relu -> dilated conv, added to the input
    (reference hifigan.py:59-76; `convs` as it names them)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3),
                 gen: torch.Generator | None = None):
        super().__init__()
        c, k = channels, kernel_size
        self.convs = nn.ModuleList(WNConv1d(c, c, k, dilation=d, padding=get_padding(k, d),
                                            gen=gen) for d in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = conv(leaky_relu(x, LRELU_SLOPE)) + x
        return x


class MRFUpsampler(nn.Module):
    """conv_pre and the upsample / MRF trunk shared by HiFiGAN and iSTFTNet
    (hifigan.py:75-119 of the JAX package): `trunk` maps (B, T, num_mels) to
    (B, T * prod(rates), C_final). Its modules sit at the top of the
    generator's state_dict, under the reference's names."""

    def __init__(self, h, gen: torch.Generator):
        super().__init__()
        c0 = int(h.upsample_initial_channel)
        self.conv_pre = WNConv1d(int(h.num_mels), c0, 7, padding=3, gen=gen)
        block = ResBlock1 if str(h.resblock) == "1" else ResBlock2
        kernels, dilations = list(h.resblock_kernel_sizes), list(h.resblock_dilation_sizes)
        self.num_kernels = len(kernels)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            self.ups.append(WNConvTranspose1d(c0 // (2 ** i), ch, int(k), stride=int(u),
                                              padding=(int(k) - int(u)) // 2, gen=gen))
            self.resblocks.extend(block(ch, int(kr), tuple(dr), gen=gen)
                                  for kr, dr in zip(kernels, dilations))
        self.out_channels = c0 // (2 ** len(self.ups))

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(x)
        n = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x, LRELU_SLOPE))
            xs = self.resblocks[i * n](x)
            for blk in self.resblocks[i * n + 1 : (i + 1) * n]:
                xs = xs + blk(x)
            x = xs / n
        return x


class HiFiGAN(MRFUpsampler):
    """mel (B, num_mels, T) -> wave (B, T * prod(upsample_rates))."""

    def __init__(self, h, gen: torch.Generator):
        super().__init__(h, gen)
        self.conv_post = WNConv1d(self.out_channels, 1, 7, padding=3, gen=gen)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.trunk(mel.transpose(1, 2))
        x = self.conv_post(leaky_relu(x, 0.01))   # torch F.leaky_relu's default slope
        return torch.tanh(x)[..., 0]
