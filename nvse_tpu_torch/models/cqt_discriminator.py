"""Multi-scale sub-band CQT discriminator (the GAN trainers' opt-in third
discriminator, h.use_cqtd).

Counterpart of nvse_tpu/models/cqt_discriminator.py (reference
Models/models.py:384-592, an Amphion port). Per scale: the wave 2x sinc
upsampled (ops.resample.upsample2), its CQT at twice the sampling rate
(ops.cqt.cqt), real and imaginary parts as 2 channels of a (time, bin)
image, one pre-conv over each octave's bins, a conv to `filters`
channels, the (3, 9) stack dilated (d, 1) in time at stride (1, 2) over
bins with weight norm, a (3, 3) conv and the (3, 3) post conv. NCHW here
(NHWC in the JAX package); logits are flattened in the same order.

Each DiscriminatorCQT holds its convs in `convs`, in the JAX module's order
of creation (its Conv2d_j is convs.j; the wrapper's DiscriminatorCQT_i is
discs.i), so the weight bridge maps them one to one: the pre-convs and the
first conv are plain (kernel, bias), the rest weight-normed (v, g, bias).
The real and the generated wave go through each scale in two calls, real
first, as the JAX module runs them: under the hinge losses one batched call
would turn an exact zero of a post conv's bias gradient into float noise
(models/discriminators.py).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.cqt import cqt
from ..ops.resample import upsample2
from .discriminators import _real_and_generated
from .layers import Conv2d, PlainConv2d, leaky_relu

KS = (3, 9)


def _pad2d(k, d=(1, 1)):
    return ((k[0] - 1) * d[0]) // 2, ((k[1] - 1) * d[1]) // 2


class DiscriminatorCQT(nn.Module):
    """One CQT scale (reference models.py:384-540)."""

    def __init__(self, sampling_rate: int, hop_length: int, n_octaves: int,
                 bins_per_octave: int, filters: int = 32, max_filters: int = 1024,
                 filters_scale: int = 1, dilations: Sequence[int] = (1, 2, 4),
                 in_channels: int = 1, out_channels: int = 1,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.sampling_rate, self.hop_length = int(sampling_rate), int(hop_length)
        self.n_octaves, self.bins_per_octave = int(n_octaves), int(bins_per_octave)
        cin = in_channels * 2
        convs = [PlainConv2d(cin, cin, KS, padding=_pad2d(KS), gen=gen)
                 for _ in range(self.n_octaves)]
        convs.append(PlainConv2d(cin, filters, KS, padding=_pad2d(KS), gen=gen))
        in_chs = min(filters_scale * filters, max_filters)
        for i, d in enumerate(dilations):
            out_chs = min(filters_scale ** (i + 1) * filters, max_filters)
            convs.append(Conv2d(in_chs, out_chs, KS, (1, 2), _pad2d(KS, (d, 1)), gen=gen,
                                dilation=(d, 1)))
            in_chs = out_chs
        out_chs = min(filters_scale ** (len(dilations) + 1) * filters, max_filters)
        k3 = (KS[0], KS[0])
        convs.append(Conv2d(in_chs, out_chs, k3, padding=_pad2d(k3), gen=gen))
        convs.append(Conv2d(out_chs, out_channels, k3, padding=_pad2d(k3), gen=gen))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor):
        """x (B, L) -> (logits (B, N), feature maps: after the first conv, each
        dilated conv and the (3, 3) conv)."""
        n_bins = self.bins_per_octave * self.n_octaves
        re, im = cqt(upsample2(x), 2 * self.sampling_rate, self.hop_length, n_bins,
                     self.bins_per_octave)
        z = torch.stack([re, im], dim=1).transpose(2, 3)        # (B, 2, T, bins)
        bpo, n = self.bins_per_octave, self.n_octaves
        latent = torch.cat([self.convs[i](z[..., i * bpo:(i + 1) * bpo]) for i in range(n)],
                           dim=3)
        fmap = []
        for conv in self.convs[n:-1]:
            latent = leaky_relu(conv(latent), 0.1)
            fmap.append(latent)
        latent = self.convs[-1](latent)
        return latent.reshape(latent.shape[0], -1), fmap


class MultiScaleSubbandCQTDiscriminator(nn.Module):
    """Three CQT scales (reference models.py:543-592)."""

    def __init__(self, sampling_rate: int = 22050, hop_lengths: Sequence[int] = (512, 256, 256),
                 n_octaves: Sequence[int] = (9, 9, 9),
                 bins_per_octaves: Sequence[int] = (24, 36, 48), filters: int = 32,
                 max_filters: int = 1024, filters_scale: int = 1,
                 dilations: Sequence[int] = (1, 2, 4), in_channels: int = 1,
                 out_channels: int = 1, gen: torch.Generator | None = None):
        super().__init__()
        self.discs = nn.ModuleList(
            DiscriminatorCQT(sampling_rate, hop, no, bpo, filters, max_filters, filters_scale,
                             dilations, in_channels, out_channels, gen)
            for hop, no, bpo in zip(hop_lengths, n_octaves, bins_per_octaves))

    @classmethod
    def from_config(cls, h, gen: torch.Generator | None = None):
        """Every cqtd_* key of the reference (models.py:389-397), with its default."""
        return cls(
            sampling_rate=h.sampling_rate,
            hop_lengths=tuple(h.get("cqtd_hop_lengths", (512, 256, 256))),
            n_octaves=tuple(h.get("cqtd_n_octaves", (9, 9, 9))),
            bins_per_octaves=tuple(h.get("cqtd_bins_per_octaves", (24, 36, 48))),
            filters=h.get("cqtd_filters", 32),
            max_filters=h.get("cqtd_max_filters", 1024),
            filters_scale=h.get("cqtd_filters_scale", 1),
            dilations=tuple(h.get("cqtd_dilations", (1, 2, 4))),
            in_channels=h.get("cqtd_in_channels", 1),
            out_channels=h.get("cqtd_out_channels", 1),
            gen=gen,
        )

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """-> (real logits, generated logits, real fmaps, generated fmaps)."""
        return _real_and_generated(self.discs, y, y_hat, batched=False)
