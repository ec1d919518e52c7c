"""Discriminators of the T-F trainer: multi-period (MPD) and multi-resolution (MRD).

Counterparts of nvse_tpu/models/discriminators.py:25-81 and :147-200
(reference Models/models.py:15-113, :250-379). Each works on raw waves
(B, L) and returns, per sub-discriminator, logits (B, N) and a list of
feature maps; the wrappers run the real and the generated wave through
every sub-discriminator. Feature maps are NCHW here (NHWC in the JAX
package); logits are flattened in the same (H, W) order.

The real and generated waves go through each sub-discriminator as one
batch: a convolution treats batch rows independently, so this is the
JAX package's two calls in one launch per layer.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.spectral import stft_ri
from .layers import Conv2d, get_padding, leaky_relu


class DiscriminatorP(nn.Module):
    """Period discriminator: the wave reshaped to (L/period, period), four
    (5, 1) weight-norm convs of stride 3, one of stride 1, and a post conv. As the reference,
    every conv has padding get_padding(5, 1) = 2, whatever its kernel."""

    def __init__(self, period: int, gen: torch.Generator | None = None):
        super().__init__()
        self.period = period
        pad = (get_padding(5, 1), 0)
        chans = [(1, 32), (32, 128), (128, 512), (512, 1024)]
        convs = [Conv2d(ci, co, (5, 1), (3, 1), pad, gen=gen) for ci, co in chans]
        convs.append(Conv2d(1024, 1024, (5, 1), (1, 1), (2, 0), gen=gen))
        convs.append(Conv2d(1024, 1, (3, 1), (1, 1), (1, 0), gen=gen))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor):
        b, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x[:, None], (0, n_pad), mode="reflect")[:, 0]
            t += n_pad
        x = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for conv in self.convs[:-1]:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.convs[-1](x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class DiscriminatorR(nn.Module):
    """Resolution discriminator on the rectangular-window |STFT| as a
    1-channel (freq, time) image: five weight-norm convs and a post conv.
    The magnitude is sqrt(re^2 + im^2 + 1e-12), as in the reference."""

    def __init__(self, resolution: Sequence[int], gen: torch.Generator | None = None):
        super().__init__()
        self.resolution = tuple(resolution)
        spec = [(1, 64, (7, 5), (2, 2), (3, 2)),
                (64, 64, (5, 3), (2, 1), (2, 1)),
                (64, 64, (5, 3), (2, 2), (2, 1)),
                (64, 64, (3, 3), (2, 1), (1, 1)),
                (64, 64, (3, 3), (2, 2), (1, 1))]
        convs = [Conv2d(ci, co, k, s, p, gen=gen) for ci, co, k, s, p in spec]
        convs.append(Conv2d(64, 1, (3, 3), (1, 1), (1, 1), gen=gen))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor):
        n_fft, hop, win = self.resolution
        re, im = stft_ri(x, n_fft, hop, win, window=None)
        z = torch.sqrt(re * re + im * im + 1e-12)[:, None]      # (B, 1, F, T)
        fmap = []
        for conv in self.convs[:-1]:
            z = leaky_relu(conv(z))
            fmap.append(z)
        z = self.convs[-1](z)
        fmap.append(z)
        return z.reshape(z.shape[0], -1), fmap


def _real_and_generated(discs: nn.ModuleList, y: torch.Tensor, y_hat: torch.Tensor):
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
    n = y.shape[0]
    both = torch.cat([y, y_hat.to(y.dtype)])
    for d in discs:
        logits, fmap = d(both)
        y_d_rs.append(logits[:n])
        y_d_gs.append(logits[n:])
        fmap_rs.append([f[:n] for f in fmap])
        fmap_gs.append([f[n:] for f in fmap])
    return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class MultiPeriodDiscriminator(nn.Module):
    """MPD over `periods` (reference Models/models.py:87-113)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 gen: torch.Generator | None = None):
        super().__init__()
        self.discs = nn.ModuleList(DiscriminatorP(p, gen) for p in periods)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """-> (real logits, generated logits, real fmaps, generated fmaps)."""
        return _real_and_generated(self.discs, y, y_hat)


class MultiResolutionDiscriminator(nn.Module):
    """MRD at (n_fft, hop, win) = (1024, 256, 1024), (2048, 512, 2048),
    (512, 128, 512) (reference Models/models.py:250-280)."""

    def __init__(self, gen: torch.Generator | None = None):
        super().__init__()
        resolutions = ((1024, 256, 1024), (2048, 512, 2048), (512, 128, 512))
        self.discs = nn.ModuleList(DiscriminatorR(r, gen) for r in resolutions)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """-> (real logits, generated logits, real fmaps, generated fmaps)."""
        return _real_and_generated(self.discs, y, y_hat)
