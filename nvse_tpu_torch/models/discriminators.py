"""Discriminators of the GAN trainer: multi-period (MPD), multi-resolution
(MRD, T-F domain) and multi-scale (MSD, time domain).

Counterparts of nvse_tpu/models/discriminators.py:25-200 (reference
Models/models.py:15-113, :187-246, :250-379). Each works on raw waves
(B, L) and returns, per sub-discriminator, logits (B, N) and a list of
feature maps; the wrappers run the real and the generated wave through
every sub-discriminator. Feature maps are NCHW / NCW here (NHWC / NWC in
the JAX package); logits are flattened in the same order.

With `batched` (the default) the real and generated waves go through each
sub-discriminator as one batch: a convolution treats batch rows
independently, so this is the JAX package's two calls in one launch per
layer, equal up to the order of float sums. The order matters under the
hinge losses: where every logit is inside the margins, a post conv's bias
gradient is -1 + 1, an exact 0 from two calls (the reference's and the JAX
package's) and float noise from one, which AdamW's first step turns into a
move of about lr. So the time trainer's hinge models take batched=False, two
calls, real first. The MSD's spectral-norm scale in the D pass takes two
calls either way: the JAX package runs the real wave, updating the
power-iteration vector u, then the generated wave from the updated u.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.spectral import stft_ri
from .layers import Conv2d, SNConv1d, WNConv1d, get_padding, leaky_relu


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


def _both(d: nn.Module, y: torch.Tensor, y_hat: torch.Tensor, batched: bool, **kwargs):
    """(real logits, real fmap, generated logits, generated fmap) of one
    sub-discriminator: one call on the two waves stacked, or two calls, the
    real wave first."""
    if not batched:
        (r, fr), (g, fg) = d(y, **kwargs), d(y_hat, **kwargs)
        return r, fr, g, fg
    n = y.shape[0]
    logits, fmap = d(torch.cat([y, y_hat]), **kwargs)
    return logits[:n], [f[:n] for f in fmap], logits[n:], [f[n:] for f in fmap]


def _real_and_generated(discs: nn.ModuleList, y: torch.Tensor, y_hat: torch.Tensor,
                        batched: bool):
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
    y_hat = y_hat.to(y.dtype)
    for d in discs:
        r, fr, g, fg = _both(d, y, y_hat, batched)
        y_d_rs.append(r)
        y_d_gs.append(g)
        fmap_rs.append(fr)
        fmap_gs.append(fg)
    return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class MultiPeriodDiscriminator(nn.Module):
    """MPD over `periods` (reference Models/models.py:87-113)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 gen: torch.Generator | None = None, batched: bool = True):
        super().__init__()
        self.batched = batched
        self.discs = nn.ModuleList(DiscriminatorP(p, gen) for p in periods)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """-> (real logits, generated logits, real fmaps, generated fmaps)."""
        return _real_and_generated(self.discs, y, y_hat, self.batched)


class MultiResolutionDiscriminator(nn.Module):
    """MRD at (n_fft, hop, win) = (1024, 256, 1024), (2048, 512, 2048),
    (512, 128, 512) (reference Models/models.py:250-280)."""

    def __init__(self, gen: torch.Generator | None = None):
        super().__init__()
        resolutions = ((1024, 256, 1024), (2048, 512, 2048), (512, 128, 512))
        self.discs = nn.ModuleList(DiscriminatorR(r, gen) for r in resolutions)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """-> (real logits, generated logits, real fmaps, generated fmaps)."""
        return _real_and_generated(self.discs, y, y_hat, batched=True)


class DiscriminatorS(nn.Module):
    """Scale discriminator (reference Models/models.py:187-214): seven grouped
    Conv1d stages and a post conv on the wave as one channel; spectral norm
    (SNConv1d) on the first MSD scale, weight norm on the others. NCW
    inside: each conv takes its normalised kernel and runs F.conv1d."""

    # (in, out, kernel, stride, groups, padding)
    SPEC = ((1, 128, 15, 1, 1, 7), (128, 128, 41, 2, 4, 20), (128, 256, 41, 2, 16, 20),
            (256, 512, 41, 4, 16, 20), (512, 1024, 41, 4, 16, 20), (1024, 1024, 41, 1, 16, 20),
            (1024, 1024, 5, 1, 1, 2), (1024, 1, 3, 1, 1, 1))

    def __init__(self, use_spectral_norm: bool = False, gen: torch.Generator | None = None):
        super().__init__()
        self.use_spectral_norm = use_spectral_norm
        if use_spectral_norm:
            convs = [SNConv1d(ci, co, k, s, p, g, gen=gen) for ci, co, k, s, g, p in self.SPEC]
        else:
            convs = [WNConv1d(ci, co, k, s, p, groups=g, gen=gen)
                     for ci, co, k, s, g, p in self.SPEC]
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        """x (B, L); update_stats advances each SNConv1d's u (spectral norm)."""
        fmap = []
        x = x[:, None]                                           # (B, 1, L)
        for i, conv in enumerate(self.convs):
            w = conv.weight(update_stats) if self.use_spectral_norm else conv.weight()
            x = F.conv1d(x.to(w.dtype), w, conv.bias, conv.stride, conv.padding, 1, conv.groups)
            if i < len(self.convs) - 1:
                x = leaky_relu(x)
            fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


def avg_pool1d_4_2_pad2(x: torch.Tensor) -> torch.Tensor:
    """torch AvgPool1d(4, 2, padding=2) with count_include_pad=True on (B, L)."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=2, count_include_pad=True)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    """MSD: the wave and two 2x average-pooled copies (reference
    Models/models.py:217-246); the first scale spectral-normalised."""

    def __init__(self, gen: torch.Generator | None = None, batched: bool = True):
        super().__init__()
        self.batched = batched
        self.discs = nn.ModuleList(DiscriminatorS(i == 0, gen) for i in range(3))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor, update_stats: bool):
        """-> (real logits, generated logits, real fmaps, generated fmaps).
        update_stats (the D pass): the spectral-norm scale advances u on the
        real wave, then again on the generated one, as the JAX module's two
        calls; without it (the G pass) u is read only."""
        y_hat = y_hat.to(y.dtype)
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for i, d in enumerate(self.discs):
            if i:
                y, y_hat = avg_pool1d_4_2_pad2(y), avg_pool1d_4_2_pad2(y_hat)
            batched = self.batched and not (update_stats and d.use_spectral_norm)
            r, fr, g, fg = _both(d, y, y_hat, batched, update_stats=update_stats)
            y_d_rs.append(r)
            y_d_gs.append(g)
            fmap_rs.append(fr)
            fmap_gs.append(fg)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
