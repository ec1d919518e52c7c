"""Griffin-Lim phase reconstruction (fixed iteration count), in PyTorch.

Counterpart of nvse_tpu/ops/griffin_lim.py: torchaudio.transforms.GriffinLim
semantics as the reference's ConvTasNet front end uses them (n_iter 32,
momentum 0.99, power 1, random initial phase). Each iteration is the classic
round trip, istft at the natural length hop * (T - 1), then stft cropped to
T frames, then the momentum step. The JAX package's frame-domain rewrite
(`_roundtrip_frames`) is a TPU device computing the same composition, which
its own tests hold against this loop. On the card the transforms are cuFFT
calls in float32 (ops/spectral.py).

The initial phase is explicit: `theta` (..., F, T) in radians, or a uniform
draw on [-pi, pi) from `generator` (a CPU torch.Generator; default seed 0),
moved to the magnitude's device. The port cannot reproduce the JAX
package's `jax.random.PRNGKey(0)` draw, so a port decode equals a JAX
decode only when the JAX draw is passed in as theta.
"""
from __future__ import annotations

import math

import torch

from .spectral import device_cache, hann_window, istft_ri, stft_ri

__all__ = ["default_phase", "griffin_lim", "random_phase"]


def random_phase(shape, generator: torch.Generator | None = None,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """Uniform phase on [-pi, pi) of `shape`, drawn on the CPU from
    `generator` (default: seeded 0) and moved to `device`, float32."""
    gen = torch.Generator().manual_seed(0) if generator is None else generator
    theta = torch.rand(tuple(shape), generator=gen) * (2 * math.pi) - math.pi
    return theta.to(device)


@device_cache(maxsize=16)
def default_phase(shape: tuple, device: torch.device) -> torch.Tensor:
    """The initial phase the mel front ends (ConvTasNet, HD-Demucs) take
    for "rand" and "griffin_lim" when no theta is passed: random_phase's
    seed-0 draw, made once per shape and device, so the card's decode and
    the CPU's start from the same phase."""
    # made with inference mode off: a tensor first made under
    # torch.inference_mode() (a decode) could not be saved for backward later
    with torch.inference_mode(False):
        return random_phase(shape, None, device)


def griffin_lim(magnitude: torch.Tensor, n_fft: int, hop_size: int, win_size: int,
                n_iter: int = 32, momentum: float = 0.99, theta: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                length: int | None = None) -> torch.Tensor:
    """magnitude (..., F, T) -> waveform (..., L), float32.

    The iterations run at the natural length hop * (T - 1); `length` (as
    torchaudio's) crops only the final synthesis.
    """
    mag = magnitude.float()
    win = hann_window(win_size)
    T = mag.shape[-1]
    natural_len = hop_size * (T - 1)
    if theta is None:
        theta = random_phase(mag.shape, generator, mag.device)
    theta = theta.to(mag.device, torch.float32)
    ang_re, ang_im = torch.cos(theta), torch.sin(theta)
    tprev_re = torch.zeros_like(mag)
    tprev_im = torch.zeros_like(mag)
    mom = momentum / (1.0 + momentum)
    for _ in range(n_iter):
        inv = istft_ri(mag * ang_re, mag * ang_im, n_fft, hop_size, win_size, window=win,
                       length=natural_len)
        re, im = stft_ri(inv, n_fft, hop_size, win_size, window=win)
        re, im = re[..., :T], im[..., :T]
        a_re = re - mom * tprev_re
        a_im = im - mom * tprev_im
        norm = torch.sqrt(a_re * a_re + a_im * a_im) + 1e-16
        ang_re, ang_im, tprev_re, tprev_im = a_re / norm, a_im / norm, re, im
    return istft_ri(mag * ang_re, mag * ang_im, n_fft, hop_size, win_size, window=win,
                    length=natural_len if length is None else length)
