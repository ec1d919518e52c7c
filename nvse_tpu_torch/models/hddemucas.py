"""HD-Demucs: a waveform restorer over a phase-initialised wave, in PyTorch.

Counterpart of nvse_tpu/models/hddemucas.py (reference
Models/hddemucas.py:127-370): pseudo-inverse mel (|.| clamped at 1e-5) ->
an initial wave with zero, random or Griffin-Lim phase (32 iterations) ->
sinc 4x upsampling -> `depth` GLU conv encoder stages -> a 2-layer BiLSTM
bottleneck with a 2H -> H projection (two unidirectional LSTMs and no
projection when causal) -> two decoders (suppression masks with sigmoid
gates; refinement maps through dilated transposed convs that add the mask
decoder's outputs as skips) -> a learned fusion block and the scalar
`weight` -> sinc 4x downsampling.

Layout: channels-last (B, L, C), as the JAX package. The bottleneck's
BiLSTMs (H = 768 at the shipped width, C = 768 and 1536) run
ops.lstm.lstm_scan_fused, which past its fused kernels takes the
projection in torch and one lstm_scan_bidir2 launch a layer (on the card
mode kScanBidir of csrc/lstm_scan_wide.cu); causal, each LSTM is one
lstm_scan.

Init: every encoder and decoder conv is drawn as torch draws it and
rescaled by (std / rescale) ** 0.5 (the kernel by its own standard
deviation, the bias by U(-b, b)'s, as the JAX initialisers do,
hddemucas.py:29-48); the fusion convs keep torch's defaults.

The DSP front (inverse mel, the initial phase, Griffin-Lim) runs in
float32 and the resampling convs in their input's dtype; the trunk follows
its params' dtype. The initial phase of "rand" and "griffin_lim" is `theta`
when the caller passes one, else ops.griffin_lim.default_phase, the draw
ConvTasNet takes too (not the JAX package's jax.random.PRNGKey(0) one).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.griffin_lim import default_phase, griffin_lim
from ..ops.resample import downsample2, upsample2
from ..ops.spectral import hann_window, inverse_mel, istft_ri
from .layers import LSTM, Conv1d, ConvTranspose1d, Linear, leaky_relu


def _rescaled(conv: nn.Module, fan_in: int, reference: float) -> nn.Module:
    """Divide a freshly drawn conv's kernel by (std(kernel) / reference) ** 0.5
    and its bias by the same of U(-b, b)'s standard deviation b / sqrt(3)."""
    with torch.no_grad():
        conv.kernel.div_((conv.kernel.std(unbiased=False) / reference) ** 0.5)
        bound = 1.0 / math.sqrt(fan_in)
        conv.bias.div_(((bound / math.sqrt(3.0)) / reference) ** 0.5)
    return conv


def _glu(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


class BLSTM(nn.Module):
    """The 2-layer bottleneck (hddemucas.py:55-72): two BiLSTMs and a 2H -> H
    Linear; with bi=False (causal) two unidirectional LSTMs, no projection."""

    def __init__(self, dim: int, bi: bool, gen: torch.Generator):
        super().__init__()
        self.lstm0 = LSTM(dim, dim, bi, gen)
        self.lstm1 = LSTM(2 * dim if bi else dim, dim, bi, gen)
        self.linear = Linear(2 * dim, dim, gen) if bi else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.lstm1(self.lstm0(x))
        return self.linear(y) if self.linear is not None else y


class _Stage(nn.Module):
    """One encoder stage (strided conv, ReLU, 1x1 GLU) or decoder stage (1x1
    GLU, transposed conv); the rest of each stage is in HDDemucas.forward."""

    def __init__(self, first: nn.Module, second: nn.Module):
        super().__init__()
        self.first, self.second = first, second


class HDDemucas(nn.Module):
    """mel (B, M, T) -> wave (B, hop * (T - 1)). `inv_mel_amp` (B, F, T), when
    given, replaces the clamped pseudo-inverse-mel amplitude; `theta`
    (B, F, T), when given, is the initial phase of "rand" and "griffin_lim"."""

    def __init__(self, h, gen: torch.Generator):
        super().__init__()
        self.mel_args = (h.n_fft, h.num_mels, h.sampling_rate, h.hop_size,
                         h.win_size, h.fmin, h.fmax)
        self.n_fft, self.hop_size, self.win_size = h.n_fft, h.hop_size, h.win_size
        self.init_phase = str(h.init_phase).lower()
        self.depth, self.kernel_size, self.stride = int(h.depth), int(h.kernel_size), int(h.stride)
        self.resample, self.normalize = int(h.resample), bool(h.normalize)
        # 2x stages of the resampling: one at resample >= 2, two at 4 (hddemucas.py:159-163)
        self.n_resample = int(self.resample >= 2) + int(self.resample == 4)
        causal = bool(h.get("causal", False))
        k, s, ref = self.kernel_size, self.stride, float(h.rescale)

        # channel plan per depth: (in, out, hidden)
        chans, chin, chout, hidden = [], int(h.chin), int(h.chout), int(h.hidden)
        for _ in range(self.depth):
            chans.append((chin, chout, hidden))
            chin = chout = hidden
            hidden = min(int(float(h.growth) * hidden), int(h.max_hidden))

        def conv(ci, co, kk, stride=1):
            return _rescaled(Conv1d(ci, co, kk, stride=stride, gen=gen), ci * kk, ref)

        def convt(ci, co, dilation=1, padding=0):
            return _rescaled(ConvTranspose1d(ci, co, k, stride=s, padding=padding,
                                             dilation=dilation, gen=gen), co * k, ref)

        self.encoder = nn.ModuleList(_Stage(conv(ci, hi, k, s), conv(hi, 2 * hi, 1))
                                     for ci, _co, hi in chans)
        self.lstm = BLSTM(chans[-1][2], not causal, gen)
        # decoders coarse -> fine: stage s serves depth index depth - 1 - s
        coarse = chans[::-1]
        self.decoder_mask = nn.ModuleList(_Stage(conv(hi, 2 * hi, 1), convt(hi, co))
                                          for _ci, co, hi in coarse)
        self.decoder_map = nn.ModuleList(
            _Stage(conv(hi, 2 * hi, 1), convt(hi, co, dilation=2 * idx + 1, padding=7 * idx))
            for idx, (_ci, co, hi) in zip(range(self.depth - 1, -1, -1), coarse))
        self.fusion = nn.ModuleList(Conv1d(2, 2, 3, padding=1, gen=gen) for _ in range(3))
        self.weight = nn.Parameter(torch.tensor(0.5))

    def valid_length(self, length: int) -> int:
        """The nearest length the strided convs take whole (hddemucas.py:247-262)."""
        length = math.ceil(length * self.resample)
        for _ in range(self.depth):
            length = max(math.ceil((length - self.kernel_size) / self.stride) + 1, 1)
        for _ in range(self.depth):
            length = (length - 1) * self.stride + self.kernel_size
        return int(math.ceil(length / self.resample))

    def _initial_wave(self, inv_amp: torch.Tensor, theta: torch.Tensor | None):
        """Phase-init synthesis (reference hddemucas.py:276-290), float32."""
        args = (self.n_fft, self.hop_size, self.win_size)
        if self.init_phase == "zero":
            return istft_ri(inv_amp, torch.zeros_like(inv_amp), *args,
                            window=hann_window(self.win_size))
        if theta is None:
            theta = default_phase(tuple(inv_amp.shape), inv_amp.device)
        if self.init_phase == "rand":
            return istft_ri(inv_amp * torch.cos(theta), inv_amp * torch.sin(theta), *args,
                            window=hann_window(self.win_size))
        return griffin_lim(inv_amp, *args, n_iter=32, theta=theta)

    def forward(self, mel: torch.Tensor, inv_mel_amp: torch.Tensor | None = None,
                theta: torch.Tensor | None = None) -> torch.Tensor:
        if inv_mel_amp is None:
            inv_amp = torch.clamp(torch.abs(inverse_mel(mel, *self.mel_args)), min=1e-5)
        else:
            inv_amp = inv_mel_amp
        mix = self._initial_wave(inv_amp, theta)[..., None]      # (B, L, 1)
        if self.normalize:
            mean = mix.mean(dim=(1, 2), keepdim=True)
            std = mix.std(dim=(1, 2), keepdim=True, unbiased=False)
            mix = (mix - mean) / (1e-5 + std)
        else:
            mean, std = 0.0, 1.0
        length = mix.shape[1]

        x = F.pad(mix, (0, 0, 0, self.valid_length(length) - length)).transpose(1, 2)
        for _ in range(self.n_resample):
            x = upsample2(x)
        x = x_us = x.transpose(1, 2)                              # (B, L', 1)

        skips_mask = []
        for stage in self.encoder:
            x = _glu(stage.second(torch.relu(stage.first(x))))
            skips_mask.append(x)
        x = self.lstm(x)

        skips_map, x_mask = [], x
        for step, stage in enumerate(self.decoder_mask):
            idx = self.depth - 1 - step
            x_mask = stage.second(_glu(stage.first(x_mask + skips_mask[idx])))
            if idx > 0:
                x_mask = torch.sigmoid(x_mask)
            skips_map.append(x_mask)
        x_map = x
        for step, stage in enumerate(self.decoder_map):
            x_map = stage.second(_glu(stage.first(x_map)))
            if self.depth - 1 - step > 0:
                x_map = torch.relu(x_map)
            x_map = x_map + skips_map[step]

        d_s, d_r = x_mask * x_us, x_map                           # (B, L', 1) each
        fb = torch.cat([d_s, d_r], dim=-1)
        fb = leaky_relu(self.fusion[0](fb), 0.01)
        fb = leaky_relu(self.fusion[1](fb), 0.01)
        fb = torch.sigmoid(self.fusion[2](fb))
        w = self.weight
        out = (d_s * (1.0 - w) * fb[..., :1] + d_r * w * fb[..., 1:]).transpose(1, 2)
        for _ in range(self.n_resample):
            out = downsample2(out)
        return (out[..., :length] * std + mean)[:, 0, :]
