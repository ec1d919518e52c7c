"""iSTFTNet: the MRF trunk upsamples x64, a small inverse STFT does x4, in
PyTorch.

Counterpart of nvse_tpu/models/istftnet.py (reference Models/istftnet.py:
271-328): HiFiGAN's trunk with two upsampling stages (8, 8), leaky_relu(0.01),
a reflection pad of one frame on the left, conv_post to n_fft + 2 = 18
channels, magnitude exp(first 9) and phase sin(last 9), then
ops.spectral.istft_ri at n_fft 16, hop 4 with a Hann window (torch.fft,
cuFFT on the card; the JAX package's matmul DFT is the TPU's). The output is
4 * 64 * T samples for T mel frames, float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.spectral import hann_window, istft_ri
from .hifigan import MRFUpsampler
from .layers import WNConv1d, leaky_relu


class ISTFTNet(MRFUpsampler):
    """mel (B, num_mels, T) -> wave (B, L)."""

    def __init__(self, h, gen: torch.Generator):
        super().__init__(h, gen)
        self.n_fft, self.hop = int(h.gen_istft_n_fft), int(h.gen_istft_hop_size)
        self.conv_post = WNConv1d(self.out_channels, self.n_fft + 2, 7, padding=3, gen=gen)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.trunk(mel.transpose(1, 2)), 0.01)
        x = F.pad(x.transpose(1, 2), (1, 0), mode="reflect")       # (B, C, T + 1)
        x = self.conv_post(x.transpose(1, 2)).transpose(1, 2)       # (B, n_fft + 2, T + 1)
        bins = self.n_fft // 2 + 1
        mag, phase = torch.exp(x[:, :bins]), torch.sin(x[:, bins:])
        return istft_ri(mag * torch.cos(phase), mag * torch.sin(phase), self.n_fft, self.hop,
                        self.n_fft, window=hann_window(self.n_fft))
