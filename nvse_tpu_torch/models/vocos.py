"""Vocos, in PyTorch.

Counterpart of nvse_tpu/models/vocos.py (Siuzdak, 2023; the reference
repo ships no implementation): mel -> embedding conv -> LayerNorm ->
ConvNeXt blocks -> LayerNorm -> Linear head of n_fft + 2 channels (log
magnitude, phase) -> iSTFT. Widths from the config's vocos_dim (512),
vocos_num_layers (8) and vocos_intermediate_dim (1536). Returns the T-F
5-tuple with log(clamp(amp, 1e-5)), the magnitude's log clipped at 12
before exp.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.spectral import hann_window, istft_ri
from .apnet import INIT_STD, ConvNeXtBlock
from .layers import Conv1d, LayerNorm, Linear, get_padding


class Vocos(nn.Module):
    """mel (B, M, T) -> (logamp, pha, rea, imag, wav)."""

    def __init__(self, h, gen: torch.Generator):
        super().__init__()
        self.n_fft, self.hop_size, self.win_size = h.n_fft, h.hop_size, h.win_size
        dim = int(h.get("vocos_dim", 512))
        mid = int(h.get("vocos_intermediate_dim", 1536))
        self.embed = Conv1d(h.num_mels, dim, 7, padding=get_padding(7), gen=gen, std=INIT_STD)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.convnext = nn.ModuleList(ConvNeXtBlock(dim, mid, gen)
                                      for _ in range(int(h.get("vocos_num_layers", 8))))
        self.final_layer_norm = LayerNorm(dim, eps=1e-6)
        self.head = Linear(dim, h.n_fft + 2, gen, std=INIT_STD)

    def forward(self, mel: torch.Tensor):
        x = self.norm(self.embed(mel.transpose(-1, -2)))           # (B, T, dim)
        for blk in self.convnext:
            x = blk(x)
        head = self.head(self.final_layer_norm(x)).transpose(-1, -2)   # (B, n_fft + 2, T)
        F_bins = self.n_fft // 2 + 1
        logamp, phase = head[:, :F_bins], head[:, F_bins:]
        amp = torch.exp(torch.clamp(logamp, max=12.0))
        rea = amp * torch.cos(phase)
        imag = amp * torch.sin(phase)
        wav = istft_ri(rea, imag, self.n_fft, self.hop_size, self.win_size,
                       window=hann_window(self.win_size))
        return torch.log(torch.clamp(amp, min=1e-5)), phase, rea, imag, wav
