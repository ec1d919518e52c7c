"""ConvTasNet: a time-domain mask refiner over a phase-initialised waveform,
in PyTorch.

Counterpart of nvse_tpu/models/convtasnet.py (reference
Models/convtasnet.py:8-328): the pseudo-inverse mel magnitude (|.| clamped
at 1e-5) becomes an initial waveform with zero, random or Griffin-Lim phase
(32 iterations), then a TasNet refiner cleans it up: a stride-L/2 Conv1d
encoder, gLN and a 1x1 bottleneck, R repeats of X dilated TCN blocks
(1x1 -> PReLU -> norm -> depthwise conv -> residual 1x1 and skip 1x1), a
1x1 mask head applied raw (the reference builds a mask activation and never
calls it) and a transposed-conv decoder. The blocks' PReLU_2 / norm_2,
which the reference constructs and its forward never calls, are not built.

Layout: channels-last (B, T, C), as the JAX package. With `fused_tcn` on, a
block whose tail the fused op covers (skip connections, non-causal, k = 3,
gLN) runs it through ops.tcn.tcn_block_tail: on the card one launch of the
kernel of csrc/tcn_tail.cu per block. The wrapper raises on a shape its
kernel does not take; no block silently takes the unfused path.

The DSP front runs in float32 (the inverse mel basis is float32, so a
bfloat16 mel promotes); the trunk follows its params' dtype. The initial
phase of "rand" and "griffin_lim" is `theta` when the caller passes one,
else ops.griffin_lim.default_phase (a uniform draw from a CPU
torch.Generator seeded 0, made once per shape and device, which HD-Demucs
shares): the card's decode and the CPU's start from the same phase. It
is not the JAX package's jax.random.PRNGKey(0) draw.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.griffin_lim import default_phase, griffin_lim
from ..ops.spectral import hann_window, inverse_mel, istft_ri
from ..ops.tcn import tcn_block_tail
from .layers import Conv1d, ConvTranspose1d


class PReLU(nn.Module):
    """torch.nn.PReLU with one shared alpha (init 0.25)."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.tensor(0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class GlobalLayerNorm(nn.Module):
    """gLN over (time, channels) jointly on (B, T, C), two-pass variance
    (reference convtasnet.py:8-48); `weight` / `bias` (1, 1, C)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(1, 1, dim))
        self.bias = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        return self.weight * (x - mean) / torch.sqrt(var + self.eps) + self.bias


class ChannelLayerNorm(nn.Module):
    """Per-frame LayerNorm over channels on (B, T, C) ('cln' of the
    reference's select_norm, convtasnet.py:50-70); `weight` / `bias` (C,)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return self.weight * (x - mean) / torch.sqrt(var + self.eps) + self.bias


def _select_norm(norm: str, dim: int) -> nn.Module:
    n = norm.lower()
    if n == "gln":
        return GlobalLayerNorm(dim)
    if n == "cln":
        return ChannelLayerNorm(dim)
    raise ValueError(f"unsupported ConvTasNet norm {norm!r} (gln|cln)")


class Conv1DBlock(nn.Module):
    """TCN block (reference convtasnet.py:125-167): x (B, T, Bc) ->
    (x + res, skip or None). A causal block pads d * (k - 1) on both sides
    and crops the right after the depthwise conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, dilation: int,
                 skip_con: bool, causal: bool = False, norm: str = "gln",
                 fused_tcn: bool = False, gen: torch.Generator | None = None):
        super().__init__()
        self.dilation, self.skip_con, self.causal = dilation, skip_con, causal
        self.fused = (fused_tcn and skip_con and not causal and kernel_size == 3
                      and norm.lower() == "gln")
        full = dilation * (kernel_size - 1)
        self.pad = full if causal else full // 2
        self.conv_in = Conv1d(in_channels, out_channels, 1, gen=gen)
        self.prelu = PReLU()
        self.norm = _select_norm(norm, out_channels)
        self.dwconv = Conv1d(out_channels, out_channels, kernel_size, groups=out_channels,
                             padding=self.pad, dilation=dilation, gen=gen)
        self.res_conv = Conv1d(out_channels, in_channels, 1, gen=gen)
        self.skip_conv = Conv1d(out_channels, in_channels, 1, gen=gen) if skip_con else None

    def forward(self, x: torch.Tensor):
        x = x.to(self.conv_in.kernel.dtype)
        c = self.prelu(self.conv_in(x))
        if self.fused:
            H = c.shape[-1]
            res, skip = self.res_conv, self.skip_conv
            w_rs = torch.cat([res.kernel[:, :, 0].T, skip.kernel[:, :, 0].T], dim=1)
            b_rs = torch.cat([res.bias, skip.bias]).reshape(1, -1)
            return tcn_block_tail(c.contiguous(), x.contiguous(), self.norm.weight.reshape(1, H),
                                  self.norm.bias.reshape(1, H), self.dwconv.kernel[:, 0, :].T,
                                  self.dwconv.bias.reshape(1, H), w_rs, b_rs, self.dilation)
        c = self.dwconv(self.norm(c))
        if self.causal and self.pad:
            c = c[:, : -self.pad]
        out = x + self.res_conv(c)
        return out, (self.skip_conv(c) if self.skip_con else None)


class ConvTasNet(nn.Module):
    """mel (B, M, T) -> wave (B, hop * (T - 1)). `inv_mel_amp` (B, F, T),
    when given, replaces the clamped pseudo-inverse-mel amplitude; `theta`
    (B, F, T), when given, is the initial phase of "rand" and "griffin_lim"."""

    def __init__(self, h, gen: torch.Generator):
        super().__init__()
        self.mel_args = (h.n_fft, h.num_mels, h.sampling_rate, h.hop_size,
                         h.win_size, h.fmin, h.fmax)
        self.n_fft, self.hop_size, self.win_size = h.n_fft, h.hop_size, h.win_size
        self.init_phase = str(h.init_phase).lower()
        self.skip_con = bool(h.skip_con)
        N, L, Bc, H, P = int(h.N), int(h.L), int(h.B), int(h.H), int(h.P)
        causal, norm = bool(h.get("causal", False)), str(h.get("norm", "gln"))
        fused = bool(h.get("fused_tcn", False))
        self.encoder = Conv1d(1, N, L, stride=L // 2, gen=gen)
        self.enc_norm = GlobalLayerNorm(N)
        self.bottleneck = Conv1d(N, Bc, 1, gen=gen)
        self.blocks = nn.ModuleList(
            Conv1DBlock(Bc, H, P, 2 ** i, self.skip_con, causal, norm, fused, gen)
            for _ in range(int(h.R)) for i in range(int(h.X)))
        self.mask_conv = Conv1d(Bc, int(h.num_spks) * N, 1, gen=gen)
        self.decoder = ConvTranspose1d(N, 1, L, stride=L // 2, gen=gen)

    def _initial_wave(self, inv_amp: torch.Tensor, theta: torch.Tensor | None):
        """Phase-init synthesis (reference convtasnet.py:286-299), float32."""
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
        wav0 = self._initial_wave(inv_amp, theta)             # (B, L)

        w = self.encoder(wav0[..., None])                      # (B, T', N)
        e = self.bottleneck(self.enc_norm(w))                  # (B, T', Bc)
        skip_sum = torch.zeros_like(e)
        for blk in self.blocks:
            e, skip = blk(e)
            if self.skip_con:
                skip_sum = skip_sum + skip
        feat = skip_sum if self.skip_con else e
        d = w * self.mask_conv(feat)                           # mask applied raw
        return self.decoder(d)[..., 0]
