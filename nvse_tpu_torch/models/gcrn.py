"""GCRN: GLU-conv UNet with a grouped LSTM bottleneck, in PyTorch.

Counterpart of nvse_tpu/models/gcrn.py (reference Models/gcrn.py): 6 GLU
Conv2d encoder stages over the frequency axis (valid padding, stride 2 in
frequency), a 2-group LSTM bottleneck, two GLU ConvTranspose2d decoders
with channel-concat skips (a residual-mask magnitude branch and a
real/imaginary phase branch), per-frequency LayerNorms, ELU, and two
513 -> 513 Linear heads. The model has no width knobs.

Layout: (B, C, T, F), torch's NCHW and the reference's; the JAX package is
channels-last (B, T, F, C), so its trailing-axis concats are dim 1 here.
The grouped LSTM's pairs of independent scans run through
ops.lstm.lstm_scan_bidir2 (on the card: one launch of the kernel of
csrc/lstm_bidir2.cu per pair), an odd last group through ops.lstm.lstm_scan.

Under a bfloat16 trunk the dtypes follow the JAX package's promotion: the
DSP ends stay float32, conv / Linear / LayerNorm outputs follow the
params, the per-frequency LayerNorm computes in its input's dtype, and
sums with the float32 log-spectrum promote.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.lstm import lstm_scan, lstm_scan_bidir2
from ..ops.spectral import hann_window, inverse_mel, istft_ri
from .layers import (LSTM, ConvTranspose2d, LayerNorm, Linear, PlainConv2d, conv2d,
                     conv_transpose2d)


class _Glu(nn.Module):
    """conv * sigmoid(conv) over a pair of same-shaped convs.

    The two child convs keep their own parameters (the checkpoint layout).
    fused=True (default) runs them as one conv of 2 * cout channels, the
    kernels concatenated at apply time, and splits: the same floats in
    half the conv calls."""

    conv_cls = None       # the child conv class
    conv_fn = None        # its functional form
    out_axis = 0          # the kernel's out-channel axis

    def __init__(self, cin: int, cout: int, kernel, stride, fused: bool = True,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.cout, self.fused = cout, fused
        self.conv_a = self.conv_cls(cin, cout, kernel, stride=stride, gen=gen)
        self.conv_b = self.conv_cls(cin, cout, kernel, stride=stride, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fused:
            return self.conv_a(x) * torch.sigmoid(self.conv_b(x))
        kernel = torch.cat([self.conv_a.kernel, self.conv_b.kernel], dim=self.out_axis)
        bias = torch.cat([self.conv_a.bias, self.conv_b.bias])
        y = self.conv_fn(x, kernel, bias, self.conv_a.stride)
        return y[:, : self.cout] * torch.sigmoid(y[:, self.cout :])


class GluConv2d(_Glu):
    """GLU-gated Conv2d (reference gcrn.py:42-60)."""

    conv_cls, conv_fn, out_axis = PlainConv2d, staticmethod(conv2d), 0


class GluConvTranspose2d(_Glu):
    """GLU-gated ConvTranspose2d (reference gcrn.py:63-83)."""

    conv_cls, conv_fn, out_axis = ConvTranspose2d, staticmethod(conv_transpose2d), 1


class FreqLayerNorm(nn.Module):
    """torch LayerNorm over the trailing frequency axis of (B, C, T, F),
    with per-frequency `scale` / `bias` of shape (F, 1) as the JAX
    package's `_ln_freq` keeps them; biased variance, eps 1e-5, computed
    in the input's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, 1))
        self.bias = nn.Parameter(torch.zeros(features, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        y = (x - mu) * torch.rsqrt(var + 1e-5)
        return y * self.scale[:, 0] + self.bias[:, 0]


class GLSTM(nn.Module):
    """Grouped LSTM bottleneck (reference gcrn.py:7-39).

    Input (B, C, T, F); the features are flattened C-major to
    (B, T, C * F = hidden_size), split into `groups` chunks, one
    unidirectional LSTM per chunk, interleave-stacked + LayerNorm, split
    again, one LSTM per chunk, concatenated + LayerNorm, reshaped back.
    `lstms` holds the 2 * groups layers in the JAX package's order (the
    first round's, then the second's); they are used as parameter holders
    (summed bias `b_fwd`), the scans run pairwise in `_group_scans`."""

    def __init__(self, hidden_size: int = 896, groups: int = 2,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.hidden_size, self.groups = hidden_size, groups
        hs = hidden_size // groups
        self.lstms = nn.ModuleList(LSTM(hs, hs, bidirectional=False, gen=gen)
                                   for _ in range(2 * groups))
        self.norm1 = LayerNorm(hidden_size)
        self.norm2 = LayerNorm(hidden_size)

    @staticmethod
    def _group_scans(chunks, mods):
        """The per-group unidirectional LSTMs over chunks of (B, T, hs):
        adjacent pairs share one lstm_scan_bidir2 call, an odd last group
        scans alone."""
        def project(chunk, m):           # time-major x_proj (T, B, 4 * hs)
            x = chunk.to(m.w_ih_fwd.dtype).transpose(0, 1)
            return (x @ m.w_ih_fwd + m.b_fwd).contiguous()

        outs = [None] * len(chunks)
        for i in range(0, len(chunks) - 1, 2):
            h0, h1 = lstm_scan_bidir2(project(chunks[i], mods[i]),
                                      project(chunks[i + 1], mods[i + 1]),
                                      mods[i].w_hh_fwd, mods[i + 1].w_hh_fwd)
            outs[i], outs[i + 1] = h0.transpose(0, 1), h1.transpose(0, 1)
        if len(chunks) % 2:
            outs[-1] = lstm_scan(project(chunks[-1], mods[-1]), mods[-1].w_hh_fwd).transpose(0, 1)
        return outs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T, Fq = x.shape
        g = self.groups
        out = x.permute(0, 2, 1, 3).reshape(B, T, C * Fq)          # C-major flatten
        outs = self._group_scans(out.chunk(g, dim=-1), self.lstms[:g])
        out = self.norm1(torch.stack(outs, dim=-1).reshape(B, T, -1))   # interleaved
        outs = self._group_scans(out.chunk(g, dim=-1), self.lstms[g:])
        out = self.norm2(torch.cat(outs, dim=-1))
        return out.reshape(B, T, C, Fq).permute(0, 2, 1, 3)


# (cin, cout, kernel, frequency bins out) of the encoder and decoder stages
_ENC_SPEC = ((1, 16, (1, 5), 255), (16, 32, (1, 3), 127), (32, 64, (1, 3), 63),
             (64, 128, (1, 3), 31), (128, 128, (1, 3), 15), (128, 128, (1, 3), 7))
_DEC_SPEC = ((256, 128, (1, 3), 15), (256, 128, (1, 3), 31), (256, 64, (1, 3), 63),
             (128, 32, (1, 3), 127), (64, 16, (1, 3), 255), (32, None, (1, 5), 513))


class _Decoder(nn.Module):
    def __init__(self, out_ch_last: int, fused: bool, gen: torch.Generator):
        super().__init__()
        self.convs = nn.ModuleList(
            GluConvTranspose2d(ci, out_ch_last if co is None else co, k, (1, 2), fused, gen)
            for ci, co, k, _f in _DEC_SPEC)
        self.norms = nn.ModuleList(FreqLayerNorm(f) for *_, f in _DEC_SPEC)

    def forward(self, x: torch.Tensor, skips) -> torch.Tensor:
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            y = norm(conv(x))
            x = F.elu(torch.cat([y, skips[4 - i]], dim=1) if i < 5 else y)
        return x


class GCRN(nn.Module):
    """mel (B, M, T) -> (logamp, pha, rea, imag, wav). Reference
    gcrn.py:86-220. `inv_mel_amp` (B, F, T), when given, replaces the
    pseudo-inverse-mel amplitude."""

    def __init__(self, h, gen: torch.Generator):
        super().__init__()
        self.mel_args = (h.n_fft, h.num_mels, h.sampling_rate, h.hop_size,
                         h.win_size, h.fmin, h.fmax)
        self.n_fft, self.hop_size, self.win_size = h.n_fft, h.hop_size, h.win_size
        fused = bool(h.get("fused_glu", True))     # false: the pairs of convs, for A/B
        self.enc_convs = nn.ModuleList(GluConv2d(ci, co, k, (1, 2), fused, gen)
                                       for ci, co, k, _f in _ENC_SPEC)
        self.enc_norms = nn.ModuleList(FreqLayerNorm(f) for *_, f in _ENC_SPEC)
        self.glstm = GLSTM(gen=gen)
        # the JAX package creates both decoders' convs before the two heads
        self.dec1 = _Decoder(1, fused, gen)
        self.dec2 = _Decoder(2, fused, gen)
        self.fc1 = Linear(513, 513, gen)
        self.fc2 = Linear(513, 513, gen)

    def forward(self, mel: torch.Tensor, inv_mel_amp: torch.Tensor | None = None):
        if inv_mel_amp is None:
            inv_amp = torch.clamp(torch.abs(inverse_mel(mel, *self.mel_args)), min=1e-5)
        else:
            inv_amp = inv_mel_amp
        log_spec = torch.log(inv_amp)                           # (B, F, T)

        x = log_spec.transpose(-1, -2).unsqueeze(1)             # (B, 1, T, F)
        skips = []
        for conv, norm in zip(self.enc_convs, self.enc_norms):
            x = F.elu(norm(conv(x)))
            skips.append(x)

        out = torch.cat([self.glstm(x), skips[-1]], dim=1)      # (B, 256, T, 7)
        d1 = self.dec1(out, skips)                              # (B, 1, T, 513)
        d2 = self.dec2(out, skips)                              # (B, 2, T, 513)
        B, _, T, Fq = d2.shape

        resi_mask = self.fc1(d1[:, 0])                          # (B, T, F)
        mag = torch.exp(resi_mask.transpose(-1, -2) + log_spec)  # (B, F, T)
        # fc2 per (b, t, channel) row over frequency
        ri = self.fc2(d2.permute(0, 2, 1, 3).reshape(B, T * 2, Fq)).reshape(B, T, 2, Fq)
        phase = torch.atan2(ri[:, :, 1].transpose(-1, -2), ri[:, :, 0].transpose(-1, -2))

        rea = mag * torch.cos(phase)
        imag = mag * torch.sin(phase)
        logamp = torch.log(mag + 1e-5)
        wav = istft_ri(rea, imag, self.n_fft, self.hop_size, self.win_size,
                       window=hann_window(self.win_size))
        return logamp, phase, rea, imag, wav
