"""BSRNN band-split RNN vocoder / enhancer, in PyTorch.

Counterpart of nvse_tpu/models/bsrnn.py (reference Models/bsrnn.py and
Models/bsrnn_24k.py). The 34 bands are grouped by width into 5 groups;
each group's encoder/decoder is one batched einsum over stacked per-band
parameters, as in the JAX package. Each BSNet runs a time LSTM over the
frames (B*34 rows; a BiLSTM through ops.lstm.lstm_scan_fused, or for a
causal config a unidirectional one through ops.lstm.lstm_scan) and a band
BiLSTM over the 34 bands (B*T rows, lstm_scan_fused).

Streaming decode (stream_state / return_state / carry_idx on the
generators): the state is one (h, c) pair per BSNet, each (B, nband, C),
of the time LSTM's forward direction, carried from chunk to chunk through
ops.lstm.lstm_scan_stateful; the band BiLSTM runs within a frame and
carries nothing.

Sequence parallelism (training; BSRNNCore.seq_group, a process group of
`sp` ranks that hold the same rows; nvse_tpu/models/bsrnn.py sp_axis):
inside the trunk rank k runs the time LSTM on its slice of the 34 bands
(B x nband_k rows), an all-to-all gives it a slice of the frames with every
band for the band BiLSTM (B x T_k rows), and a second one goes back; after
the last BSNet the bands are gathered. The encoder, the decoders and the
iSTFT run on every seq rank on the whole spectrum. The collectives are
differentiable (parallel/collectives.py), so averaging every gradient over
the whole mesh gives the one-process gradient. Without a group the trunk
runs as above.

Under a bfloat16 (or float16) trunk the dtypes follow the JAX package's
promotion: the DSP front and back ends and the encoder stay float32,
LayerNorm and Linear outputs follow the params, and residual sums promote.
A float16 trunk takes the phase's atan2 in float32 (its backward underflows
float16).
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.spectral import hann_window, inverse_mel, istft_ri
from ..parallel.collectives import all_gather_dim, all_to_all_dims, local_slice
from .layers import LSTM, LayerNorm, Linear, uniform_


def band_plan(sampling_rate: int, n_fft: int) -> list[int]:
    """Band widths in FFT bins (reference bsrnn.py:98-108)."""
    reso = sampling_rate / n_fft
    widths = [int(np.floor(100 / reso))] * 10
    widths += [int(np.floor(250 / reso))] * 12
    widths += [int(np.floor(500 / reso))] * 8
    widths += [int(np.floor(1000 / reso))] * 3
    widths.append(n_fft // 2 + 1 - int(np.sum(widths)))
    return widths


def _band_groups(widths: Sequence[int]):
    """Group consecutive equal-width bands: [(width, count, bin_offset)]."""
    groups = []
    off = 0
    i = 0
    while i < len(widths):
        w = widths[i]
        j = i
        while j < len(widths) and widths[j] == w:
            j += 1
        groups.append((w, j - i, off))
        off += w * (j - i)
        i = j
    return groups


def _promoted(*ts: torch.Tensor) -> list[torch.Tensor]:
    """Cast to the common dtype, as jnp's einsum/arithmetic promote."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return [t.to(dt) for t in ts]


def _band_norm(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    x, scale, bias = _promoted((x - mu) * torch.rsqrt(var + 1e-5), scale, bias)
    return x * scale + bias


class _GroupedBandEncoder(nn.Module):
    """Per-band LayerNorm(bw) + Linear(bw->C), batched per width group.

    Input log-spectrum (B, F, T) -> features (B, nband, T, C).
    """

    def __init__(self, widths: Sequence[int], feature_dim: int, gen: torch.Generator):
        super().__init__()
        self.groups = _band_groups(widths)
        C = feature_dim
        for gi, (w, n, _off) in enumerate(self.groups):
            bound = 1.0 / math.sqrt(w)
            self.register_parameter(f"ln_scale_{gi}", nn.Parameter(torch.ones(n, 1, w)))
            self.register_parameter(f"ln_bias_{gi}", nn.Parameter(torch.zeros(n, 1, w)))
            self.register_parameter(f"w_{gi}", uniform_((n, w, C), bound, gen))
            self.register_parameter(f"b_{gi}", uniform_((n, 1, C), bound, gen))

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        B, _, T = spec.shape
        outs = []
        for gi, (w, n, off) in enumerate(self.groups):
            x = spec[:, off : off + n * w, :].reshape(B, n, w, T).transpose(2, 3)
            x = _band_norm(x, getattr(self, f"ln_scale_{gi}"), getattr(self, f"ln_bias_{gi}"))
            x, wgt, b = _promoted(x, getattr(self, f"w_{gi}"), getattr(self, f"b_{gi}"))
            outs.append(torch.einsum("bntw,nwc->bntc", x, wgt) + b)
        return torch.cat(outs, dim=1)


class _GroupedBandDecoder(nn.Module):
    """Per-band LN(C) + Linear(C->4C) + GELU + Linear(4C->out_mult*bw).

    Input (B, nband, T, C) -> list of (B, n, T, out_mult*w) per group.
    """

    def __init__(self, widths: Sequence[int], feature_dim: int, out_mult: int,
                 gen: torch.Generator):
        super().__init__()
        self.groups = _band_groups(widths)
        C = feature_dim
        for gi, (w, n, _off) in enumerate(self.groups):
            self.register_parameter(f"ln_scale_{gi}", nn.Parameter(torch.ones(n, 1, C)))
            self.register_parameter(f"ln_bias_{gi}", nn.Parameter(torch.zeros(n, 1, C)))
            b1, b2 = 1.0 / math.sqrt(C), 1.0 / math.sqrt(4 * C)
            self.register_parameter(f"w1_{gi}", uniform_((n, C, 4 * C), b1, gen))
            self.register_parameter(f"b1_{gi}", uniform_((n, 1, 4 * C), b1, gen))
            self.register_parameter(f"w2_{gi}", uniform_((n, 4 * C, out_mult * w), b2, gen))
            self.register_parameter(f"b2_{gi}", uniform_((n, 1, out_mult * w), b2, gen))

    def forward(self, feats: torch.Tensor) -> list[torch.Tensor]:
        outs = []
        band0 = 0
        for gi, (_w, n, _off) in enumerate(self.groups):
            x = feats[:, band0 : band0 + n]
            band0 += n
            x = _band_norm(x, getattr(self, f"ln_scale_{gi}"), getattr(self, f"ln_bias_{gi}"))
            x, w1, b1 = _promoted(x, getattr(self, f"w1_{gi}"), getattr(self, f"b1_{gi}"))
            x = F.gelu(torch.einsum("bntc,nch->bnth", x, w1) + b1)   # exact (erf) GELU
            x, w2, b2 = _promoted(x, getattr(self, f"w2_{gi}"), getattr(self, f"b2_{gi}"))
            outs.append(torch.einsum("bnth,nhk->bntk", x, w2) + b2)
        return outs


class ResRNN(nn.Module):
    """LayerNorm + (bi)LSTM + projection with residual (bsrnn.py:7-41)."""

    def __init__(self, input_size: int, hidden_size: int, causal: bool, gen: torch.Generator):
        super().__init__()
        self.norm = LayerNorm(input_size)
        self.lstm = LSTM(input_size, hidden_size, bidirectional=not causal, gen=gen)
        self.proj = Linear(hidden_size * (1 if causal else 2), input_size, gen)

    def forward(self, x: torch.Tensor, state=None, return_state: bool = False,
                carry_idx: int | None = None):
        # x: (B, G, S, C); the LSTM runs over S for every (B, G). Streaming:
        # state is the forward-direction (h, c), each (B, G, H)
        B, G, S, C = x.shape
        y = self.norm(x).reshape(B * G, S, C)
        streaming = state is not None or return_state
        if streaming:
            st = None if state is None else tuple(s.reshape(B * G, -1) for s in state)
            y, new_st = self.lstm(y, initial_state=st, return_state=True, carry_idx=carry_idx)
            new_state = tuple(s.reshape(B, G, -1) for s in new_st)
        else:
            y = self.lstm(y)
        out = x + self.proj(y).reshape(B, G, S, C)
        return (out, new_state) if streaming else out


class BSNet(nn.Module):
    """Dual-path block: time LSTM then band BiLSTM (bsrnn.py:44-77)."""

    def __init__(self, feature_dim: int, causal: bool, gen: torch.Generator):
        super().__init__()
        self.time_rnn = ResRNN(feature_dim, feature_dim, causal, gen)
        self.band_rnn = ResRNN(feature_dim, feature_dim, False, gen)
        self.out_norm = LayerNorm(feature_dim)

    def forward(self, x: torch.Tensor, state=None, return_state: bool = False,
                carry_idx: int | None = None, seq_group=None, full: tuple = ()):
        # x: (B, nband, T, C); streaming state belongs to the time RNN only.
        # With seq_group, x and the output are this rank's slice of the bands
        # (B, nband_k, T, C) of a (nband, T) = `full` spectrum
        if seq_group is not None:
            nband, T = full
            x = all_to_all_dims(self.time_rnn(x), 2, 1, nband, seq_group)   # (B, nband, T_k, C)
            x = self.out_norm(self.band_rnn(x.transpose(1, 2)).transpose(1, 2))
            return all_to_all_dims(x, 1, 2, T, seq_group)
        streaming = state is not None or return_state
        if streaming:
            x, new_state = self.time_rnn(x, state=state, return_state=True, carry_idx=carry_idx)
        else:
            x = self.time_rnn(x)
        x = self.band_rnn(x.transpose(1, 2)).transpose(1, 2)   # over bands per frame
        out = self.out_norm(x)
        return (out, new_state) if streaming else out


class BSRNNCore(nn.Module):
    """Shared band-split trunk: log-spectrum (B, F, T) ->
    (logamp, pha, rea, imag, wav), reference bsrnn.py:143-217.

    Streaming (stream_state / return_state): stream_state is a tuple of
    num_repeat time-LSTM states, each a ((B, nband, C), (B, nband, C))
    pair; carry_idx is the chunk length in frames after which the next
    chunk's state is taken (lookahead frames beyond it refine this
    window's output and do not enter the carry). Returns
    (outputs, new_states)."""

    def __init__(self, sampling_rate: int, n_fft: int, hop_size: int, win_size: int,
                 feature_dim: int, num_repeat: int, causal: bool, gen: torch.Generator):
        super().__init__()
        self.n_fft, self.hop_size, self.win_size = n_fft, hop_size, win_size
        self.widths = band_plan(sampling_rate, n_fft)
        self.encoder = _GroupedBandEncoder(self.widths, feature_dim, gen)
        self.blocks = nn.ModuleList(BSNet(feature_dim, causal, gen) for _ in range(num_repeat))
        self.dec_mag = _GroupedBandDecoder(self.widths, feature_dim, 1, gen)
        self.dec_pha = _GroupedBandDecoder(self.widths, feature_dim, 2, gen)
        self.seq_group = None       # a "seq" process group: sequence parallelism in the trunk

    def _trunk_seq_parallel(self, feats: torch.Tensor) -> torch.Tensor:
        """The BSNets over the seq group: this rank's bands in, every band out."""
        full = tuple(feats.shape[1:3])                          # (nband, T)
        x = local_slice(feats, 1, self.seq_group)
        for blk in self.blocks:
            x = blk(x, seq_group=self.seq_group, full=full)
        return all_gather_dim(x, 1, full[0], self.seq_group)

    def forward(self, log_spec: torch.Tensor, stream_state=None, return_state: bool = False,
                carry_idx: int | None = None):
        feats = self.encoder(log_spec)
        streaming = stream_state is not None or return_state
        new_states = []
        if self.seq_group is not None:
            if streaming:
                raise ValueError("sequence parallelism is for training; a streaming decode "
                                 "runs on one device")
            feats = self._trunk_seq_parallel(feats)
        else:
            for r, blk in enumerate(self.blocks):
                if streaming:
                    st = None if stream_state is None else stream_state[r]
                    feats, ns = blk(feats, state=st, return_state=True, carry_idx=carry_idx)
                    new_states.append(ns)
                else:
                    feats = blk(feats)
        B, _, T, _ = feats.shape
        resi = torch.cat([g.transpose(1, 2).reshape(B, T, -1) for g in self.dec_mag(feats)],
                         dim=-1)                                # (B, T, F)
        pha_parts = []
        for g, (w, _n, _o) in zip(self.dec_pha(feats), _band_groups(self.widths)):
            if g.dtype == torch.float16:
                # atan2's backward divides by re^2 + im^2, which float16 flushes to 0
                # where |re|, |im| < 2^-12 (0 / 0): the phase is taken in float32
                g = g.float()
            pha = torch.atan2(g[..., w:], g[..., :w])           # (B, n, T, w)
            pha_parts.append(pha.transpose(1, 2).reshape(B, T, -1))
        phase = torch.cat(pha_parts, dim=-1).transpose(-1, -2)

        mag = torch.exp(resi.transpose(-1, -2) + log_spec)      # (B, F, T)
        # the reference's clamp_min_ is in place (bsrnn.py:204): the clamped
        # magnitude also feeds rea/imag and the iSTFT
        mag = torch.clamp(mag, min=1e-5)
        logamp = torch.log(mag)
        rea = mag * torch.cos(phase)
        imag = mag * torch.sin(phase)
        wav = istft_ri(rea, imag, self.n_fft, self.hop_size, self.win_size,
                       window=hann_window(self.win_size))
        outs = (logamp, phase, rea, imag, wav)
        return (outs, tuple(new_states)) if streaming else outs


class BSRNN(nn.Module):
    """mel (B, M, T) -> (logamp, pha, rea, imag, wav). Reference bsrnn.py:80-217."""

    # the engine's state-carrying chunked decoder looks for this flag
    supports_stream_state = True

    def __init__(self, h, gen: torch.Generator):
        super().__init__()
        self.mel_args = (h.n_fft, h.num_mels, h.sampling_rate, h.hop_size,
                         h.win_size, h.fmin, h.fmax)
        self.core = BSRNNCore(h.sampling_rate, h.n_fft, h.hop_size, h.win_size,
                              h.feature_dim, h.num_repeat, bool(h.causal), gen)

    def forward(self, mel: torch.Tensor, stream_state=None, return_state: bool = False,
                carry_idx: int | None = None):
        inv_amp = torch.clamp(torch.abs(inverse_mel(mel, *self.mel_args)), min=1e-5)
        return self.core(torch.log(inv_amp), stream_state=stream_state,
                         return_state=return_state, carry_idx=carry_idx)


class BSRNN_24k(nn.Module):
    """log-spectrum (B, F, T) -> TF outputs. Reference bsrnn_24k.py:79-194."""

    supports_stream_state = True

    def __init__(self, h, gen: torch.Generator):
        super().__init__()
        self.core = BSRNNCore(h.sampling_rate, h.n_fft, h.hop_size, h.win_size,
                              h.feature_dim, h.num_repeat, bool(h.causal), gen)

    def forward(self, log_spec: torch.Tensor, stream_state=None, return_state: bool = False,
                carry_idx: int | None = None):
        return self.core(log_spec, stream_state=stream_state, return_state=return_state,
                         carry_idx=carry_idx)
