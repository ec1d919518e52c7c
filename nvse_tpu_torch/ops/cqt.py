"""Constant-Q transform by direct log-spaced complex convolution, in PyTorch.

Counterpart of nvse_tpu/ops/cqt.py (the CQT discriminator's front end; the
reference wraps nnAudio's CQT2010v2, Models/models.py:404-413): one
windowed complex sinusoid a bin at log-spaced centre frequencies, kernel
lengths capped at 16384 samples, the bank a host numpy constant
(max_len, 2 * n_bins) = [cos | -sin], cached read-only. The transform is a
VALID strided convolution of the constant-padded wave over the bank, as
the JAX package computes it in XLA. Here it is one GEMM of the framed wave
(x.unfold: a view, frames of kernel_len at the hop) and the bank, cuBLAS on
the card, in the input's dtype: at the CQT discriminator's step shapes on an
H100 it took 2.3x less time than F.conv1d over the bank in float32 and 23x
less in bfloat16 (chip_smoke.py cqtd_train times both; PERF.md).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .spectral import _on_device, _read_only

__all__ = ["cqt", "cqt_bank"]

CQT_FMIN = 32.70319566257483


@functools.lru_cache(maxsize=None)
def _cqt_kernels_np(sr: int, n_bins: int, bins_per_octave: int, fmin: float,
                    max_kernel_len: int = 16384):
    """-> ((kernel_len, 2 * n_bins) float32 bank [cos | -sin], read-only,
    kernel_len): nvse_tpu/ops/cqt.py:_cqt_kernels_np. Each bin's Hann-windowed
    sinusoid of length ceil(Q sr / f), capped at max_kernel_len, centred in
    the next power of two, scaled by 1 / length."""
    Q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    lengths = np.minimum(np.ceil(Q * sr / freqs).astype(int), max_kernel_len)
    max_len = int(2 ** np.ceil(np.log2(lengths.max())))
    bank = np.zeros((max_len, 2 * n_bins), dtype=np.float64)
    for k, (f, L) in enumerate(zip(freqs, lengths)):
        L = min(L, max_len)
        start = (max_len - L) // 2
        n = np.arange(L)
        win = 0.5 - 0.5 * np.cos(2 * np.pi * (n + 0.5) / L)
        phase = 2.0 * np.pi * f / sr * (n - L / 2.0)
        norm = 1.0 / L
        bank[start : start + L, k] = win * np.cos(phase) * norm
        bank[start : start + L, n_bins + k] = -win * np.sin(phase) * norm
    return _read_only(bank.astype(np.float32)), max_len


def cqt_bank(sr: int, n_bins: int, bins_per_octave: int, fmin: float = CQT_FMIN) -> np.ndarray:
    """The host bank (kernel_len, 2 * n_bins), read-only."""
    return _cqt_kernels_np(sr, n_bins, bins_per_octave, fmin)[0]


@functools.lru_cache(maxsize=None)
def _device_bank(sr: int, n_bins: int, bins_per_octave: int, fmin: float, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """The bank (kernel_len, 2 * n_bins) on device in dtype, made once (outside
    inference mode, as ops/spectral.py's constants): a copy from the host inside
    a step would wait for the stream to drain."""
    bank, _ = _cqt_kernels_np(sr, n_bins, bins_per_octave, fmin)
    with torch.inference_mode(False):
        return _on_device(bank, device).to(dtype)


def cqt(x: torch.Tensor, sr: int, hop_length: int, n_bins: int, bins_per_octave: int,
        fmin: float = CQT_FMIN):
    """x (B, L) -> (real, imag), each (B, n_bins, T): the wave zero-padded by
    kernel_len // 2 on each side, correlated with the bank at stride hop_length
    (VALID), T = (L + 2 (kernel_len // 2) - kernel_len) // hop_length + 1. The
    bank takes the input's dtype (bfloat16 trunks)."""
    bank = _device_bank(sr, n_bins, bins_per_octave, fmin, x.device, x.dtype)
    pad = bank.shape[0] // 2
    frames = F.pad(x, (pad, pad)).unfold(-1, bank.shape[0], hop_length)   # (B, T, kernel_len)
    out = (frames @ bank).transpose(1, 2)
    return out[:, :n_bins], out[:, n_bins:]
