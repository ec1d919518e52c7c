"""Windowed-sinc 2x resampling (polyphase), as HD-Demucs uses it, in PyTorch.

Counterpart of nvse_tpu/ops/resample.py (reference Models/hddemucas.py:22-82:
Smith & Gossett sinc interpolation, zeros = 56, odd-sample Hann window):
upsample2 interleaves the input with a sinc-interpolated mid-point signal;
downsample2 averages the even samples with the sinc-filtered odd ones. The
filter is a host numpy constant; each conv is one F.conv1d (cuDNN on the
card) in the input's dtype.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["downsample2", "upsample2"]


@functools.lru_cache(maxsize=None)
def _sinc_kernel_np(zeros: int = 56) -> np.ndarray:
    n = 4 * zeros + 1
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))  # symmetric hann
    winodd = win[1::2]
    t = np.linspace(-zeros + 0.5, zeros - 0.5, 2 * zeros) * math.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / t) * winodd
    return kernel.astype(np.float32)


def _conv1d_single(x: torch.Tensor, kernel: np.ndarray, padding: int) -> torch.Tensor:
    """x (..., L) correlated with kernel (K,), zero padding p on each side ->
    (..., L + 2p - K + 1), in x's dtype."""
    lead = x.shape[:-1]
    k = torch.from_numpy(kernel).to(x.device, x.dtype).reshape(1, 1, -1)
    y = F.conv1d(x.reshape(-1, 1, x.shape[-1]), k, padding=padding)
    return y.reshape(*lead, -1)


def upsample2(x: torch.Tensor, zeros: int = 56) -> torch.Tensor:
    """(..., L) -> (..., 2L) sinc upsampling (hddemucas.py:40-52)."""
    out = _conv1d_single(x, _sinc_kernel_np(zeros), padding=zeros)[..., 1:]
    return torch.stack([x, out], dim=-1).reshape(*x.shape[:-1], -1)


def downsample2(x: torch.Tensor, zeros: int = 56) -> torch.Tensor:
    """(..., L) -> (..., ceil(L / 2)) sinc downsampling (hddemucas.py:66-82);
    an odd length is zero-padded by one sample first."""
    if x.shape[-1] % 2:
        x = F.pad(x, (0, 1))
    xeven, xodd = x[..., ::2], x[..., 1::2]
    out = xeven + _conv1d_single(xodd, _sinc_kernel_np(zeros), padding=zeros)[..., :-1]
    return out * 0.5
