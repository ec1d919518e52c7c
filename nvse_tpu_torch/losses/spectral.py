"""Spectral losses: amplitude, anti-wrapped phase, STFT consistency.

Counterpart of nvse_tpu/losses/spectral.py (reference Models/models.py:
116-141, :595-669). The group-delay and time-difference matrices of the
reference are shifted subtractions here, with the boundary column the
matrices produce.
"""
from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def anti_wrapping_function(x: torch.Tensor) -> torch.Tensor:
    """|x - round(x / 2pi) * 2pi|; torch.round rounds half to even, as jnp.round."""
    return torch.abs(x - torch.round(x / TWO_PI) * TWO_PI)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Mean of x (..., T); with a (T,) 0/1 frame mask only the masked time
    columns count (full-utterance validation on padded buckets)."""
    if mask is None:
        return torch.mean(x)
    m = mask.reshape((1,) * (x.ndim - 1) + (-1,))
    denom = (x.numel() // x.shape[-1]) * torch.clamp(mask.sum(), min=1.0)
    return torch.sum(x * m) / denom


def amplitude_loss(log_amplitude_r, log_amplitude_g, mask=None) -> torch.Tensor:
    """MSE of log-amplitude spectra."""
    return _masked_mean((log_amplitude_r - log_amplitude_g) ** 2, mask)


def _gd(phase: torch.Tensor) -> torch.Tensor:
    """Difference along frequency of (B, F, T): out[f] = phase[f-1] - phase[f],
    out[0] = -phase[0] (the reference's GD matrix)."""
    return torch.cat([-phase[:, :1, :], phase[:, :-1, :] - phase[:, 1:, :]], dim=1)


def _ptd(phase: torch.Tensor) -> torch.Tensor:
    """Difference along time (the reference's PTD matrix)."""
    return torch.cat([-phase[:, :, :1], phase[:, :, :-1] - phase[:, :, 1:]], dim=2)


def phase_loss(phase_r, phase_g, mask=None):
    """(IP, GD, PTD) anti-wrapped phase losses."""
    ip = _masked_mean(anti_wrapping_function(phase_r - phase_g), mask)
    gd = _masked_mean(anti_wrapping_function(_gd(phase_r) - _gd(phase_g)), mask)
    ptd = _masked_mean(anti_wrapping_function(_ptd(phase_r) - _ptd(phase_g)), mask)
    return ip, gd, ptd


def stft_consistency_loss(rea_r, rea_g, imag_r, imag_g, mask=None) -> torch.Tensor:
    """Mean squared complex-STFT distance."""
    return _masked_mean((rea_r - rea_g) ** 2 + (imag_r - imag_g) ** 2, mask)
