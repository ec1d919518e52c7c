"""ITU-R BS.1770-4 integrated loudness (mono), replacing pyloudnorm.

The port's own copy of nvse_tpu/data/loudness.py (numpy and scipy only).

The reference mixes noise at LUFS-matched SNRs with
pyloudnorm.Meter.integrated_loudness
(dataset_joint_denoise_vocoder.py:291-301); this is the same algorithm
re-derived from the spec: K-weighting (stage-1 high shelf + stage-2
high-pass biquads), 400 ms gating blocks with 75% overlap, -70 LUFS
absolute gate, -10 LU relative gate.
"""
from __future__ import annotations

import functools
import math

import numpy as np
from scipy.signal import lfilter


@functools.lru_cache(maxsize=None)
def _k_weighting_coeffs(fs: int):
    # stage 1: spherical-head high shelf (BS.1770-4 pre-filter)
    f0, G, Q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    K = math.tan(math.pi * f0 / fs)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh ** 0.499666774155
    a0_ = 1.0 + K / Q + K * K
    shelf_b = np.array([
        (Vh + Vb * K / Q + K * K) / a0_,
        2.0 * (K * K - Vh) / a0_,
        (Vh - Vb * K / Q + K * K) / a0_,
    ])
    shelf_a = np.array([1.0, 2.0 * (K * K - 1.0) / a0_, (1.0 - K / Q + K * K) / a0_])

    # stage 2: RLB high pass
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = math.tan(math.pi * f0 / fs)
    hp_b = np.array([1.0, -2.0, 1.0])
    hp_a = np.array([
        1.0,
        2.0 * (K * K - 1.0) / (1.0 + K / Q + K * K),
        (1.0 - K / Q + K * K) / (1.0 + K / Q + K * K),
    ])
    return (shelf_b, shelf_a, hp_b, hp_a)


def k_weight(x: np.ndarray, fs: int) -> np.ndarray:
    shelf_b, shelf_a, hp_b, hp_a = _k_weighting_coeffs(fs)
    y = lfilter(shelf_b, shelf_a, x)
    return lfilter(hp_b, hp_a, y)


def integrated_loudness(x: np.ndarray, fs: int) -> float:
    """Gated integrated loudness in LUFS (mono input).

    Returns -inf for silence, like pyloudnorm.
    """
    x = np.asarray(x, dtype=np.float64)
    y = k_weight(x, fs)

    block = int(0.4 * fs)
    step = int(0.1 * fs)
    if len(y) < block:
        ms = np.mean(y * y)
        return -0.691 + 10.0 * np.log10(ms) if ms > 0 else -np.inf

    n_blocks = 1 + (len(y) - block) // step
    idx = np.arange(n_blocks)[:, None] * step + np.arange(block)[None, :]
    ms = np.mean(y[idx] ** 2, axis=1)
    with np.errstate(divide="ignore"):
        lk = -0.691 + 10.0 * np.log10(ms)

    above_abs = lk > -70.0
    if not above_abs.any():
        return -np.inf
    rel_threshold = -0.691 + 10.0 * np.log10(np.mean(ms[above_abs])) - 10.0
    gated = above_abs & (lk > rel_threshold)
    if not gated.any():
        return -np.inf
    return float(-0.691 + 10.0 * np.log10(np.mean(ms[gated])))
