"""PESQ (ITU-T P.862) with the P.862.2 wideband MOS-LQO mapping — numpy.

The paper's headline quality column is WB-PESQ (reference
Metrics/pesq_.py:13-36 scores with the `pesq` C extension at 16 kHz).
That extension is absent in this environment, so the north-star metric
("matched PESQ at >=10x RTF", BASELINE.md) would be unmeasurable; this
module re-implements the P.862 perceptual model in numpy and is used by
Metrics/pesq_.py as the fallback scorer.

Faithful-structure pipeline (P.862 §10, reference C implementation):
  1. level alignment of both signals to a fixed active-speech power in
     the 300-3500 Hz band,
  2. wideband input filter (P.862.2 replaces the IRS receive filter
     with a flat >=100 Hz response — here a 2nd-order 100 Hz high-pass),
  3. global time alignment (frame-energy envelope correlation, refined
     by waveform cross-correlation),
  4. perceptual model: 32 ms Hann frames / 50% overlap, 49-band Bark
     warping, partial frequency-response compensation, short-term gain
     compensation, Zwicker intensity->loudness with the low-band
     modified exponent,
  5. masked disturbance (0.25*min deadzone) and asymmetric disturbance
     ((P_deg+50)/(P_ref+50))^1.2 in [3..12], band-aggregated by
     bark-width-weighted L2 / L1 pseudo-norms, frame-weighted by
     reference power^0.04,
  6. two-stage time aggregation (L6 over 320 ms split-second intervals,
     L2 over intervals),
  7. raw = 4.5 - 0.1*D - 0.0309*DA, then the P.862.2 logistic mapping
     MOS-LQO = 0.999 + 4.0 / (1 + exp(-1.3669*raw + 3.8224)).

Documented deviations from the ITU reference (its band/threshold tables
are not redistributable and not reconstructible in this offline env):
  * Bark bands are computed from z(f) = 7*asinh(f/650) divided
    uniformly into 49 bands over 0..8 kHz instead of the tabulated
    centre/width values;
  * the absolute hearing threshold uses Terhardt's analytic threshold
    curve instead of the tabulated per-band powers;
  * no per-utterance delay splitting or bad-interval realignment (this
    framework's degradations are time-invariant; the global aligner
    covers constant offsets).
Calibration: the internal scale constants below were fitted on MNRU
(modulated-noise) sweeps of the bundled synthetic corpus so the raw
score is ~linear in Q over 10..45 dB with identity -> 4.5, matching the
published P.862 MNRU behaviour (tests/test_pesq.py).
"""
from __future__ import annotations

import numpy as np

FS = 16000
NF = 512            # 32 ms frames
HOP = 256           # 50% overlap
NB = 49             # Bark bands (wideband mode)

# -- calibration constants (fitted; see module docstring) --------------
POWER_TARGET = 1e7      # active band power after level alignment
ABS_THRESH_SCALE = 1e-4  # Terhardt dB -> internal power units
SL = 1.866055e-1        # loudness scale (P.862 Sl)
D_WEIGHT = 0.1
DA_WEIGHT = 0.0309


def _bark(f):
    return 7.0 * np.arcsinh(np.asarray(f, np.float64) / 650.0)


def _inv_bark(z):
    return 650.0 * np.sinh(np.asarray(z, np.float64) / 7.0)


def _terhardt_db(f):
    """Absolute hearing threshold (dB SPL), Terhardt 1979."""
    f = np.maximum(np.asarray(f, np.float64), 20.0) / 1000.0
    return (3.64 * f ** -0.8
            - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
            + 1e-3 * f ** 4)


class _BandPlan:
    """49 Bark bands over 0..8 kHz: FFT-bin membership, centre
    frequencies, bark widths, absolute thresholds."""

    def __init__(self):
        edges_bark = np.linspace(_bark(0.0), _bark(FS / 2), NB + 1)
        edges_hz = _inv_bark(edges_bark)
        freqs = np.fft.rfftfreq(NF, 1.0 / FS)
        # map every rfft bin (excluding DC) to its band
        self.bin_band = np.clip(
            np.searchsorted(edges_hz, freqs, side="right") - 1, 0, NB - 1)
        self.centre_hz = 0.5 * (edges_hz[:-1] + edges_hz[1:])
        self.width_bark = np.diff(edges_bark)          # uniform by design
        self.width_hz = np.diff(edges_hz)
        counts = np.bincount(self.bin_band[1:], minlength=NB)
        self.bins_per_band = np.maximum(counts, 1)
        self.abs_thresh = (10.0 ** (_terhardt_db(self.centre_hz) / 10.0)
                           * ABS_THRESH_SCALE * POWER_TARGET / 1e7)
        # modified Zwicker exponent: steeper below 4 bark (P.862 §10.2.3)
        zc = _bark(self.centre_hz)
        h = np.where(zc < 4.0, np.minimum(6.0 / (zc + 2.0), 2.0), 1.0)
        self.zwicker_exp = 0.23 * np.maximum(h, 1.0) ** 0.15


_PLAN = _BandPlan()


# ----------------------------------------------------------------------
# stage 1-3: level alignment, input filter, time alignment
# ----------------------------------------------------------------------

def _resample(x: np.ndarray, sr: int) -> np.ndarray:
    if sr == FS:
        return x.astype(np.float64)
    from scipy.signal import resample_poly
    from math import gcd
    g = gcd(sr, FS)
    return resample_poly(x.astype(np.float64), FS // g, sr // g)


def _highpass_100(x: np.ndarray) -> np.ndarray:
    from scipy.signal import butter, lfilter
    b, a = butter(2, 100.0 / (FS / 2), "highpass")
    return lfilter(b, a, x)


def _band_power_frames(x: np.ndarray) -> np.ndarray:
    """(frames, NB) band power densities of 32 ms Hann frames."""
    n = len(x)
    n_frames = max(1, (n - NF) // HOP + 1)
    idx = np.arange(NF)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = x[idx] * np.hanning(NF)[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    spec[:, 0] = 0.0  # DC excluded
    bands = np.zeros((n_frames, NB))
    np.add.at(bands.T, _PLAN.bin_band, spec.T)
    # power density: per-band mean over member bins, normalized so a
    # full-scale frame has O(POWER_TARGET) total power
    return bands / _PLAN.bins_per_band[None, :] * (4.0 / NF)


def _fix_level(x: np.ndarray) -> np.ndarray:
    """Scale so mean active frame power in 300-3500 Hz = POWER_TARGET."""
    bands = _band_power_frames(x)
    sel = (_PLAN.centre_hz >= 300) & (_PLAN.centre_hz <= 3500)
    fp = (bands[:, sel] * _PLAN.bins_per_band[None, sel]).sum(axis=1)
    active = fp > fp.max() * 1e-3
    if not active.any():
        return x
    mean_p = fp[active].mean()
    return x * np.sqrt(POWER_TARGET / max(mean_p, 1e-12))


def _align(ref: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """Global delay estimate: envelope xcorr then +-HOP waveform refine.
    Returns deg shifted to align with ref (zero-padded)."""
    blk = 64  # 4 ms energy envelope
    n = min(len(ref), len(deg)) // blk
    if n < 8:
        return deg
    er = np.log1p((ref[: n * blk].reshape(n, blk) ** 2).sum(axis=1))
    ed = np.log1p((deg[: n * blk].reshape(n, blk) ** 2).sum(axis=1))
    er -= er.mean()
    ed -= ed.mean()
    xc = np.correlate(ed, er, "full")
    lag_blocks = int(np.argmax(xc)) - (n - 1)
    coarse = lag_blocks * blk
    # waveform refinement around the coarse estimate
    best, best_v = coarse, -np.inf
    m = min(len(ref), len(deg), FS * 4)
    r = ref[:m]
    for lag in range(coarse - blk, coarse + blk + 1):
        if lag >= 0:
            d = deg[lag : lag + m]
        else:
            d = np.concatenate([np.zeros(-lag), deg[: m + lag]])
        k = min(len(r), len(d))
        v = float(np.dot(r[:k], d[:k]))
        if v > best_v:
            best_v, best = v, lag
    if best > 0:
        return deg[best:]
    if best < 0:
        return np.concatenate([np.zeros(-best), deg])
    return deg


# ----------------------------------------------------------------------
# stage 4-6: perceptual model + disturbance aggregation
# ----------------------------------------------------------------------

def _loudness(p: np.ndarray) -> np.ndarray:
    """Zwicker intensity->loudness per (frames, NB) band powers."""
    p0 = _PLAN.abs_thresh[None, :]
    g = _PLAN.zwicker_exp[None, :]
    s = SL * (p0 / 0.5) ** g * ((0.5 + 0.5 * p / p0) ** g - 1.0)
    return np.maximum(s, 0.0)


def _weighted_norm(d: np.ndarray, p: float) -> np.ndarray:
    """Bark-width-weighted L_p over bands, per frame (pseudo_Lp)."""
    w = _PLAN.width_bark[None, :]
    return ((np.abs(d) ** p * w).sum(axis=1) / w.sum()) ** (1.0 / p) * w.sum()


def _split_second(fd: np.ndarray, p_in: float = 6.0, p_out: float = 2.0,
                  win: int = 20) -> float:
    """L6 over 320 ms intervals (50% overlap), then L2 over intervals."""
    if len(fd) == 0:
        return 0.0
    hop = max(1, win // 2)
    starts = range(0, max(1, len(fd) - win + 1), hop)
    chunks = np.array([
        (np.mean(fd[s : s + win] ** p_in)) ** (1.0 / p_in) for s in starts
    ])
    return float((np.mean(chunks ** p_out)) ** (1.0 / p_out))


def _perceptual(ref: np.ndarray, deg: np.ndarray) -> tuple[float, float]:
    """Returns (D, DA): symmetric and asymmetric disturbance."""
    pr = _band_power_frames(ref)
    pd = _band_power_frames(deg)
    n = min(len(pr), len(pd))
    pr, pd = pr[:n], pd[:n]
    tot_r = (pr * _PLAN.bins_per_band[None, :]).sum(axis=1)
    tot_d = (pd * _PLAN.bins_per_band[None, :]).sum(axis=1)
    active = tot_r > tot_r.max() * 1e-4

    # partial frequency-response compensation: equalize ref toward deg
    # with the per-band active-mean ratio, clipped to +-20 dB
    mr = pr[active].mean(axis=0) if active.any() else pr.mean(axis=0)
    md = pd[active].mean(axis=0) if active.any() else pd.mean(axis=0)
    ratio = np.clip((md + 1e3) / (mr + 1e3), 1e-2, 1e2)
    pr = pr * ratio[None, :]

    # short-term gain compensation: smoothed frame-power ratio on ref
    g = np.empty(n)
    prev = 1.0
    raw = (tot_d + 5e3) / (tot_r + 5e3)
    for t in range(n):
        prev = raw[t] if t == 0 else 0.2 * prev + 0.8 * raw[t]
        g[t] = np.clip(prev, 3e-4, 5.0)
    pr = pr * g[:, None]

    lr = _loudness(pr)
    ld = _loudness(pd)

    # masked disturbance: deadzone of 0.25*min loudness
    d = ld - lr
    m = 0.25 * np.minimum(ld, lr)
    d = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)

    # asymmetry factor
    af = ((pd + 50.0) / (pr + 50.0)) ** 1.2
    af = np.where(af < 3.0, 0.0, np.minimum(af, 12.0))

    fd = _weighted_norm(d, 2.0)
    fda = _weighted_norm(d * af, 1.0)

    # frame weighting by reference power (quiet frames count less)
    w = ((tot_r + 1e5) / 1e7) ** 0.04
    fd = np.minimum(fd / w, 45.0)
    fda = np.minimum(fda / w, 45.0)

    return _split_second(fd), _split_second(fda)


# ----------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------

def pesq_raw(ref: np.ndarray, deg: np.ndarray, sr: int) -> float:
    """Raw P.862 score in [-0.5, 4.5] (4.5 = transparent)."""
    ref = _resample(np.asarray(ref, np.float64), sr)
    deg = _resample(np.asarray(deg, np.float64), sr)
    if min(len(ref), len(deg)) < NF * 2:
        raise ValueError("signal too short for PESQ (need >= 64 ms)")
    ref = _highpass_100(_fix_level(ref))
    deg = _highpass_100(_fix_level(deg))
    deg = _align(ref, deg)
    n = min(len(ref), len(deg))
    if n < NF * 2:
        raise ValueError("signal too short for PESQ (need >= 64 ms)")
    D, DA = _perceptual(ref[:n], deg[:n])
    return float(np.clip(4.5 - D_WEIGHT * D - DA_WEIGHT * DA, -0.5, 4.5))


def pesq_wb(ref: np.ndarray, deg: np.ndarray, sr: int = FS) -> float:
    """Wideband PESQ MOS-LQO (ITU-T P.862.2 mapping), ~[1.04, 4.64]."""
    raw = pesq_raw(ref, deg, sr)
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224)))


def pesq_disturbances(ref: np.ndarray, deg: np.ndarray, sr: int
                      ) -> tuple[float, float]:
    """The two P.862 disturbance aggregates (D, DA) BEFORE the
    calibrated 4.5 − w_D·D − w_DA·DA combination — exposed so
    scripts/pesq_crosscal.py can refit (D_WEIGHT, DA_WEIGHT) against
    the ITU C extension when it is installed."""
    ref = _resample(np.asarray(ref, np.float64), sr)
    deg = _resample(np.asarray(deg, np.float64), sr)
    ref = _highpass_100(_fix_level(ref))
    deg = _highpass_100(_fix_level(deg))
    deg = _align(ref, deg)
    n = min(len(ref), len(deg))
    D, DA = _perceptual(ref[:n], deg[:n])
    return float(D), float(DA)


def mnru(x: np.ndarray, q_db: float, rng=None) -> np.ndarray:
    """Modulated Noise Reference Unit (ITU-T P.810): multiplicative
    noise at signal-to-modulated-noise ratio Q. The standard calibration
    degradation for speech-quality metrics (used by tests)."""
    rng = np.random.default_rng(0) if rng is None else rng
    return x * (1.0 + 10.0 ** (-q_db / 20.0) * rng.standard_normal(len(x)))
