"""Numpy scoring primitives for the offline metrics suite (the port's copy
of nvse_tpu/metrics/dsp.py; periodicity_metrics runs its CREPE on a device).

Each function scores (ref, deg, sr) -> float. Where the reference wraps
a C-extension library (pystoi, pysptk, pyworld — SURVEY.md §2.7), the
algorithm is re-implemented in numpy from its published description:

  * lsd          — log-spectral distance (reference Metrics/lsd.py:30-58).
  * snr          — mean-removed SNR (Metrics/snr.py:10-40).
  * stoi / estoi — Taal et al. 2010/2016 short-time objective
                   intelligibility (pystoi's algorithm).
  * mcd          — mel-cepstral distortion over DCT cepstra of log-mel
                   spectra (pymcd/pysptk use SPTK mcep; DCT mel-cepstra
                   are the standard approximation when SPTK is absent).
  * f0_metrics   — YIN pitch (de Cheveigné 2002) + voiced-only RMSE and
                   V/UV error (WORLD-harvest replacement).
"""
from __future__ import annotations

import numpy as np
from scipy.fft import dct
from scipy.signal import resample_poly


def _stft_mag(x: np.ndarray, n_fft: int, hop: int, win: np.ndarray) -> np.ndarray:
    pad = n_fft // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    return np.abs(np.fft.rfft(x[idx] * win, axis=-1))


def lsd(ref: np.ndarray, deg: np.ndarray, sr: int, n_fft: int = 2048,
        hop: int = 512) -> float:
    """Log-spectral distance in dB (LAS-RMSE)."""
    win = np.hanning(n_fft + 1)[:-1]
    R = _stft_mag(ref, n_fft, hop, win)
    D = _stft_mag(deg, n_fft, hop, win)
    lr = np.log10(np.maximum(R, 1e-8) ** 2)
    ld = np.log10(np.maximum(D, 1e-8) ** 2)
    return float(np.mean(np.sqrt(np.mean((10 * (lr - ld)) ** 2, axis=1))))


def snr(ref: np.ndarray, deg: np.ndarray, sr: int) -> float:
    """Mean-removed SNR in dB (Metrics/snr.py)."""
    ref = ref - ref.mean()
    deg = deg - deg.mean()
    noise = ref - deg
    den = np.sum(noise**2)
    if den <= 0:
        return np.inf
    return float(10.0 * np.log10(np.sum(ref**2) / den))


def si_snr(ref: np.ndarray, deg: np.ndarray, sr: int = 0) -> float:
    """Scale-invariant SNR (SI-SDR, Le Roux et al. 2019) in dB.

    The plain SNR above penalizes any global gain change, which makes it
    misleading for resynthesis-style enhancers (the joint denoise model
    re-synthesises the waveform from a predicted spectrum, so loudness
    is not sample-locked to the input). SI-SNR projects the estimate
    onto the reference first: s_t = <deg,ref>/||ref||^2 * ref,
    e = deg - s_t, SI-SNR = 10 log10(||s_t||^2 / ||e||^2).
    """
    ref = ref - ref.mean()
    deg = deg - deg.mean()
    denom = float(np.sum(ref**2))
    if denom <= 0:
        return -np.inf
    alpha = float(np.dot(deg, ref)) / denom
    s_t = alpha * ref
    err = deg - s_t
    num = float(np.sum(s_t**2))
    den = float(np.sum(err**2))
    if den <= 0:
        return np.inf
    return float(10.0 * np.log10(max(num, 1e-30) / den))


# ---------------------------------------------------------------------------
# STOI (Taal et al.), following the published algorithm / pystoi structure
# ---------------------------------------------------------------------------

_STOI_FS = 10000
_STOI_NFFT = 512
_STOI_WIN = 256
_STOI_HOP = 128
_STOI_NBANDS = 15
_STOI_MINFREQ = 150.0
_STOI_N = 30          # 384 ms analysis windows
_STOI_BETA = -15.0    # SDR clip (dB)
_STOI_DYN = 40.0      # energy VAD range (dB)


def _thirdoct_bands():
    f = np.linspace(0, _STOI_FS / 2, _STOI_NFFT // 2 + 1)
    k = np.arange(_STOI_NBANDS)
    cf = _STOI_MINFREQ * 2.0 ** (k / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    A = np.zeros((_STOI_NBANDS, len(f)))
    for i in range(_STOI_NBANDS):
        li = np.argmin((f - lo[i]) ** 2)
        hii = np.argmin((f - hi[i]) ** 2)
        A[i, li:hii] = 1.0
    return A


def _stoi_frames(x: np.ndarray) -> np.ndarray:
    win = np.hanning(_STOI_WIN + 2)[1:-1]
    # 0 frames for inputs shorter than one window (the old floor of 1
    # indexed past the end and crashed on sub-window clips)
    n_frames = 0 if len(x) < _STOI_WIN else 1 + (len(x) - _STOI_WIN) // _STOI_HOP
    idx = np.arange(n_frames)[:, None] * _STOI_HOP + np.arange(_STOI_WIN)[None, :]
    return x[idx] * win


def _remove_silent(ref_f, deg_f):
    energy = 20 * np.log10(np.linalg.norm(ref_f, axis=1) + 1e-12)
    mask = energy > energy.max() - _STOI_DYN
    return ref_f[mask], deg_f[mask]


def stoi(ref: np.ndarray, deg: np.ndarray, sr: int, extended: bool = False) -> float:
    if sr != _STOI_FS:
        import math
        g = math.gcd(sr, _STOI_FS)
        ref = resample_poly(ref, _STOI_FS // g, sr // g)
        deg = resample_poly(deg, _STOI_FS // g, sr // g)
    ref_f = _stoi_frames(ref)
    deg_f = _stoi_frames(deg)
    if len(ref_f) == 0:
        return np.nan
    n = min(len(ref_f), len(deg_f))
    ref_f, deg_f = _remove_silent(ref_f[:n], deg_f[:n])
    if len(ref_f) < _STOI_N:
        return np.nan

    A = _thirdoct_bands()
    R = np.abs(np.fft.rfft(ref_f, n=_STOI_NFFT, axis=1))
    D = np.abs(np.fft.rfft(deg_f, n=_STOI_NFFT, axis=1))
    X = np.sqrt(A @ (R.T**2)).T   # (frames, bands) ref band envelopes
    Y = np.sqrt(A @ (D.T**2)).T

    M = len(X) - _STOI_N + 1
    vals = []
    for m in range(M):
        xseg = X[m : m + _STOI_N]       # (N, bands)
        yseg = Y[m : m + _STOI_N]
        if extended:
            xn = (xseg - xseg.mean(0)) / (np.linalg.norm(xseg - xseg.mean(0), axis=0) + 1e-12)
            yn = (yseg - yseg.mean(0)) / (np.linalg.norm(yseg - yseg.mean(0), axis=0) + 1e-12)
            xr = (xn - xn.mean(1, keepdims=True))
            yr = (yn - yn.mean(1, keepdims=True))
            xr /= np.linalg.norm(xr, axis=1, keepdims=True) + 1e-12
            yr /= np.linalg.norm(yr, axis=1, keepdims=True) + 1e-12
            # each of the N time rows is unit-norm over bands, so the
            # segment intelligibility is the mean of N row correlations
            # (Jensen & Taal 2016 eq. 4; pystoi divides by N, not J)
            vals.append(np.sum(xr * yr) / _STOI_N)
        else:
            alpha = np.linalg.norm(xseg, axis=0) / (np.linalg.norm(yseg, axis=0) + 1e-12)
            yprime = yseg * alpha
            clip = xseg * (1 + 10 ** (-_STOI_BETA / 20.0))
            yprime = np.minimum(yprime, clip)
            xc = xseg - xseg.mean(0)
            yc = yprime - yprime.mean(0)
            corr = np.sum(xc * yc, axis=0) / (
                np.linalg.norm(xc, axis=0) * np.linalg.norm(yc, axis=0) + 1e-12
            )
            vals.append(corr.mean())
    return float(np.mean(vals))


def estoi(ref, deg, sr):
    return stoi(ref, deg, sr, extended=True)


# ---------------------------------------------------------------------------
# MCD via DCT mel-cepstra
# ---------------------------------------------------------------------------

def _mel_cepstra(x: np.ndarray, sr: int, n_mfc: int = 13) -> np.ndarray:
    from ..ops.spectral import _mel_filterbank_np

    n_fft, hop = 1024, 256
    win = np.hanning(n_fft + 1)[:-1]
    mag = _stft_mag(x, n_fft, hop, win)
    fb = _mel_filterbank_np(sr, n_fft, 40, 0.0, sr / 2.0)
    # floor at -50 dB: harmonically sparse signals otherwise blow up
    # the cepstral distance through near-zero bands
    logmel = np.log10(np.maximum(mag @ fb.T, 1e-5))
    return dct(logmel, type=2, axis=1, norm="ortho")[:, 1 : n_mfc + 1]


def mcd(ref: np.ndarray, deg: np.ndarray, sr: int) -> float:
    """Frame-wise mel-cepstral distortion in dB (pymcd 'plain' mode).

    MCD = (10/ln10)·sqrt(2·Σ dc²) over natural-log cepstra; with
    log10-based cepstra this reduces to 10·sqrt(2)·mean(||dc||₂).
    """
    R = _mel_cepstra(ref, sr)
    D = _mel_cepstra(deg, sr)
    n = min(len(R), len(D))
    diff = R[:n] - D[:n]
    return float(10.0 * np.sqrt(2.0) * np.mean(np.linalg.norm(diff, axis=1)))


# ---------------------------------------------------------------------------
# YIN pitch + F0 metrics
# ---------------------------------------------------------------------------

def yin_f0(x: np.ndarray, sr: int, fmin: float = 60.0, fmax: float = 500.0,
           frame: int = 1024, hop: int = 256, threshold: float = 0.15) -> np.ndarray:
    """Per-frame F0 in Hz; 0 = unvoiced. de Cheveigné & Kawahara 2002."""
    tau_min = int(sr / fmax)
    tau_max = int(sr / fmin)
    # 0 frames when the clip can't fit one analysis window + max lag
    need = frame + tau_max
    n_frames = 0 if len(x) < need else 1 + (len(x) - need) // hop
    f0 = np.zeros(n_frames)
    for i in range(n_frames):
        seg = x[i * hop : i * hop + frame + tau_max]
        w = seg[:frame]
        # d(tau) = e(0) + e(tau) - 2*r(tau); cross-terms via one strided
        # matmul over all lags
        cum = np.concatenate([[0.0], np.cumsum(seg * seg)])
        e0 = cum[frame]
        lags = np.arange(tau_max + 1)
        idx = lags[:, None] + np.arange(frame)[None, :]
        r = (seg[idx] @ w)
        d = e0 + (cum[lags + frame] - cum[lags]) - 2.0 * r
        # cumulative mean normalised difference
        cmnd = np.ones(tau_max + 1)
        run = np.cumsum(d[1:])
        cmnd[1:] = d[1:] * np.arange(1, tau_max + 1) / np.maximum(run, 1e-12)
        # first dip under threshold
        tau = 0
        for t in range(tau_min, tau_max):
            if cmnd[t] < threshold:
                while t + 1 <= tau_max and cmnd[t + 1] < cmnd[t]:
                    t += 1
                tau = t
                break
        if tau == 0:
            t_best = tau_min + int(np.argmin(cmnd[tau_min:tau_max]))
            if cmnd[t_best] < 0.5:
                tau = t_best
        if tau > 0:
            f0[i] = sr / tau
    return f0


def extract_f0(x: np.ndarray, sr: int, extractor: str = "dio") -> np.ndarray:
    """Frame F0 track via the WORLD-style DIO+StoneMask estimator
    (paper-scale, metrics/world_f0.py) with YIN as explicit fallback.
    Both produce the same frame grid (hop 256), so they are drop-in
    swappable."""
    if extractor == "dio":
        try:
            from .world_f0 import dio_f0
            return dio_f0(x, sr)
        except Exception:
            pass  # fall through to YIN on any numerical failure
    return yin_f0(x, sr)


def f0_metrics(ref: np.ndarray, deg: np.ndarray, sr: int,
               extractor: str = "dio") -> dict:
    """F0-RMSE (voiced-in-both frames), V/UV error rate, periodicity."""
    f0r = extract_f0(ref, sr, extractor)
    f0d = extract_f0(deg, sr, extractor)
    n = min(len(f0r), len(f0d))
    f0r, f0d = f0r[:n], f0d[:n]
    vr, vd = f0r > 0, f0d > 0
    both = vr & vd
    out = {"vuv_error": float(np.mean(vr != vd)) if n else np.nan}
    if both.sum():
        out["f0_rmse"] = float(np.sqrt(np.mean((f0r[both] - f0d[both]) ** 2)))
        semitone = 12 * np.log2(f0d[both] / f0r[both])
        out["semitone_acc"] = float(np.mean(np.abs(semitone) < 0.5))
    else:
        out["f0_rmse"] = np.nan
        out["semitone_acc"] = np.nan
    return out


def f0_rmse(ref, deg, sr):
    return f0_metrics(ref, deg, sr)["f0_rmse"]


_C0 = 440.0 * 2.0 ** (-4.75)  # Hz of C0, the semitone-grid origin


def _semitone_index(f0: np.ndarray) -> np.ndarray:
    """Integer semitone index per frame; large negative = silence.

    Matches the reference label scheme (evaluate_f0.py:26-38): the
    name+octave string is a bijection of round(12*log2(f/C0)), so label
    equality == index equality, with 'Sil' for unvoiced frames."""
    idx = np.full(f0.shape, -(10 ** 9), dtype=np.int64)
    v = f0 > 0
    idx[v] = np.round(12.0 * np.log2(f0[v] / _C0)).astype(np.int64)
    return idx


def evaluate_f0_metrics(ref: np.ndarray, deg: np.ndarray, sr: int,
                        extractor: str = "dio") -> dict:
    """DTW-aligned log-F0 RMSE, semitone ACC, V/UV error, and Hz F0-RMSE.

    Reference Metrics/evaluate_f0.py:136-208 and f0_rmse.py:18-131
    semantics: WORLD harvest + SPTK mcep + fastdtw there; WORLD-style
    DIO+StoneMask (metrics/world_f0.py, paper-scale extractor) + DCT
    mel-cepstra + banded DTW here. extractor="yin" selects the round-2
    YIN stand-in (kept as fallback; the two agree within ~1 Hz on
    voiced synth frames, tests/test_world_f0.py).
    """
    from .dtw import dtw_path

    f0r = extract_f0(ref, sr, extractor)
    f0d = extract_f0(deg, sr, extractor)
    R = _mel_cepstra(ref, sr)
    D = _mel_cepstra(deg, sr)
    # mcep has a few more frames than YIN (YIN needs frame+tau_max of
    # lookahead); align the common prefix so DTW indices stay valid
    nr = min(len(R), len(f0r))
    nd = min(len(D), len(f0d))
    if nr == 0 or nd == 0:
        return {"log_f0_rmse": np.nan, "semitone_acc": np.nan,
                "vuv_error": np.nan, "f0_rmse_hz": np.nan}
    pd_, pr = dtw_path(D[:nd], R[:nr], band=max(10, abs(nd - nr) + 10))
    gt = f0r[pr]
    gen = f0d[pd_]

    out = {"semitone_acc": float(np.mean(_semitone_index(gt) == _semitone_index(gen)))}
    vr, vd = gt > 0, gen > 0
    out["vuv_error"] = float(np.mean(vr != vd))
    both = vr & vd
    if both.any():
        out["log_f0_rmse"] = float(
            np.sqrt(np.mean((np.log(gen[both]) - np.log(gt[both])) ** 2)))
        out["f0_rmse_hz"] = float(np.sqrt(np.mean((gen[both] - gt[both]) ** 2)))
    else:
        out["log_f0_rmse"] = np.nan
        out["f0_rmse_hz"] = np.nan
    return out


def mcd_dtw(ref: np.ndarray, deg: np.ndarray, sr: int) -> float:
    """DTW-aligned mel-cepstral distortion (Metrics/mcd_utils.py semantics:
    SPTK mcep + fastdtw there; DCT mel-cepstra + banded DTW here)."""
    from .dtw import dtw_path

    R = _mel_cepstra(ref, sr)
    D = _mel_cepstra(deg, sr)
    px, py = dtw_path(R, D, band=max(10, abs(len(R) - len(D)) + 10))
    diff = R[px] - D[py]
    return float(10.0 * np.sqrt(2.0) * np.mean(np.linalg.norm(diff, axis=1)))


def yin_f0_conf(x: np.ndarray, sr: int, **kw):
    """YIN F0 plus per-frame periodicity confidence (1 - cmnd at tau)."""
    # re-run the YIN loop but also collect the cmnd minimum
    fmin = kw.get("fmin", 60.0); fmax = kw.get("fmax", 500.0)
    frame = kw.get("frame", 1024); hop = kw.get("hop", 256)
    threshold = kw.get("threshold", 0.15)
    tau_min = int(sr / fmax); tau_max = int(sr / fmin)
    need = frame + tau_max
    n_frames = 0 if len(x) < need else 1 + (len(x) - need) // hop
    f0 = np.zeros(n_frames); conf = np.zeros(n_frames)
    for i in range(n_frames):
        seg = x[i * hop : i * hop + frame + tau_max]
        w = seg[:frame]
        cum = np.concatenate([[0.0], np.cumsum(seg * seg)])
        e0 = cum[frame]
        lags = np.arange(tau_max + 1)
        idx = lags[:, None] + np.arange(frame)[None, :]
        r = seg[idx] @ w
        d = e0 + (cum[lags + frame] - cum[lags]) - 2.0 * r
        cmnd = np.ones(tau_max + 1)
        run = np.cumsum(d[1:])
        cmnd[1:] = d[1:] * np.arange(1, tau_max + 1) / np.maximum(run, 1e-12)
        tau = 0
        for t in range(tau_min, tau_max):
            if cmnd[t] < threshold:
                while t + 1 <= tau_max and cmnd[t + 1] < cmnd[t]:
                    t += 1
                tau = t
                break
        best = tau if tau else tau_min + int(np.argmin(cmnd[tau_min:tau_max]))
        conf[i] = max(0.0, 1.0 - cmnd[best])
        if tau == 0 and cmnd[best] < 0.5:
            tau = best
        if tau > 0:
            f0[i] = sr / tau
    return f0, conf


# cargan's Pitch metric voicing threshold on CREPE periodicity
_CREPE_VOICING_THRESHOLD = 0.1625


def periodicity_metrics(ref: np.ndarray, deg: np.ndarray, sr: int,
                        device: str = "cuda") -> dict:
    """Periodicity RMSE, pitch RMSE (cents->Hz style), V/UV F1.

    Counterpart of the reference Metrics/evaluate.py (cargan +
    torchcrepe there). With $NVSE_CREPE_CKPT pointing at the public
    torchcrepe full.pth, pitch/periodicity come from the CREPE network
    (metrics/crepe.py) on `device`, the card unless "cpu", on the
    reference scale; otherwise YIN pitch + YIN confidence stand in.
    """
    from .crepe import (crepe_ckpt_from_env, crepe_model_from_env, load_crepe,
                        predict_f0_periodicity)

    ckpt = crepe_ckpt_from_env()
    if ckpt is not None:
        net = load_crepe(ckpt, crepe_model_from_env(), str(device))
        f0r, cr = predict_f0_periodicity(ref, sr, net)
        f0d, cd = predict_f0_periodicity(deg, sr, net)
        f0r = np.where(cr > _CREPE_VOICING_THRESHOLD, f0r, 0.0)
        f0d = np.where(cd > _CREPE_VOICING_THRESHOLD, f0d, 0.0)
    else:
        f0r, cr = yin_f0_conf(ref, sr)
        f0d, cd = yin_f0_conf(deg, sr)
    n = min(len(f0r), len(f0d))
    f0r, f0d, cr, cd = f0r[:n], f0d[:n], cr[:n], cd[:n]
    vr, vd = f0r > 0, f0d > 0
    tp = float(np.sum(vr & vd)); fp = float(np.sum(~vr & vd)); fn = float(np.sum(vr & ~vd))
    f1 = 2 * tp / max(2 * tp + fp + fn, 1e-9)
    out = {"periodicity_rmse": float(np.sqrt(np.mean((cr - cd) ** 2))), "vuv_f1": f1}
    both = vr & vd
    if both.any():
        cents = 1200.0 * np.log2(np.maximum(f0d[both], 1e-9) / np.maximum(f0r[both], 1e-9))
        out["pitch_rmse_cents"] = float(np.sqrt(np.mean(cents ** 2)))
    else:
        out["pitch_rmse_cents"] = float("nan")
    return out
