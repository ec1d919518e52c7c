"""F0 extractor support library — counterpart of reference Metrics/f0/f0.py
(the port's copy of nvse_tpu/metrics/f0_lib.py).

The reference vendors an Amphion utility module (Metrics/f0/f0.py:1-298)
that wraps five pitch extractors (pyin / parselmouth / dio / harvest /
torchcrepe) behind a ``get_f0(audio, cfg)`` dispatch plus shared numpy
utilities (unvoiced interpolation, coarse pitch bins, cent conversion).
None of its backends exist in this environment (librosa, parselmouth,
pyworld, torchcrepe are all C/DL extensions), and none of the reference
CLIs actually import the module — but users of the reference do, so this
module recreates the same API surface on top of the in-repo extractors:

  * ``dio`` / ``harvest``  -> world_f0.dio_f0
        (DIO + StoneMask, the same algorithm family pyworld wraps)
  * ``pyin``               -> dsp.yin_f0
        (YIN is the core of probabilistic-YIN; unvoiced frames are 0)
  * ``parselmouth``        -> Boersma's autocorrelation method
        (praat ``to_pitch_ac``: normalized AC of the windowed frame
        divided by the window AC, parabolic peak refinement, octave-
        cost candidate scoring — implemented below in numpy)
  * ``crepe``              -> the CREPE network (metrics/crepe.py) when
        $NVSE_CREPE_CKPT names a torchcrepe checkpoint, else
        yin_f0_conf, with the reference's median-filtered confidence
        threshold + interpolation contract

All utilities (interpolate, get_log_f0, f0_to_coarse, get_bin_index,
get_cents, get_pitch_derivatives, get_pitch_sub_median) match the
reference's numeric contracts in plain numpy; get_bin_index also accepts
torch tensors for drop-in compatibility (the reference's version is
torch-only and marked "to abandon").
"""
from __future__ import annotations

import numpy as np

from .dsp import yin_f0, yin_f0_conf
from .world_f0 import dio_f0


# ---------------------------------------------------------------- utilities

def get_bin_index(f0, m, M, n_bins, use_log_scale):
    """Quantize f0 into n_bins indices; 0 is reserved for unvoiced.

    Mirrors Metrics/f0/f0.py:14-46 (numpy-native; accepts torch too).
    """
    torch_mod = None
    if not isinstance(f0, np.ndarray):  # torch tensor
        import torch as torch_mod
        f0_np = f0.detach().cpu().numpy().astype(np.float64)
    else:
        f0_np = np.asarray(f0, dtype=np.float64)
    raw_f0 = f0_np.copy()
    raw_m, raw_M = float(m), float(M)
    lo, hi = float(m), float(M)
    if use_log_scale:
        f0_np = np.where(f0_np == 0, 1.0, f0_np)
        f0_np = np.log(f0_np)
        lo, hi = float(np.log(lo)), float(np.log(hi))
    width = (hi + 1e-7 - lo) / (n_bins - 1)
    index = np.floor((f0_np - lo) / width) + 1
    index[raw_f0 == 0] = 0
    index[raw_f0 > raw_M] = n_bins - 1
    index[raw_f0 < raw_m] = 0
    index = index.astype(np.int64)
    if torch_mod is not None:
        return torch_mod.as_tensor(index, dtype=torch_mod.long)
    return index


def f0_to_coarse(f0, pitch_bin, pitch_min, pitch_max):
    """Mel-scale coarse pitch indices in [1, pitch_bin-1] (f0.py:49-68)."""
    f0 = np.asarray(f0, dtype=np.float64)
    f0_mel_min = 1127.0 * np.log(1 + pitch_min / 700.0)
    f0_mel_max = 1127.0 * np.log(1 + pitch_max / 700.0)
    f0_mel = 1127.0 * np.log(1 + f0 / 700.0)
    scaled = (f0_mel - f0_mel_min) * (pitch_bin - 2) / (f0_mel_max - f0_mel_min) + 1
    f0_mel = np.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = np.clip(f0_mel, 1, pitch_bin - 1)
    f0_coarse = np.rint(f0_mel).astype(np.int32)
    assert f0_coarse.max() <= 255 and f0_coarse.min() >= 1, (
        f0_coarse.max(), f0_coarse.min())
    return f0_coarse


def interpolate(f0):
    """Fill unvoiced gaps by linear interpolation; return (f0, uv mask).

    The uv mask is eroded by the reference's 3-tap min + edge pad
    (f0.py:71-85) so single voiced frames do not punch holes in it.
    """
    f0 = np.array(f0, dtype=np.float64, copy=True)
    uv = f0 == 0
    if (~uv).sum() > 0:
        f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0[~uv])
        uv = uv.astype(np.float64)
        uv = np.min(np.array([uv[:-2], uv[1:-1], uv[2:]]), axis=0)
        uv = np.pad(uv, (1, 1))
    return f0, uv


def get_log_f0(f0):
    """log-F0 with unvoiced frames mapped to log(1)=0 (f0.py:88-91)."""
    f0 = np.array(f0, dtype=np.float64, copy=True)
    f0[f0 == 0] = 1
    return np.log(f0)


def get_cents(f0_hz):
    """Voiced frames in cents relative to A440 (f0.py:267-275)."""
    f0_hz = np.asarray(f0_hz, dtype=np.float64)
    voiced = f0_hz[f0_hz != 0]
    return 1200.0 * np.log2(voiced / 440.0)


def get_pitch_derivatives(f0_hz):
    """First difference of the cent track (f0.py:278-283)."""
    f0_cent = get_cents(f0_hz)
    return f0_cent[1:] - f0_cent[:-1]


def get_pitch_sub_median(f0_hz):
    """Cent track re-centered on its median (f0.py:286-298; the
    reference file is truncated mid-body upstream — this is the evident
    completion)."""
    f0_cent = get_cents(f0_hz)
    if f0_cent.size == 0:
        return f0_cent
    return f0_cent - np.median(f0_cent)


# ---------------------------------------------------------------- extractors

def get_f0_features_using_pyin(audio, cfg):
    """YIN-backed stand-in for librosa.pyin (f0.py:97-119)."""
    f0 = yin_f0(np.asarray(audio, dtype=np.float64), cfg.sample_rate,
                fmin=cfg.f0_min, fmax=cfg.f0_max,
                frame=cfg.win_size, hop=cfg.hop_size)
    return f0


def _praat_ac_frame(frame, sr, fmin, fmax):
    """One frame of Boersma's method: normalized AC of the Hanning-
    windowed, mean-subtracted frame divided by the window's own AC."""
    n = frame.size
    frame = frame - frame.mean()
    win = np.hanning(n)
    fx = frame * win
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    # autocorrelation via power spectrum (exact for zero-padded input)
    ac_x = np.fft.irfft(np.abs(np.fft.rfft(fx, nfft)) ** 2)[:n]
    ac_w = np.fft.irfft(np.abs(np.fft.rfft(win, nfft)) ** 2)[:n]
    if ac_x[0] <= 0:
        return 0.0, 0.0
    r = (ac_x / ac_x[0]) / np.maximum(ac_w / ac_w[0], 1e-12)
    lag_min = max(2, int(sr / fmax))
    lag_max = min(n - 2, int(sr / fmin))
    if lag_max <= lag_min:
        return 0.0, 0.0
    seg = r[lag_min:lag_max]
    peaks = np.where((seg[1:-1] > seg[:-2]) & (seg[1:-1] >= seg[2:]))[0] + 1
    if peaks.size == 0:
        return 0.0, 0.0
    octave_cost = 0.01
    strengths = seg[peaks] - octave_cost * np.log2((peaks + lag_min) * fmin / sr)
    best = peaks[int(np.argmax(strengths))]
    # parabolic refinement around the integer-lag peak
    k = best + lag_min
    a, b, c = r[k - 1], r[k], r[k + 1]
    denom = a - 2 * b + c
    delta = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
    lag = k + np.clip(delta, -0.5, 0.5)
    return sr / lag, float(b)


def get_f0_features_using_parselmouth(audio, cfg, speed=1):
    """Boersma autocorrelation pitch (praat to_pitch_ac), numpy.

    Matches the reference contract (f0.py:122-160): returns
    (f0, pitch_coarse) on the hop grid, voicing_threshold=0.6,
    and honors the `speed` hop multiplier.
    """
    audio = np.asarray(audio, dtype=np.float64)
    hop = int(np.round(cfg.hop_size * speed))
    # praat uses 3 periods of the lowest pitch as its window
    n_win = int(3 * cfg.sample_rate / cfg.f0_min)
    n_frames = max(0, 1 + (audio.size - n_win) // hop)
    f0 = np.zeros(max(n_frames, 0), dtype=np.float64)
    voicing_threshold = 0.6
    for i in range(n_frames):
        frame = audio[i * hop:i * hop + n_win]
        hz, strength = _praat_ac_frame(frame, cfg.sample_rate,
                                       cfg.f0_min, cfg.f0_max)
        if strength >= voicing_threshold and cfg.f0_min <= hz <= cfg.f0_max:
            f0[i] = hz
    pitch_coarse = f0_to_coarse(f0, cfg.pitch_bin, cfg.f0_min, cfg.f0_max)
    return f0, pitch_coarse


def get_f0_features_using_dio(audio, cfg):
    """DIO + StoneMask (the pyworld pipeline, f0.py:163-186)."""
    return dio_f0(np.asarray(audio, dtype=np.float64), cfg.sample_rate,
                  fmin=cfg.f0_min, fmax=cfg.f0_max, hop=cfg.hop_size)


def get_f0_features_using_harvest(audio, mel_len, fs, hop_length, f0_min, f0_max):
    """Harvest-signature wrapper over the DIO extractor (f0.py:189-210)."""
    f0 = dio_f0(np.asarray(audio, dtype=np.float64), fs,
                fmin=f0_min, fmax=f0_max, hop=hop_length)
    return f0.astype(np.float64)[:mel_len]


def get_f0_features_using_crepe(audio, mel_len, fs, hop_length,
                                hop_length_new, f0_min, f0_max, threshold=0.3,
                                device="cuda"):
    """torchcrepe contract (f0.py:213-262): confidence-gated F0 at
    16 kHz / hop_length_new, median-filtered confidence, unvoiced
    frames interpolated onto the original mel frame grid. With
    $NVSE_CREPE_CKPT set, F0/confidence come from the CREPE network
    (metrics/crepe.py) on `device`, the card unless "cpu"; otherwise YIN
    stands in."""
    from .crepe import crepe_ckpt_from_env

    audio = np.asarray(audio, dtype=np.float64)
    if fs != 16000:
        t_new = np.arange(int(audio.size * 16000 / fs)) / 16000.0
        audio_16k = np.interp(t_new, np.arange(audio.size) / fs, audio)
    else:
        audio_16k = audio
    ckpt = crepe_ckpt_from_env()
    if ckpt is not None:
        from .crepe import crepe_model_from_env, load_crepe, predict_f0_periodicity

        f0, conf = predict_f0_periodicity(
            audio_16k, 16000, load_crepe(ckpt, crepe_model_from_env(), str(device)),
            fmin=f0_min, fmax=f0_max, hop=hop_length_new)
    else:
        f0, conf = yin_f0_conf(audio_16k, 16000, fmin=f0_min, fmax=f0_max,
                               hop=hop_length_new)
    # median-filter the confidence track (torchcrepe.filter.median(pd, 3))
    if conf.size >= 3:
        conf = np.median(
            np.stack([np.roll(conf, 1), conf, np.roll(conf, -1)]), axis=0)
    f0 = np.where(conf >= threshold, f0, 0.0)
    # mean-filter voiced f0 (torchcrepe.filter.mean(f0, 3))
    voiced = f0 > 0
    if voiced.any():
        padded = np.pad(f0, 1, mode="edge")
        sm = (padded[:-2] + padded[1:-1] + padded[2:]) / 3.0
        f0 = np.where(voiced, sm, 0.0)
    nz = np.nonzero(f0)[0]
    if nz.size == 0:
        return np.zeros(mel_len, dtype=np.float64)
    time_org = (hop_length_new / 16000.0) * nz
    time_frame = np.arange(mel_len) * hop_length / fs
    return np.interp(time_frame, time_org, f0[nz],
                     left=f0[nz][0], right=f0[nz][-1])


def get_f0(audio, cfg):
    """Extractor dispatch, mirroring f0.py:265-273 (+ dio alias)."""
    if cfg.pitch_extractor == "dio":
        return get_f0_features_using_dio(audio, cfg)
    if cfg.pitch_extractor == "pyin":
        return get_f0_features_using_pyin(audio, cfg)
    if cfg.pitch_extractor == "parselmouth":
        f0, _ = get_f0_features_using_parselmouth(audio, cfg)
        return f0
    raise ValueError(f"unknown pitch_extractor: {cfg.pitch_extractor!r}")
