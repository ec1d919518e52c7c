"""Spectral ops of the BSRNN mel->wave path, in PyTorch.

Counterpart of nvse_tpu/ops/spectral.py for the functions this slice
runs. The JAX package builds its DFT from matmuls only because the TPU
has no FFT lowering; here the transforms are torch.fft (cuFFT on the
card). Semantics are torch.stft/torch.istft (center=True, reflect pad,
one-sided) and the librosa Slaney mel basis, as in the reference.

Host-side bases (window, mel filterbank, its pseudo-inverse) are numpy,
computed once and cached; the feature matmuls run in float32 at full
precision (resolve_device disables TF32 on the card).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "amp_pha_spectrum",
    "hann_window",
    "inverse_mel",
    "istft_ri",
    "mel_spectrogram",
    "mel_spectrogram_np",
    "stft_ri",
]


# ---------------------------------------------------------------------------
# windows / filterbanks (host numpy, cached)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _hann_np(win_size: int) -> np.ndarray:
    """Periodic Hann window == torch.hann_window(win_size)."""
    n = np.arange(win_size, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)).astype(np.float32)


def hann_window(win_size: int) -> np.ndarray:
    """Periodic Hann window as a host numpy array (read-only, cached)."""
    return _hann_np(win_size)


def _hz_to_mel_slaney(f):
    """Slaney mel scale (librosa htk=False): linear < 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    return np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=None)
def _mel_filterbank_np(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """librosa.filters.mel equivalent (Slaney norm, htk=False), float32 (M, F)."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_lo, mel_hi = _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax)
    hz_pts = _mel_to_hz_slaney(np.linspace(mel_lo, mel_hi, n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    weights = np.zeros((n_mels, n_fft // 2 + 1), dtype=np.float64)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])  # Slaney area norm
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _inv_mel_basis_np(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Moore-Penrose pseudo-inverse of the mel basis, float32 (F, M)."""
    basis = _mel_filterbank_np(sr, n_fft, n_mels, fmin, fmax)
    return np.linalg.pinv(basis.astype(np.float64)).astype(np.float32)


def _pad_window(window: np.ndarray, n_fft: int) -> np.ndarray:
    """Center-pad a win_size window to n_fft (torch.stft semantics)."""
    win_size = window.shape[0]
    if win_size == n_fft:
        return window
    left = (n_fft - win_size) // 2
    out = np.zeros(n_fft, dtype=window.dtype)
    out[left : left + win_size] = window
    return out


# Device copies of the host constants, made once per device (and per
# frame count for the iSTFT envelope): a copy from pageable host memory
# inside a forward would wait for the stream to drain.

@functools.lru_cache(maxsize=64)
def _istft_consts(win_bytes: bytes, n_fft: int, hop: int, T: int, device: torch.device):
    """(window, OLA envelope with values <= 1e-11 replaced by 1) on device."""
    win = np.frombuffer(win_bytes, np.float32)
    env = np.zeros(n_fft + hop * (T - 1), np.float32)
    for t in range(T):
        env[t * hop : t * hop + n_fft] += win * win
    env = np.where(env > 1e-11, env, 1.0).astype(np.float32)
    return torch.from_numpy(win.copy()).to(device), torch.from_numpy(env).to(device)


@functools.lru_cache(maxsize=None)
def _mel_consts(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float, win_size: int,
                device: torch.device):
    """(Hann window, mel basis (M, F), its pseudo-inverse (F, M)) on device."""
    return (torch.from_numpy(_hann_np(win_size).copy()).to(device),
            torch.from_numpy(_mel_filterbank_np(sr, n_fft, n_mels, fmin, fmax)).to(device),
            torch.from_numpy(_inv_mel_basis_np(sr, n_fft, n_mels, fmin, fmax)).to(device))


@functools.lru_cache(maxsize=64)
def _window_on(win_bytes: bytes, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(win_bytes, np.float32).copy()).to(device)


# ---------------------------------------------------------------------------
# STFT
# ---------------------------------------------------------------------------

def stft_ri(y: torch.Tensor, n_fft: int, hop_size: int, win_size: int,
            window: np.ndarray | None = None):
    """torch.stft on (..., L) returning (real, imag), each (..., F, T).

    Centred: reflect-pads n_fft//2 on each side; one-sided, F =
    n_fft//2 + 1. window=None is torch.stft's default: ones(win_size)
    zero-padded to n_fft (the multi-resolution discriminator's
    rectangular window), not ones(n_fft). The transform runs in float32
    (cuFFT has no bfloat16) and the result has the input's dtype.
    """
    win_np = np.ones(win_size, np.float32) if window is None else np.asarray(window, np.float32)
    win = _window_on(_pad_window(win_np, n_fft).tobytes(), y.device)
    lead = y.shape[:-1]
    spec = torch.stft(y.float().reshape(-1, y.shape[-1]), n_fft, hop_length=hop_size,
                      win_length=n_fft, window=win, center=True, pad_mode="reflect",
                      normalized=False, onesided=True, return_complex=True)
    re = spec.real.reshape(*lead, *spec.shape[-2:]).to(y.dtype)
    im = spec.imag.reshape(*lead, *spec.shape[-2:]).to(y.dtype)
    return re, im


def _safe_magnitude(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """sqrt(re^2 + im^2) floored at 1e-24 under the sqrt, so the gradient
    is 0, not NaN, at exact-zero bins (nvse_tpu/ops/spectral.py:452-461)."""
    return torch.sqrt(torch.clamp(re * re + im * im, min=1e-24))


def amp_pha_spectrum(y: torch.Tensor, n_fft: int, hop_size: int, win_size: int,
                     eps: float = 1e-7):
    """wave (..., L) -> (log_amplitude, phase, real, imag), each (..., F, T).

    Reference dataset.py:123-139 (eps 1e-7; the joint-denoise duplicate
    uses 1e-5, passed explicitly). Hann window, center=True.
    """
    rea, imag = stft_ri(y, n_fft, hop_size, win_size, window=hann_window(win_size))
    log_amplitude = torch.log(_safe_magnitude(rea, imag) + eps)
    return log_amplitude, torch.atan2(imag, rea), rea, imag


# ---------------------------------------------------------------------------
# iSTFT
# ---------------------------------------------------------------------------

def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """OLA of (N, T, n_fft) frames at stride hop -> (N, n_fft + hop*(T-1))."""
    N, T, n_fft = frames.shape
    L = n_fft + hop * (T - 1)
    out = F.fold(frames.transpose(1, 2), output_size=(1, L),
                 kernel_size=(1, n_fft), stride=(1, hop))
    return out.reshape(N, L)


def istft_ri(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_size: int,
             win_size: int, window: np.ndarray | None = None,
             center: bool = True, length: int | None = None) -> torch.Tensor:
    """torch.istft equivalent on (real, imag) pairs, each (..., F, T).

    Inverse real FFT per frame, (n_fft-padded) window, overlap-add,
    division by the overlap-added squared window where it exceeds 1e-11
    (elsewhere by 1), then the n_fft//2 center crop. Runs in float32.
    Default output length = hop_size * (T - 1).
    """
    if window is None:
        win_np = _pad_window(np.ones(win_size, dtype=np.float32), n_fft)
    else:
        win_np = _pad_window(np.asarray(window, np.float32), n_fft)
    lead, T = re.shape[:-2], re.shape[-1]
    win, env = _istft_consts(win_np.tobytes(), n_fft, hop_size, T, re.device)
    spec = torch.complex(re.float(), im.float()).transpose(-1, -2)   # (..., T, F)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win
    y = _overlap_add(frames.reshape(-1, T, n_fft), hop_size) / env

    if center:
        y = y[..., n_fft // 2 :]
        target = length if length is not None else hop_size * (T - 1)
    else:
        target = length if length is not None else n_fft + hop_size * (T - 1)
    return y[..., :target].reshape(*lead, -1)


# ---------------------------------------------------------------------------
# mel pipeline
# ---------------------------------------------------------------------------

def mel_spectrogram(y: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int,
                    hop_size: int, win_size: int, fmin: float, fmax: float,
                    center: bool = True) -> torch.Tensor:
    """wave (..., L) -> log-mel (..., num_mels, T), float32.

    Reference dataset.py:53-91: torch.stft magnitude (floored under the
    sqrt at 1e-24), Slaney mel basis, log(clamp(., 1e-5)).
    """
    y = y.float()
    lead = y.shape[:-1]
    win, basis, _ = _mel_consts(sampling_rate, n_fft, num_mels, float(fmin), float(fmax),
                                win_size, y.device)
    spec = torch.stft(y.reshape(-1, y.shape[-1]), n_fft, hop_length=hop_size,
                      win_length=win_size, window=win, center=center,
                      pad_mode="reflect", normalized=False, onesided=True,
                      return_complex=True)                          # (N, F, T)
    mag = torch.sqrt(torch.clamp(spec.real * spec.real + spec.imag * spec.imag, min=1e-24))
    mel = torch.matmul(basis, mag)
    return torch.log(torch.clamp(mel, min=1e-5)).reshape(*lead, num_mels, -1)


def _frame_np(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    n_frames = 1 + (y.shape[-1] - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    return y[..., idx]


def mel_spectrogram_np(y: np.ndarray, n_fft: int, num_mels: int, sampling_rate: int,
                       hop_size: int, win_size: int, fmin: float, fmax: float,
                       center: bool = True) -> np.ndarray:
    """Host-side numpy twin of mel_spectrogram (float64 accumulation ->
    float32). run_inference computes features with it so the card runs
    only the batched generator."""
    y = np.asarray(y, np.float64)
    if center:
        pad = n_fft // 2
        y = np.pad(y, [(0, 0)] * (y.ndim - 1) + [(pad, pad)], mode="reflect")
    win = _pad_window(_hann_np(win_size), n_fft).astype(np.float64)
    frames = _frame_np(y, n_fft, hop_size) * win
    mag = np.abs(np.fft.rfft(frames, n=n_fft, axis=-1))    # (..., T, F)
    mag = np.sqrt(np.maximum(mag * mag, 1e-24))
    basis = _mel_filterbank_np(sampling_rate, n_fft, num_mels,
                               float(fmin), float(fmax)).astype(np.float64)
    mel = np.einsum("mf,...tf->...mt", basis, mag)
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)


def inverse_mel(mel: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int,
                hop_size: int, win_size: int, fmin: float, fmax: float) -> torch.Tensor:
    """log-mel (..., M, T) -> pseudo magnitude spectrum (..., F, T), float32.

    Reference dataset.py:94-120: pinv(mel_basis) @ exp(mel). The result
    may hold small negative values; callers apply abs().clamp_min(1e-5).
    """
    _, _, inv = _mel_consts(sampling_rate, n_fft, num_mels, float(fmin), float(fmax),
                            win_size, mel.device)
    return torch.matmul(inv, torch.exp(mel).float())
