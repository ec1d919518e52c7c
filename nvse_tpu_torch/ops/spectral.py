"""Spectral ops of the BSRNN mel->wave path, in PyTorch.

Counterpart of nvse_tpu/ops/spectral.py for the functions the ported
paths run. The JAX package builds its DFT from matmuls only because the TPU
has no FFT lowering; here the transforms are torch.fft (cuFFT on the
card). Semantics are torch.stft/torch.istft (center=True, reflect pad,
one-sided) and the librosa Slaney mel basis, as in the reference.

Host-side bases (window, mel filterbank, its pseudo-inverse) are numpy,
computed once, cached and read-only (a caller that wrote into one would
change every later transform of the process); the feature matmuls run in float32 at full
precision (resolve_device disables TF32 on the card).
"""
from __future__ import annotations

import functools
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "StreamingOLA",
    "amp_pha_spectrum",
    "hann_window",
    "inverse_mel",
    "istft_frames",
    "istft_ri",
    "joint_input",
    "mel_spectrogram",
    "mel_spectrogram_np",
    "stft_ri",
]


# ---------------------------------------------------------------------------
# windows / filterbanks (host numpy, cached)
# ---------------------------------------------------------------------------

def _read_only(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


@functools.lru_cache(maxsize=None)
def _hann_np(win_size: int) -> np.ndarray:
    """Periodic Hann window == torch.hann_window(win_size), read-only."""
    n = np.arange(win_size, dtype=np.float64)
    return _read_only((0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)).astype(np.float32))


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
    """librosa.filters.mel equivalent (Slaney norm, htk=False), float32 (M, F),
    read-only."""
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
    return _read_only(weights.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _inv_mel_basis_np(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Moore-Penrose pseudo-inverse of the mel basis, float32 (F, M), read-only."""
    basis = _mel_filterbank_np(sr, n_fft, n_mels, fmin, fmax)
    return _read_only(np.linalg.pinv(basis.astype(np.float64)).astype(np.float32))


def _pad_window(window: np.ndarray, n_fft: int) -> np.ndarray:
    """Center-pad a win_size window to n_fft (torch.stft semantics)."""
    win_size = window.shape[0]
    if win_size == n_fft:
        return window
    left = (n_fft - win_size) // 2
    out = np.zeros(n_fft, dtype=window.dtype)
    out[left : left + win_size] = window
    return out


def _padded_window(window: np.ndarray | None, win_size: int, n_fft: int) -> np.ndarray:
    """The window padded to n_fft, float32; None is torch.stft's and torch.istft's default,
    ones(win_size)."""
    win = np.ones(win_size, np.float32) if window is None else np.asarray(window, np.float32)
    return _pad_window(win, n_fft)


# Device copies of the host constants, made once per device (and per
# frame count for the iSTFT envelope): a copy from pageable host memory
# inside a forward would wait for the stream to drain. They are made with
# inference mode off: a tensor first made under torch.inference_mode() (a
# decode) could not be saved for backward when training reads the cache later.

def _on_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(a.copy()).to(device)


def device_cache(maxsize: int | None):
    """A least-recently-used cache of a device constant (as functools.lru_cache)
    that a torch.export trace reads but never fills: a tensor made during a
    trace belongs to it (a fake tensor) and must not be served to a later call.
    A constant cached before the trace (export_decoder decodes once first) goes
    into the graph as it is; one made in the trace is the trace's own."""
    def wrap(fn):
        cache: OrderedDict = OrderedDict()

        @functools.wraps(fn)
        def call(*args):
            if args in cache:
                cache.move_to_end(args)
                return cache[args]
            out = fn(*args)
            if not torch.compiler.is_exporting():
                cache[args] = out
                if maxsize is not None and len(cache) > maxsize:
                    cache.popitem(last=False)
            return out

        call.cache_clear = cache.clear
        return call
    return wrap


@device_cache(maxsize=64)
def _istft_envelope(win_bytes: bytes, n_fft: int, hop: int, T: int, device: torch.device):
    """The window's OLA envelope over T frames, values <= 1e-11 replaced by
    1, on device."""
    win = np.frombuffer(win_bytes, np.float32)
    env = np.zeros(n_fft + hop * (T - 1), np.float32)
    # one pass per window sample, T frames at a time (iSTFTNet's head: 65,537 frames of 16),
    # the last sample first: each entry sums its frames in time order, as frame by frame
    for j in reversed(range(n_fft)):
        env[j : j + hop * T : hop] += win[j] * win[j]
    env = np.where(env > 1e-11, env, 1.0).astype(np.float32)
    return _on_device(env, device)


@device_cache(maxsize=None)
def _mel_consts(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float, win_size: int,
                device: torch.device):
    """(Hann window, mel basis (M, F), its pseudo-inverse (F, M)) on device."""
    return (_on_device(_hann_np(win_size), device),
            _on_device(_mel_filterbank_np(sr, n_fft, n_mels, fmin, fmax), device),
            _on_device(_inv_mel_basis_np(sr, n_fft, n_mels, fmin, fmax), device))


@device_cache(maxsize=64)
def _window_on(win_bytes: bytes, device: torch.device) -> torch.Tensor:
    return _on_device(np.frombuffer(win_bytes, np.float32), device)


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
    win = _window_on(_padded_window(window, win_size, n_fft).tobytes(), y.device)
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


def istft_frames(re: torch.Tensor, im: torch.Tensor, n_fft: int, win_size: int,
                 window: np.ndarray | None = None) -> torch.Tensor:
    """Windowed synthesis frames (..., T, n_fft) of (real, imag) pairs, each
    (..., F, T): the stage of istft_ri before the overlap-add, in float32.
    A streaming decoder overlap-adds chunks of these with carried tails
    (StreamingOLA), which reproduces the offline istft_ri: a sample is
    emitted once every frame that touches it has arrived."""
    win = _window_on(_padded_window(window, win_size, n_fft).tobytes(), re.device)
    spec = torch.complex(re.float(), im.float()).transpose(-1, -2)   # (..., T, F)
    return torch.fft.irfft(spec, n=n_fft, dim=-1) * win


class StreamingOLA:
    """Streaming overlap-add with the squared-window normalisation, on the
    host in float64.

    push() takes windowed synthesis frames (B, c, n_fft) chunk by chunk
    and emits the c * hop samples whose every contributing frame has
    arrived; the trailing n_fft - hop samples stay in a carried numerator
    and envelope tail, which flush() finalises. All emissions
    concatenated equal istft_ri's output before its center crop: the
    caller drops the first n_fft // 2 samples and trims to its length.
    """

    def __init__(self, n_fft: int, hop_size: int, win_size: int,
                 window: np.ndarray | None = None):
        self.n_fft, self.hop = n_fft, hop_size
        win = _padded_window(window, win_size, n_fft)
        self.env_frame = (win * win).astype(np.float64)
        self.num_tail: np.ndarray | None = None   # (B, n_fft - hop)
        self.env_tail: np.ndarray | None = None

    @staticmethod
    def _ola(frames: np.ndarray, hop: int) -> np.ndarray:
        B, T, n_fft = frames.shape
        out = np.zeros((B, n_fft + hop * (T - 1)), frames.dtype)
        for t in range(T):
            out[:, t * hop : t * hop + n_fft] += frames[:, t]
        return out

    def push(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames, np.float64)
        _, c, n_fft = frames.shape
        hop, ov = self.hop, self.n_fft - self.hop
        y = self._ola(frames, hop)                       # (B, hop * (c - 1) + n_fft)
        env = self._ola(np.broadcast_to(self.env_frame, (1, c, n_fft)).copy(), hop)
        env = np.broadcast_to(env, y.shape).copy()
        if self.num_tail is not None:
            y[:, :ov] += self.num_tail
            env[:, :ov] += self.env_tail
        done_y, self.num_tail = y[:, : c * hop], y[:, c * hop :].copy()
        done_e, self.env_tail = env[:, : c * hop], env[:, c * hop :].copy()
        return (done_y / np.where(done_e > 1e-11, done_e, 1.0)).astype(np.float32)

    def flush(self) -> np.ndarray:
        if self.num_tail is None:
            return np.zeros((1, 0), np.float32)
        out = self.num_tail / np.where(self.env_tail > 1e-11, self.env_tail, 1.0)
        self.num_tail = self.env_tail = None
        return out.astype(np.float32)


def istft_ri(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_size: int,
             win_size: int, window: np.ndarray | None = None,
             center: bool = True, length: int | None = None) -> torch.Tensor:
    """torch.istft equivalent on (real, imag) pairs, each (..., F, T).

    Inverse real FFT per frame, (n_fft-padded) window, overlap-add,
    division by the overlap-added squared window where it exceeds 1e-11
    (elsewhere by 1), then the n_fft//2 center crop. Runs in float32.
    Default output length = hop_size * (T - 1).
    """
    lead, T = re.shape[:-2], re.shape[-1]
    win = _padded_window(window, win_size, n_fft)
    if torch.compiler.is_exporting() and not isinstance(T, int):
        # an exported symbolic time axis: the same envelope in the graph, summed
        # by the overlap-add (a static one is the host's, a constant)
        w2 = _window_on(win.tobytes(), re.device).square()
        env = _overlap_add(w2.expand(1, T, n_fft), hop_size)
        env = torch.where(env > 1e-11, env, torch.ones_like(env))
    else:
        env = _istft_envelope(win.tobytes(), n_fft, hop_size, T, re.device)
    frames = istft_frames(re, im, n_fft, win_size, window)
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


# ---------------------------------------------------------------------------
# the joint denoise+vocoder model's input (BSRNN_24k)
# ---------------------------------------------------------------------------

# the joint domain's log floor: the reference's joint dataset duplicates
# the T-F features with 1e-5 where the T-F dataset uses 1e-7
# (nvse_tpu/train/trainer.py:246)
JOINT_EPS = 1e-5
JOINT_TASKS = ("denoise", "vocoder")


def joint_input(wave: torch.Tensor, task: str, h) -> torch.Tensor:
    """The joint model's input spectrum (B, n_fft // 2 + 1, T) of a wave
    (B, L), float32: for "denoise" the log amplitude of the (noisy) wave,
    log(|STFT| + 1e-5); for "vocoder" the log pseudo-inverse mel of the
    wave's mel, log(clamp(|pinv(mel_basis) exp(mel)|, 1e-5)). The trainer
    and the joint inference entry both take it from here
    (nvse_tpu/train/trainer.py:252-262, infers/inference_joint_denoise_vocoder_bsrnn.py:48-57)."""
    if task == "denoise":
        return amp_pha_spectrum(wave, h.n_fft, h.hop_size, h.win_size, eps=JOINT_EPS)[0]
    if task == "vocoder":
        melargs = (h.n_fft, h.num_mels, h.sampling_rate, h.hop_size, h.win_size, h.fmin, h.fmax)
        inv = inverse_mel(mel_spectrogram(wave, *melargs), *melargs)
        return torch.log(torch.clamp(torch.abs(inv), min=JOINT_EPS))
    raise ValueError(f"joint task {task!r}: expected one of {JOINT_TASKS}")
