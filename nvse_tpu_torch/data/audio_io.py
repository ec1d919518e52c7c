"""Host-side audio IO: WAV read/write + resampling, no librosa/soundfile.

The port's own copy of nvse_tpu/data/audio_io.py (numpy/scipy only).

Replaces the reference's librosa.load / soundfile usage
(dataset.py:14-16, infers/inference_bsrnn.py:74-95) with
stdlib-wave/scipy decoding (PCM 16/24/32, float32) and polyphase
resampling (scipy.signal.resample_poly, the same method family librosa
uses via soxr).
"""
from __future__ import annotations

import io
import math
import os
import struct
import wave

import numpy as np
from scipy.io import wavfile as _wavfile


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono samples in [-1, 1], sample_rate)."""
    try:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            ch = w.getnchannels()
            sw = w.getsampwidth()
            raw = w.readframes(n)
        if sw == 2:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif sw == 4:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif sw == 3:
            a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            b = (
                a[:, 0].astype(np.int32)
                | (a[:, 1].astype(np.int32) << 8)
                | (a[:, 2].astype(np.int32) << 16)
            )
            b = np.where(b >= (1 << 23), b - (1 << 24), b)
            data = b.astype(np.float32) / 8388608.0
        elif sw == 1:
            data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported sample width {sw}")
        if ch > 1:
            # frombuffer yields interleaved samples — de-interleave so
            # the mono downmix below sees (frames, channels)
            data = data.reshape(-1, ch)
    except wave.Error:
        # float32 or other formats stdlib wave rejects
        sr, data = _wavfile.read(path)
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return np.ascontiguousarray(data, dtype=np.float32), int(sr)


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write float32 [-1,1] samples as PCM_16 (matches reference output,
    infers/inference_bsrnn.py:92-95)."""
    x = np.clip(np.asarray(data, dtype=np.float64), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def resample(data: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return data
    from scipy.signal import resample_poly   # ~2 s to import; only resampling needs it

    g = math.gcd(int(orig_sr), int(target_sr))
    return resample_poly(data, target_sr // g, orig_sr // g).astype(np.float32)


def load_wav(path: str, sample_rate: int) -> np.ndarray:
    """Read + resample to target rate, mono float32 (dataset.py:14-16)."""
    data, sr = read_wav(path)
    return resample(data, sr, sample_rate)
