"""ctypes bindings for the native host IO library (native/nvse_host.cpp).

The port's own copy of nvse_tpu/data/native.py. Loads native/libnvse_host.so,
building it with native/Makefile first if it is missing (under a file lock,
so that concurrent processes build it once), and exposes:
  * read_wav_native(path)       - mono float32 WAV decode
  * batch_segments_native(...)  - whole-batch decode + random crop with a
                                  C++ thread pool, crop starts drawn from a
                                  hash of the batch seed (nvse_host.cpp:191)
Each returns None when the library cannot be built or loaded; callers then
keep the Python path, as the JAX loader does.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "libnvse_host.so")

_lib = None
_tried = False


def _build() -> None:
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(_LIB_PATH):
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True,
                           timeout=120)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            _build()
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.nvse_wav_info.restype = ctypes.c_long
        lib.nvse_wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.nvse_read_wav.restype = ctypes.c_long
        lib.nvse_read_wav.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.nvse_batch_segments.restype = ctypes.c_int
        lib.nvse_batch_segments.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint64, ctypes.c_int,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def read_wav_native(path: str):
    """-> (float32 mono samples, sample_rate) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    sr = ctypes.c_int(0)
    n = lib.nvse_wav_info(path.encode(), ctypes.byref(sr))
    if n < 0:
        return None
    out = np.empty(n, dtype=np.float32)
    got = lib.nvse_read_wav(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            n, ctypes.byref(sr))
    if got < 0:
        return None
    return out[:got], int(sr.value)


def batch_segments_native(paths: list[str], segment: int, seed: int, threads: int = 0):
    """-> (batch, segment) float32 array, or None if unavailable or a file
    failed. Only valid when every file is already at the target sample rate
    (the native path does not resample); callers must ensure this."""
    lib = _load()
    if lib is None:
        return None
    batch = len(paths)
    out = np.empty((batch, segment), dtype=np.float32)
    arr = (ctypes.c_char_p * batch)(*[p.encode() for p in paths])
    failures = lib.nvse_batch_segments(
        arr, batch, segment, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_uint64(seed), threads)
    if failures:
        return None
    return out
