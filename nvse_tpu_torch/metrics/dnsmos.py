"""DNSMOS scoring: P.835 (SIG/BAK/OVRL) + P.808 MOS over wav files.

Re-implements the reference Metrics/DNSMOS/dnsmos_local.py:22-145 on
host CPU — onnxruntime when installed, else the built-in numpy ONNX
executor (metrics/onnx_np.py), so scoring needs no extra dependency:

  * primary model ``sig_bak_ovr.onnx`` — raw 9.01 s waveform in,
    (sig, bak, ovr) raw out, published polynomial calibration applied
    (dnsmos_local.py:33-47); personalized variant supported (pDNSMOS).
  * P.808 model ``model_v8.onnx`` — log-mel feature input
    (librosa melspectrogram semantics: n_fft=321, hop=160, 120 slaney
    mels, power_to_db ref=max, (db+40)/40; dnsmos_local.py:27-31).
  * per-clip dict with raw + calibrated + P808 columns, 9.01 s hops at
    1 s stride, audio tiled when shorter (dnsmos_local.py:57-103).

The ONNX sessions are injected so tests can run the feature path
without onnxruntime.
"""
from __future__ import annotations

import concurrent.futures
import csv
import glob
import os
import sys

import numpy as np

from ..data.audio_io import load_wav
from ..ops.spectral import _mel_filterbank_np

SAMPLING_RATE = 16000
INPUT_LENGTH = 9.01


def audio_melspec(audio: np.ndarray, sr: int = SAMPLING_RATE, n_mels: int = 120,
                  frame_size: int = 320, hop: int = 160) -> np.ndarray:
    """librosa.feature.melspectrogram + power_to_db(ref=max), (db+40)/40,
    transposed to (T, n_mels) — the P.808 input feature
    (dnsmos_local.py:27-31)."""
    n_fft = frame_size + 1
    pad = n_fft // 2
    x = np.pad(np.asarray(audio, np.float64), (pad, pad))
    frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
    # periodic hann, librosa default window for stft
    n = np.arange(n_fft)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)
    spec = np.abs(np.fft.rfft(x[idx] * win, n=n_fft, axis=1)) ** 2
    fb = _mel_filterbank_np(sr, n_fft, n_mels, 0.0, sr / 2.0)
    mel = spec @ fb.T.astype(np.float64)
    db = 10.0 * np.log10(np.maximum(mel, 1e-10))
    db -= 10.0 * np.log10(max(mel.max(), 1e-10))
    db = np.maximum(db, db.max() - 80.0)
    return ((db + 40.0) / 40.0).astype(np.float32)


def polyfit_val(sig: float, bak: float, ovr: float,
                is_personalized: bool = False) -> tuple[float, float, float]:
    """Published DNSMOS calibration polynomials (dnsmos_local.py:33-47)."""
    if is_personalized:
        p_ovr = np.poly1d([-0.00533021, 0.005101, 1.18058466, -0.11236046])
        p_sig = np.poly1d([-0.01019296, 0.02751166, 1.19576786, -0.24348726])
        p_bak = np.poly1d([-0.04976499, 0.44276479, -0.1644611, 0.96883132])
    else:
        p_ovr = np.poly1d([-0.06766283, 1.11546468, 0.04602535])
        p_sig = np.poly1d([-0.08397278, 1.22083953, 0.0052439])
        p_bak = np.poly1d([-0.13166888, 1.60915514, -0.39604546])
    return float(p_sig(sig)), float(p_bak(bak)), float(p_ovr(ovr))


class ComputeScore:
    """Callable per-clip scorer (dnsmos_local.py:22-103 semantics)."""

    def __init__(self, primary_sess, p808_sess=None):
        self.primary_sess = primary_sess
        self.p808_sess = p808_sess

    def __call__(self, fpath: str, fs: int = SAMPLING_RATE,
                 is_personalized: bool = False) -> dict:
        audio = load_wav(fpath, fs)
        actual_len = len(audio)
        need = int(INPUT_LENGTH * fs)
        while len(audio) < need:
            audio = np.concatenate([audio, audio])
        num_hops = int(np.floor(len(audio) / fs) - INPUT_LENGTH) + 1

        raw_sig, raw_bak, raw_ovr = [], [], []
        cal_sig, cal_bak, cal_ovr = [], [], []
        p808 = []
        for i in range(max(num_hops, 1)):
            seg = audio[int(i * fs): int((i + INPUT_LENGTH) * fs)]
            if len(seg) < need:
                continue
            if self.p808_sess is not None:
                feat = audio_melspec(seg[:-160])[None, :, :]
                p808.append(float(self.p808_sess.run(None, {"input_1": feat})[0][0][0]))
            if self.primary_sess is not None:
                out = self.primary_sess.run(
                    None, {"input_1": seg[None, :].astype(np.float32)})[0][0]
                s, b, o = float(out[0]), float(out[1]), float(out[2])
                raw_sig.append(s); raw_bak.append(b); raw_ovr.append(o)
                sc, bc, oc = polyfit_val(s, b, o, is_personalized)
                cal_sig.append(sc); cal_bak.append(bc); cal_ovr.append(oc)

        row = {"filename": fpath, "len_in_sec": actual_len / fs, "sr": fs,
               "num_hops": num_hops}
        if raw_sig:
            row.update(SIG_raw=np.mean(raw_sig), BAK_raw=np.mean(raw_bak),
                       OVRL_raw=np.mean(raw_ovr), SIG=np.mean(cal_sig),
                       BAK=np.mean(cal_bak), OVRL=np.mean(cal_ovr))
        if p808:
            row["P808_MOS"] = np.mean(p808)
        return row


def _make_session(path: str):
    """onnxruntime when available (fastest), else the built-in numpy
    ONNX executor (metrics/onnx_np.py) — the DNSMOS graphs are small
    feed-forward CNNs, so the numpy path scores a 9 s clip in ~1 s/core."""
    try:
        import onnxruntime as ort
        return ort.InferenceSession(path)
    except ImportError:
        pass
    except Exception as e:  # importable but broken (bad wheel / opset / EP)
        print(f"onnxruntime failed to open {path} ({e!r}); "
              "falling back to the numpy executor", file=sys.stderr)
    from .onnx_np import NumpyOnnxSession
    return NumpyOnnxSession(path)


def _resolve_model_paths(model_dir: str, is_personalized: bool):
    sub = "pDNSMOS" if is_personalized else "DNSMOS"
    primary_path = os.path.join(model_dir, sub, "sig_bak_ovr.onnx")
    if not os.path.exists(primary_path):
        if is_personalized:
            # falling back to the standard model while applying the
            # personalized calibration polynomials would silently
            # produce wrong pDNSMOS numbers
            raise FileNotFoundError(
                f"personalized DNSMOS requested but {primary_path} is "
                "missing; provide the pDNSMOS model or drop -p")
        primary_path = os.path.join(model_dir, "sig_bak_ovr.onnx")
    p808_path = os.path.join(model_dir, "DNSMOS", "model_v8.onnx")
    if not os.path.exists(p808_path):
        p808_path = os.path.join(model_dir, "model_v8.onnx")
    return primary_path, p808_path


def _build_scorer(primary_path: str, p808_path: str) -> "ComputeScore":
    primary = _make_session(primary_path) if os.path.exists(primary_path) else None
    p808 = _make_session(p808_path) if os.path.exists(p808_path) else None
    if primary is None and p808 is None:
        raise FileNotFoundError(
            "no DNSMOS onnx models found "
            "(need sig_bak_ovr.onnx and/or model_v8.onnx)")
    return ComputeScore(primary, p808)


# per-process scorer for the --jb fan-out: sessions are not picklable,
# so each worker process parses the onnx files once in its initializer
_PROC_SCORER: "ComputeScore | None" = None


def _proc_init(primary_path: str, p808_path: str) -> None:
    global _PROC_SCORER
    _PROC_SCORER = _build_scorer(primary_path, p808_path)


def _proc_score(args) -> dict:
    clip, is_personalized = args
    return _PROC_SCORER(clip, SAMPLING_RATE, is_personalized)


def score_dir(deg_dir: str, model_dir: str, csv_path: str | None = None,
              is_personalized: bool = False, workers: int = 8,
              jobs: int = 1) -> list[dict]:
    """Score every wav under deg_dir; write per-file CSV if requested.

    jobs>1 fans clips out over that many PROCESSES (the numpy ONNX
    executor is single-threaded Python + BLAS, so threads alone only
    overlap the BLAS fraction; the reference uses a thread pool over
    onnxruntime sessions which release the GIL,
    Metrics/DNSMOS/dnsmos_local.py:129-131). jobs=1 keeps the in-process
    thread pool (`workers`), which is the fast path under onnxruntime.
    """
    primary_path, p808_path = _resolve_model_paths(model_dir, is_personalized)
    if not (os.path.exists(primary_path) or os.path.exists(p808_path)):
        # fail in the parent with a clear message, not as a
        # BrokenProcessPool from every worker's initializer
        raise FileNotFoundError(
            f"no DNSMOS onnx models under {model_dir} "
            "(need sig_bak_ovr.onnx and/or model_v8.onnx; set "
            "--model_dir or NVSE_DNSMOS_DIR)")
    # worker processes may spawn with a different cwd
    primary_path, p808_path = os.path.abspath(primary_path), os.path.abspath(p808_path)
    clips = sorted(glob.glob(os.path.join(deg_dir, "*.wav")))
    rows = []
    if jobs > 1 and len(clips) > 1:
        import multiprocessing as mp
        ctx = mp.get_context("spawn")  # a forked child cannot use an initialised card
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=min(jobs, len(clips)), mp_context=ctx,
                initializer=_proc_init,
                initargs=(primary_path, p808_path)) as ex:
            rows = list(ex.map(_proc_score,
                               [(c, is_personalized) for c in clips]))
    else:
        scorer = _build_scorer(primary_path, p808_path)
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
            futs = {ex.submit(scorer, c, SAMPLING_RATE, is_personalized): c
                    for c in clips}
            for fut in concurrent.futures.as_completed(futs):
                rows.append(fut.result())
    rows.sort(key=lambda r: r["filename"])

    if csv_path and rows:
        cols = ["filename", "len_in_sec", "sr", "num_hops",
                "OVRL_raw", "SIG_raw", "BAK_raw", "OVRL", "SIG", "BAK", "P808_MOS"]
        cols = [c for c in cols if any(c in r for r in rows)]
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=cols, extrasaction="ignore")
            w.writeheader()
            w.writerows(rows)
    return rows
