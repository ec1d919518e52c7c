"""Speech-enhancement evaluation of the joint denoise+vocoder model
(counterpart of scripts/enhance_eval.py).

    python -m nvse_tpu_torch.metrics.enhance --cfg_filename <joint cfg> \\
        [--snr 5] [--label joint_3k] [--out QUALITY.json] [--limit N] [--device cpu]

A BSRNN_24k trained on the 50/50 denoise / vocoder mixture should improve
noisy speech (reference train_tf_wi_inv_joint_denoise_vocoder.py). Each
test file is mixed with held-out noise from h.input_noise_wav_list at
--snr (`mix_at_snr`), decoded through the denoise path (the input of
ops.spectral.joint_input, weights from h.checkpoint_file_load through
InferenceEngine, on the card unless --device cpu), written to
test_output_dir/enhanced/, and the noisy and the enhanced audio are each
scored against the clean reference on snr, si_snr, stoi, estoi, lsd, pesq
(WB) and visqol. Prints the JAX script's record (the mean of the finite
scores of each, rounded to 4 places, the count of non-finite ones, and
enhanced - noisy as delta_*); appends it to --out only when given.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

METRICS = ("snr", "si_snr", "stoi", "estoi", "lsd", "pesq", "visqol")


def mix_at_snr(clean: np.ndarray, noise: np.ndarray, snr_db: float):
    """(noisy, clean) of scripts/enhance_eval.py:60-73: the noise tiled to
    the clean length and power-scaled to snr_db against it; when the mix
    peaks above 1 both signals are divided by that peak (the SNR unchanged)."""
    if len(noise) < len(clean):
        noise = np.tile(noise, len(clean) // len(noise) + 1)
    noise = noise[: len(clean)]
    p_c = float(np.mean(clean**2)) + 1e-12
    p_n = float(np.mean(noise**2)) + 1e-12
    noise = noise * np.sqrt(p_c / (p_n * 10 ** (snr_db / 10.0)))
    noisy = clean + noise
    peak = float(np.max(np.abs(noisy)))
    if peak > 1.0:
        return noisy / peak, clean / peak
    return noisy, clean


def noise_files(h) -> list[str]:
    with open(h.input_noise_wav_list) as f:
        return [l.strip() for l in f if l.strip()]


def score_pair(clean: np.ndarray, deg: np.ndarray, sr: int) -> dict[str, float]:
    """Every metric of METRICS of deg against clean, cropped to the shorter."""
    from . import estoi, lsd, pesq_wb, si_snr, snr, stoi, visqol

    n = min(len(clean), len(deg))
    c, d = clean[:n], deg[:n]
    return {"snr": snr(c, d, sr), "si_snr": si_snr(c, d, sr), "stoi": stoi(c, d, sr),
            "estoi": estoi(c, d, sr), "lsd": lsd(c, d, sr), "pesq": pesq_wb(c, d, sr),
            "visqol": visqol(c, d, sr)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m nvse_tpu_torch.metrics.enhance")
    p.add_argument("--cfg_filename", required=True)
    p.add_argument("--snr", type=float, default=5.0)
    p.add_argument("--label", default="joint_denoise")
    p.add_argument("--out", default=None)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    import torch

    from .. import resolve_device
    from ..data.audio_io import load_wav, write_wav
    from ..infer.engine import InferenceEngine, resolve_filelist
    from ..ops.spectral import joint_input
    from ..utils import load_config

    resolve_device(args.device)          # no card: raise before any work
    h = load_config(args.cfg_filename)
    engine = InferenceEngine(h, device=args.device)
    files = resolve_filelist(h)
    if args.limit:
        files = files[: args.limit]
    noises = noise_files(h)
    sr = h.sampling_rate
    out_dir = os.path.join(h.test_output_dir, "enhanced")
    os.makedirs(out_dir, exist_ok=True)

    def sync():
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    rows = {"noisy": {m: [] for m in METRICS}, "enhanced": {m: [] for m in METRICS}}
    wall = audio_sec = 0.0
    for i, path in enumerate(files):
        noisy, clean = mix_at_snr(load_wav(path, sr), load_wav(noises[i % len(noises)], sr),
                                  args.snr)
        wave = torch.from_numpy(np.asarray(noisy, np.float32)[None, :]).to(engine.device)
        spec = joint_input(wave, "denoise", h)
        engine.warmup(spec.shape[-1])
        sync()
        t0 = time.time()
        enh = engine.synthesize_mel(spec, out_len=len(noisy))[0]
        sync()
        wall += time.time() - t0
        audio_sec += len(noisy) / sr
        write_wav(os.path.join(out_dir, os.path.basename(path)), enh, sr)
        for tag, deg in (("noisy", noisy), ("enhanced", enh)):
            for m, v in score_pair(clean, deg, sr).items():
                rows[tag][m].append(v)

    rec = {"label": args.label, "task": "denoise", "mix_snr_db": args.snr,
           "files": len(files), "rtf": audio_sec / max(wall, 1e-9),
           "timestamp": time.strftime("%Y-%m-%d %H:%M:%S")}
    for tag in ("noisy", "enhanced"):
        for m, vals in rows[tag].items():
            # si_snr is +-inf for a degenerate pair: the mean of the finite scores
            finite = [v for v in vals if np.isfinite(v)]
            rec[f"{tag}_{m}"] = round(float(np.mean(finite)), 4) if finite else None
            if len(finite) != len(vals):
                rec[f"{tag}_{m}_nonfinite"] = len(vals) - len(finite)
    for m in METRICS:
        e, n = rec.get(f"enhanced_{m}"), rec.get(f"noisy_{m}")
        rec[f"delta_{m}"] = round(e - n, 4) if e is not None and n is not None else None
    print(json.dumps(rec, indent=1))
    if args.out:
        recs = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                recs = json.load(f)
        recs.append(rec)
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)
        print(f"appended -> {args.out}")
    return rec


if __name__ == "__main__":
    main()
