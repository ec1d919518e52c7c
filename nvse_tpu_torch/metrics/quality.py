"""Decode a test set with a trained checkpoint and score it against the
reference wavs (counterpart of scripts/quality_eval.py).

    python -m nvse_tpu_torch.metrics.quality --cfg_filename <cfg.json> \\
        [--out quality.json] [--label bsrnn_3k] [--limit N] [--skip_decode] [--device cpu]

Decodes the config's test filelist to h.test_output_dir with the port's
run_inference (weights from h.checkpoint_file_load when that file exists,
on the card unless --device cpu), or with --skip_decode scores what is
already there, then reports PESQ-WB, LSD, STOI, ESTOI, MCD (DCT and SPTK,
each also DTW-aligned), SNR, ViSQOL and the F0 metrics (log-F0 RMSE,
semitone accuracy, V/UV error, F0 RMSE in Hz), mean and std over the files.
Prints one JSON record; appends it to --out only when --out is given.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def score_files(files, out_dir: str, sr: int) -> dict[str, list[float]]:
    """Every metric of each reference file against its namesake in out_dir
    (missing ones skipped): metric -> finite scores."""
    from ..data.audio_io import load_wav
    from . import (estoi, evaluate_f0_metrics, lsd, mcd, mcd_dtw, mcd_sptk, mcd_sptk_dtw,
                   pesq_wb, snr, stoi, visqol)

    per_metric: dict[str, list[float]] = {}
    for ref_path in files:
        deg_path = os.path.join(out_dir, os.path.basename(ref_path))
        if not os.path.exists(deg_path):
            continue
        ref = load_wav(ref_path, sr)
        deg = load_wav(deg_path, sr)
        n = min(len(ref), len(deg))
        ref, deg = ref[:n], deg[:n]
        scores = {
            "pesq": pesq_wb(ref, deg, sr),
            "lsd": lsd(ref, deg, sr),
            "stoi": stoi(ref, deg, sr),
            "estoi": estoi(ref, deg, sr),
            "mcd": mcd(ref, deg, sr),
            "mcd_dtw": mcd_dtw(ref, deg, sr),
            "mcd_sptk": mcd_sptk(ref, deg, sr),
            "mcd_sptk_dtw": mcd_sptk_dtw(ref, deg, sr),
            "snr": snr(ref, deg, sr),
            "visqol": visqol(ref, deg, sr),
        }
        scores.update(evaluate_f0_metrics(ref, deg, sr))
        for k, v in scores.items():
            if np.isfinite(v):
                per_metric.setdefault(k, []).append(float(v))
    return per_metric


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m nvse_tpu_torch.metrics.quality")
    p.add_argument("--cfg_filename", required=True)
    p.add_argument("--out", default=None, help="append the JSON record here")
    p.add_argument("--label", default="run")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--skip_decode", action="store_true",
                   help="score an existing test_output_dir only")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    from ..infer.engine import resolve_filelist, run_inference
    from ..utils import load_config

    h = load_config(args.cfg_filename)
    stats = {"rtf": None}
    if not args.skip_decode:
        stats = run_inference(h, limit=args.limit, device=args.device)
    files = resolve_filelist(h)
    if args.limit:
        files = files[: args.limit]
    per_metric = score_files(files, h.test_output_dir, h.sampling_rate)

    record = {"label": args.label, "model": h.model_name, "files": len(files),
              "rtf": stats.get("rtf"), "timestamp": time.strftime("%Y-%m-%d %H:%M:%S")}
    for k, vals in sorted(per_metric.items()):
        record[k] = round(float(np.mean(vals)), 4)
        record[k + "_std"] = round(float(np.std(vals)), 4)
    print(json.dumps(record, indent=2))
    if args.out:
        rows = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                rows = json.load(f)
        rows.append(record)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"appended -> {args.out}")
    return record


if __name__ == "__main__":
    main()
