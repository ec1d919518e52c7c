"""The metric CLI: one name for each of the reference's metric scripts.

    python -m nvse_tpu_torch.metrics <name> --ref_dir <clean> --deg_dir <decoded> [--sr N] [--jb N]
    python -m nvse_tpu_torch.metrics evaluate --ref_dir ... --deg_dir ... [--device cpu]
    python -m nvse_tpu_torch.metrics utmos --deg_dir ... [--ckpt <epoch=3-step=7459.ckpt>] [--device cpu]
    python -m nvse_tpu_torch.metrics dnsmos --deg_dir ... [--model_dir <dir>] [-o out.csv] [-p]

Names (Metrics/<script> of the reference layout): lsd, snr (--si: SI-SNR),
stoi (--extended: ESTOI), mcd, mcd_dtw, pesq (pesq_.py), visqol
(visqol_.py), f0_rmse, evaluate_f0, evaluate (periodicity, pitch, V/UV F1),
utmos, dnsmos. Each prints the lines of nvse_tpu/metrics/common.py's
run_metric_cli / run_multi_metric_cli (or of Metrics/utmos.py and
Metrics/dnsmos.py). The pair metrics are host numpy scored in spawned
worker processes (--jb), a bad pair skipped; `evaluate` runs CREPE on the
card (--device cpu for the plain path) when $NVSE_CREPE_CKPT names a
torchcrepe checkpoint, in this process, and any error of the card ends the
run; without one, YIN stands in (the first line says which scored). UTMOS
scores on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np

from . import common
from .dsp import estoi, evaluate_f0_metrics, lsd, periodicity_metrics, si_snr, snr, stoi
from .mcep import mcd_sptk, mcd_sptk_dtw
from .visqol import visqol

_REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")


def _f0_rmse(ref, deg, sr):
    return evaluate_f0_metrics(ref, deg, sr)["f0_rmse_hz"]


def pesq_wb(ref, deg, sr):
    """The `pesq` C extension when installed (bit-exact ITU scoring), else
    the numpy P.862 re-implementation (metrics/pesq.py)."""
    try:
        from pesq import pesq
    except ImportError:
        from .pesq import pesq_wb as _numpy_pesq
        return _numpy_pesq(ref, deg, sr)
    return pesq(sr, ref, deg, "wb")


# name -> (printed name, score function, default sr), for one score a pair
PAIR_METRICS = {
    "lsd": ("LSD", lsd, 22050),
    "mcd": ("MCD", mcd_sptk, 22050),
    "mcd_dtw": ("MCD-DTW", mcd_sptk_dtw, 22050),
    "pesq": ("PESQ-WB", pesq_wb, 16000),
    "visqol": ("ViSQOL (MOS-LQO)", visqol, 16000),
    "f0_rmse": ("F0-RMSE", _f0_rmse, 22050),
}
# name -> flag, (printed name, score function) without and with the flag, default sr
FLAG_METRICS = {
    "snr": ("--si", ("SNR", snr), ("SI-SNR", si_snr), 22050),
    "stoi": ("--extended", ("STOI", stoi), ("ESTOI", estoi), 10000),
}
# name -> (result key -> printed label, score function, default sr, description)
MULTI_METRICS = {
    "evaluate_f0": ({"log_f0_rmse": "log_F0-RMSE", "semitone_acc": "Semitone_ACC %",
                     "vuv_error": "VUV_ERROR %"}, evaluate_f0_metrics, 22050,
                    "evaluate_f0 (log-F0 RMSE / semitone ACC / VUV error)"),
    "evaluate": ({"periodicity_rmse": "Periodicity", "pitch_rmse_cents": "Pitch-RMSE (cents)",
                  "vuv_f1": "V/UV F1"}, periodicity_metrics, 22050,
                 "evaluate (periodicity / pitch / V-UV F1)"),
}
NAMES = (*PAIR_METRICS, *FLAG_METRICS, *MULTI_METRICS, "utmos", "dnsmos")


def _pairs(args):
    pairs = common.build_pair_map(args.ref_dir, args.deg_dir)
    if not pairs:
        raise SystemExit("no ref/deg pairs found")
    return pairs


def _pair_metric(name: str, argv) -> None:
    if name in FLAG_METRICS:
        flag, off, on, sr = FLAG_METRICS[name]
        (label, fn), argv = (on, [a for a in argv if a != flag]) if flag in argv else (off, argv)
    else:
        label, fn, sr = PAIR_METRICS[name]
    args = common.pair_args(label, sr, argv)
    common.print_scores(label, common.score_pairs(fn, _pairs(args), args.sr, args.jb))


def _multi_metric(name: str, argv) -> None:
    outputs, fn, sr, description = MULTI_METRICS[name]
    args = common.pair_args(description, sr, argv, device=name == "evaluate")
    on_device = False
    if name == "evaluate":
        from .crepe import crepe_ckpt_from_env, crepe_model_from_env

        ckpt = crepe_ckpt_from_env()
        on_device = ckpt is not None
        print(f"pitch: CREPE {crepe_model_from_env()} ({ckpt}) on {args.device}" if on_device
              else "pitch: YIN stand-in (set NVSE_CREPE_CKPT to a torchcrepe checkpoint for "
                   "CREPE)")
        if on_device:
            fn = functools.partial(periodicity_metrics, device=args.device)
    rows = common.score_pairs(fn, _pairs(args), args.sr, args.jb, on_device=on_device)
    common.print_rows(outputs, rows, description)


def _utmos(argv) -> None:
    p = argparse.ArgumentParser(prog="python -m nvse_tpu_torch.metrics utmos",
                                description="Compute UTMOS measure.")
    p.add_argument("--deg_dir", required=True, help="Degraded wav folder.")
    p.add_argument("--sr", type=int, default=16000, help="Target sampling rate, 16k by default")
    p.add_argument("--ckpt", default=os.path.join(_REPO, "Metrics", "epoch=3-step=7459.ckpt"),
                   help="UTMOS strong-learner lightning checkpoint")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if not os.path.exists(args.ckpt):
        raise SystemExit(f"UTMOS checkpoint not found at {args.ckpt}: the sarulab-speech "
                         "UTMOS 'epoch=3-step=7459.ckpt' is not in the repository; pass --ckpt")
    from .utmos import score_dir

    mean_, std_ = score_dir(args.deg_dir, args.ckpt, sr=args.sr, device=args.device)
    print("UTMOS score: mean->{:.4f}, std->{:.4f}".format(mean_, std_))


def _dnsmos(argv) -> None:
    p = argparse.ArgumentParser(prog="python -m nvse_tpu_torch.metrics dnsmos")
    p.add_argument("--deg_dir", "-t", required=True, help="dir of wav clips to be evaluated")
    p.add_argument("--model_dir", default=os.environ.get(
        "NVSE_DNSMOS_DIR", os.path.join(_REPO, "Metrics", "DNSMOS")),
        help="dir with DNSMOS/sig_bak_ovr.onnx and DNSMOS/model_v8.onnx (pDNSMOS/ for -p); "
             "default $NVSE_DNSMOS_DIR, else Metrics/DNSMOS")
    p.add_argument("--csv_path", "-o", default=None, help="write per-file results to this CSV")
    p.add_argument("--personalized_MOS", "-p", action="store_true",
                   help="use the personalized (pDNSMOS) calibration/model")
    p.add_argument("--jb", type=int, default=1, help="score clips in this many processes")
    args = p.parse_args(argv)
    from .dnsmos import score_dir

    rows = score_dir(args.deg_dir, args.model_dir, csv_path=args.csv_path,
                     is_personalized=args.personalized_MOS, jobs=args.jb)
    if not rows:
        raise SystemExit(f"no wav files under {args.deg_dir}")
    parts = [f"DNSMOS: {len(rows)} files"]
    for key in ("SIG", "BAK", "OVRL", "P808_MOS"):
        vals = [r[key] for r in rows if key in r]
        if vals:
            parts.append(f"{key} {np.mean(vals):.3f}±{np.std(vals):.3f}")
    print(" | ".join(parts))
    if args.csv_path:
        print(f"per-file results -> {args.csv_path}")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in NAMES:
        raise SystemExit(f"usage: python -m nvse_tpu_torch.metrics {{{','.join(NAMES)}}} ...")
    name, rest = argv[0], argv[1:]
    if name == "utmos":
        _utmos(rest)
    elif name == "dnsmos":
        _dnsmos(rest)
    elif name in MULTI_METRICS:
        _multi_metric(name, rest)
    else:
        _pair_metric(name, rest)
