"""Shared harness for offline metric CLIs.

Replicates the reference Metrics/* CLI contract (SURVEY.md §2.7,
Metrics/pesq_.py:58-100): pair every wav in --deg_dir with the matching
basename under --ref_dir (searched up to 4 directory levels deep), score
pairs, print mean/std in the lines of nvse_tpu/metrics/common.py's
run_metric_cli / run_multi_metric_cli. The port's copy of that module,
with two rules for the metrics that run a network on a device (CREPE):

  * host metrics score in a process pool of the `spawn` context (a child
    forked after CUDA is initialised cannot use the card), one chunk of
    pairs a worker (in this process at --jb 1); a pair whose files or
    metric raise is skipped, the reference's rule for bad files;
  * a device metric (`on_device`) scores in this process, one pair after
    the other: a pair whose files cannot be read is skipped, but an error
    of the metric itself (the card, a kernel) propagates and ends the run
    nonzero.
"""
from __future__ import annotations

import argparse
import glob
import multiprocessing as mp
import os
from typing import Callable

import numpy as np

from ..data.audio_io import load_wav


def build_pair_map(ref_dir: str, deg_dir: str) -> list[tuple[str, str]]:
    deg_files = sorted(glob.glob(os.path.join(deg_dir, "*.wav")))
    ref_map = {}
    for depth in range(1, 5):
        for p in glob.glob(os.path.join(ref_dir, *(["*"] * (depth - 1)), "*.wav")):
            ref_map.setdefault(os.path.basename(p), p)
    pairs = []
    for d in deg_files:
        r = ref_map.get(os.path.basename(d))
        if r is not None:
            pairs.append((r, d))
    return pairs


def _load_pair(r: str, d: str, sr: int):
    ref = load_wav(r, sr)
    deg = load_wav(d, sr)
    n = min(len(ref), len(deg))
    return ref[:n], deg[:n]


def _score_chunk(args):
    fn, pairs, sr = args
    out = []
    for r, d in pairs:
        try:
            out.append(fn(*_load_pair(r, d, sr), sr))
        except Exception as e:  # mirror reference behaviour: skip bad pairs
            print(f"skip {os.path.basename(d)}: {e}")
    return out


def _score_in_process(fn: Callable, pairs, sr: int) -> list:
    out = []
    for r, d in pairs:
        try:
            ref, deg = _load_pair(r, d, sr)
        except Exception as e:  # an unreadable file is a bad pair; the metric's errors propagate
            print(f"skip {os.path.basename(d)}: {e}")
            continue
        out.append(fn(ref, deg, sr))
    return out


def score_pairs(score_fn: Callable, pairs, sr: int, jobs: int, on_device: bool = False) -> list:
    """Score (ref, deg) path pairs: in this process when on_device or jobs is
    1, else in `jobs` spawned workers (fewer when there are fewer pairs)."""
    if on_device:
        return _score_in_process(score_fn, pairs, sr)
    if jobs <= 1:
        return _score_chunk((score_fn, pairs, sr))
    chunks = [c for c in np.array_split(np.asarray(pairs, dtype=object), max(1, jobs)) if len(c)]
    with mp.get_context("spawn").Pool(processes=len(chunks)) as pool:
        results = pool.map(_score_chunk, [(score_fn, [tuple(p) for p in c], sr)
                                          for c in chunks])
    return [r for chunk in results for r in chunk]


def pair_args(description: str, default_sr: int, argv=None, device: bool = False):
    """--ref_dir / --deg_dir / --sr / --jb (and --device for a device metric)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--ref_dir", required=True)
    p.add_argument("--deg_dir", required=True)
    p.add_argument("--sr", type=int, default=default_sr)
    p.add_argument("--jb", type=int, default=16, help="parallel jobs")
    if device:
        p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def print_scores(name: str, scores) -> None:
    scores = np.array(scores, dtype=np.float64)
    scores = scores[np.isfinite(scores)]
    print(f"{name}: {len(scores)} pairs | mean {scores.mean():.4f} | std {scores.std():.4f}")


def print_rows(outputs: dict, rows: list, description: str = "") -> None:
    """`outputs` maps result keys -> printed label; labels ending in '%'
    are scaled x100 (the reference prints semitone ACC / VUV error as
    percentages, evaluate_f0.py:389-396)."""
    print(f"{description or 'metrics'}: {len(rows)} pairs")
    for key, label in outputs.items():
        vals = np.array([r[key] for r in rows], dtype=np.float64)
        vals = vals[np.isfinite(vals)]
        if not len(vals):
            print(f"  {label}: n/a")
        elif label.endswith("%"):
            print(f"  {label[:-1].strip()}: {vals.mean() * 100:.2f}% "
                  f"± {vals.std() * 100:.2f}%")
        else:
            print(f"  {label}: {vals.mean():.4f} ± {vals.std():.4f}")

