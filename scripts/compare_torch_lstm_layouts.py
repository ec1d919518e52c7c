#!/usr/bin/env python3
"""The wide inference kernels (csrc/lstm_fused_wide.cu, csrc/lstm_grid.cuh)
at H = 128 against the narrow kernels that serve H <= 128 (csrc/lstm_fused.cu,
csrc/lstm_scan.cu),
at every shape BSRNN-M's paths give them, in float32 and bfloat16.

    python3 scripts/compare_torch_lstm_layouts.py [--out chiprun_out/lstm_layouts.jsonl]

Both layouts run through the public wrappers of nvse_tpu_torch.ops.lstm: the
grid kernels by moving the wrappers' H split (`_MAX_H`) below 128 for the
call. Each kernel is held against its plain version at chip_smoke.py's
tolerances; a time is the mean of CUDA-event means over 10 calls, taken
narrow, grid, grid, narrow. Prints one JSON line per kernel, shape and dtype,
then a summary: a family's narrow kernel could go if the grid kernel is
within 5 % of it, or faster, at every shape in both dtypes. Needs a CUDA GPU.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke                  # noqa: E402  (input makers, timer, tolerances)
from nvse_tpu_torch.ops import lstm as L    # noqa: E402
from nvse_tpu_torch.ops._measure import launch_delta  # noqa: E402

H = 128
# (label, rows, steps) of lstm_scan_fused on BSRNN-M's paths: the B=8 x 1024 decode,
# serving the synthetic set (8 files at the 128-frame bucket), a streaming chunk of
# 8 streams and of one, a context-recompute window, the validation crop
FUSED = (("time", 272, 1024), ("band", 8192, 34), ("serve_time", 272, 128),
         ("serve_band", 1024, 34), ("band_chunk", 640, 34), ("band_chunk1", 80, 34),
         ("band_window", 96, 34), ("validation_time", 34, 65), ("validation_band", 65, 34))
SLACK = 1.05


@contextlib.contextmanager
def _layout(grid):
    """Routes H = 128 to the grid kernels while inside, when grid is true."""
    saved = L._MAX_H
    L._MAX_H = 0 if grid else saved
    try:
        yield
    finally:
        L._MAX_H = saved


def _fused_case(R, T, dtype):
    args = smoke._lstm_inputs(R, T, H, H, dtype, seed=R + T)
    return (lambda: L.lstm_scan_fused(*args), lambda: (L.lstm_scan_fused_plain(*args),),
            L.lstm_scan_fused)


def _scan_case(name, R, T, dtype):
    g = torch.Generator().manual_seed(R + T)
    b = 1.0 / H ** 0.5
    xp = (0.5 * torch.randn(T, R, 4 * H, generator=g)).to("cuda", dtype)
    whh = torch.empty(H, 4 * H).uniform_(-b, b, generator=g).to("cuda", dtype)
    if name == "lstm_scan":
        return lambda: L.lstm_scan(xp, whh), lambda: (L.lstm_scan_plain(xp, whh),), L.lstm_scan
    h0, c0 = ((0.3 * torch.randn(R, H, generator=g)).to("cuda", dtype) for _ in range(2))
    return (lambda: L.lstm_scan_stateful(xp, whh, h0, c0),
            lambda: L.lstm_scan_stateful_plain(xp, whh, h0, c0), L.lstm_scan_stateful)


def _measure(name, label, R, T, dtype, case):
    run, plain, wrapper = case
    outs = {}
    with torch.inference_mode():
        ref = plain()
        for grid in (False, True):
            n0 = dict(wrapper.launches_by_kernel)
            with _layout(grid):
                got = run()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            kernel = launch_delta(wrapper.launches_by_kernel, n0)
            err = max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref))
            outs[grid] = dict(kernel=kernel, err=err)

        def timed(grid):
            with _layout(grid):
                return smoke.cuda_ms(run, iters=10)

        reads = [timed(g) for g in (False, True, True, False)]
    sources = L._SOURCES[wrapper.__name__]
    if outs[False]["kernel"] != {sources[0]: 1} or outs[True]["kernel"] != {sources[1]: 1}:
        raise SystemExit(f"{name} {label}: launched {outs}, expected {sources}")
    narrow_ms, grid_ms = (reads[0] + reads[3]) / 2, (reads[1] + reads[2]) / 2
    row = dict(name=name, shape=label, rows=R, steps=T, H=H, dtype=smoke.DT_NAME[dtype],
               narrow_kernel=outs[False]["kernel"], grid_kernel=outs[True]["kernel"],
               narrow_ms=narrow_ms, grid_ms=grid_ms, grid_over_narrow=grid_ms / narrow_ms,
               reads_ms=reads, narrow_err=outs[False]["err"], grid_err=outs[True]["err"],
               tol=smoke.TOL[dtype])
    if max(row["narrow_err"], row["grid_err"]) > row["tol"]:
        raise SystemExit(f"{name} {label} {row['dtype']}: a kernel disagrees with its plain "
                         f"version: {row}")
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "lstm_layouts.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_torch_lstm_layouts: no CUDA GPU visible")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    from nvse_tpu_torch.ops import _build

    _build.build_all(["lstm_fused", "lstm_fused_wide", "lstm_scan", "lstm_scan_wide"])
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, R, T in FUSED:
            rows.append(_measure("lstm_scan_fused", label, R, T, dtype, _fused_case(R, T, dtype)))
            print(json.dumps(rows[-1]), flush=True)
        for name, label, R, T in smoke.SCAN_SHAPES:
            rows.append(_measure(name, label, R, T, dtype, _scan_case(name, R, T, dtype)))
            print(json.dumps(rows[-1]), flush=True)
    families = {"fused": ("lstm_scan_fused",), "scans": ("lstm_scan", "lstm_scan_stateful")}
    summary = {}
    for fam, names in families.items():
        mine = [r for r in rows if r["name"] in names]
        worst = max(mine, key=lambda r: r["grid_over_narrow"])
        summary[fam] = dict(grid_holds=worst["grid_over_narrow"] <= SLACK,
                            worst=(worst["shape"], worst["dtype"], worst["grid_over_narrow"]),
                            grid_faster_at=[(r["shape"], r["dtype"]) for r in mine
                                            if r["grid_over_narrow"] < 1.0])
    print(json.dumps({"summary": summary, "slack": SLACK}), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write(json.dumps({"summary": summary, "slack": SLACK}) + "\n")


if __name__ == "__main__":
    main()
