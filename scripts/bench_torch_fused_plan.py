#!/usr/bin/env python3
"""The wide fused BiLSTM (csrc/lstm_fused_wide.cu) at each launch plan it could
take, at BSRNN-L's shapes (C = H = 256), against the plan ops/lstm.py picks.

    python3 scripts/bench_torch_fused_plan.py [--iters 5] [--out FILE]

For every shape the BSRNN-L paths give the kernel (the decode's band and time
BiLSTMs, a streaming chunk of 8 streams and of one, a context-recompute window,
`eval_step`'s crop) and each dtype, it launches every instance of the kernel
(units a block, rows a tile) at each k-chunk whose ring of at least 2 stages
fits, with as many stages as fit and the plan's row groups for that instance,
holds the output to the plan's launch (they differ only in the order of the
sums), and times it with CUDA events. One JSON line a variant, with `picked`
true on the plan's own; then one line a shape and dtype naming the fastest.
Needs a CUDA GPU.
"""
import argparse
import json
import math
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (label, rows, steps) of lstm_scan_fused on BSRNN-L's paths, C = H = 256
SHAPES = (("band", 8192, 34), ("time", 272, 1024), ("band_chunk", 640, 34),
          ("band_chunk1", 80, 34), ("band_window", 96, 34), ("eval_time", 34, 65),
          ("eval_band", 65, 34))
C = H = 256


def _inputs(R, T, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    b = 1.0 / math.sqrt(H)
    x = torch.randn(R, T, C, generator=g)
    w = [torch.empty(s).uniform_(-b, b, generator=g)
         for s in [(C, 4 * H), (C, 4 * H), (4 * H,), (4 * H,), (H, 4 * H), (H, 4 * H)]]
    return [t.to("cuda", dtype) for t in [x, *w]]


def _variants(R, dtype, n_sm, limit):
    """(units, tile rows, kc, stages, groups) of every plan the kernel can take."""
    from nvse_tpu_torch.ops import lstm as L

    room = limit - L._FUSED_STATIC_SMEM
    for U, rows in L._FUSED_TILE[dtype]["tiles"]:
        if H % U:
            continue
        groups = min(n_sm // (2 * H // U), math.ceil(R / L._MIN_GROUP_ROWS), R)
        for kc in L._FUSED_KC:
            stages = max((s for s in range(2, L._FUSED_MAX_STAGES + 1)
                          if L._fused_smem(U, rows, C, H, dtype, kc, s) <= room), default=0)
            if stages >= 2 and groups >= 1:
                yield U, rows, kc, stages, groups


def _launch(args, U, rows, kc, stages, groups):
    from nvse_tpu_torch.ops import lstm as L

    x = args[0]
    R, T, _ = x.shape
    out = torch.empty(R, T, 2 * H, device="cuda", dtype=x.dtype)
    c_state = torch.empty(2, R, H, device="cuda", dtype=torch.float32)
    smem = L._fused_smem(U, rows, C, H, x.dtype, kc, stages)
    ptrs = [a.data_ptr() for a in args] + [out.data_ptr(), c_state.data_ptr()]

    def run():
        err = L._fused_wide_lib().lstm_fused_wide_launch(
            L._DTYPE_CODE[x.dtype], *ptrs, R, T, C, H, U, rows, groups, kc, stages, smem,
            torch.cuda.current_stream().cuda_stream)
        L._raise_on(err, "lstm_fused_wide")
        return out
    return run


def _ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--out", default=None, help="also write the lines to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_torch_fused_plan: needs a CUDA GPU")
    from nvse_tpu_torch import resolve_device
    from nvse_tpu_torch.ops import lstm as L

    resolve_device("cuda")
    dev = torch.device("cuda", 0)
    n_sm, limit = L._n_sm(dev), L._smem_limit(dev)
    device = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60).stdout.strip()
    lines = []

    def emit(d):
        line = json.dumps({**d, "device": device})
        print(line, flush=True)
        lines.append(line)

    for label, R, T in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            inputs = _inputs(R, T, dtype, seed=R + T)
            with torch.inference_mode():
                ref = L.lstm_scan_fused(*inputs).float()
            plan = L._fused_wide_card_plan(0, R, C, H, dtype, 0)
            best = None
            for U, rows, kc, stages, groups in _variants(R, dtype, n_sm, limit):
                run = _launch(inputs, U, rows, kc, stages, groups)
                diff = (run().float() - ref).abs().max().item()
                ms = _ms(run, args.iters)
                picked = (U, rows, kc, stages, groups) == tuple(
                    plan[k] for k in ("units", "tile_rows", "kc", "stages", "groups"))
                emit(dict(shape=label, rows=R, steps=T, dtype=str(dtype)[6:], units=U,
                          tile_rows=rows, kc=kc, stages=stages, groups=groups, ms=ms,
                          max_abs_diff_vs_plan=diff, picked=picked))
                if best is None or ms < best[0]:
                    best = (ms, U, rows, kc, stages, groups, picked)
            emit(dict(shape=label, dtype=str(dtype)[6:], fastest=dict(
                zip(("ms", "units", "tile_rows", "kc", "stages", "groups", "picked"), best))))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
