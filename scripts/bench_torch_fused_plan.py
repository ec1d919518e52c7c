#!/usr/bin/env python3
"""The fused BiLSTM kernels at each launch plan they could take, against the
plan ops/lstm.py picks.

    python3 scripts/bench_torch_fused_plan.py [--hidden 256] [--iters 5] [--out FILE]

--hidden 256 (the default): the wide kernel (csrc/lstm_fused_wide.cu) at
BSRNN-L's shapes (C = H = 256). For every shape the BSRNN-L paths give it (the
decode's band and time BiLSTMs, a streaming chunk of 8 streams and of one, a
context-recompute window, `eval_step`'s crop) and each dtype, it launches every
instance of the kernel (units a block, rows a tile) at each k-chunk whose ring
of at least 2 stages fits, with as many stages as fit and the plan's row groups
for that instance.

--hidden 128: the narrow kernel (csrc/lstm_fused.cu) at BSRNN-M's shapes (C = H
= 128: the decode's band and time BiLSTMs, the offline decode beside the
streams, a streaming chunk of 8 streams and of one, a context-recompute window,
serving's 128-frame bucket, the validation crop). It launches every plan of
the kernel: each slice of units whose cluster fits, each tile instance, each
depth of the x ring that fits, tiles that fill the card's clusters or that are
as large as the instance, and clusters that walk their tiles (persistent) or a
cluster for every tile (waves); the clusters a card holds are read from it. As
yardsticks that no route takes: the wide kernel launched at H = 128 through its
launch entry (its plan, `fused_wide_plan`), and cuDNN's bidirectional
torch.nn.LSTM with the projection.

Each launch is held to the plan's own (they differ only in the order of the
sums) and timed with CUDA events. One JSON line a variant, with `picked` true
on the plan's own; then one line a shape and dtype naming the fastest. Needs a
CUDA GPU.
"""
import argparse
import ctypes
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
# (label, rows, steps) of lstm_scan_fused on BSRNN-M's paths, C = H = 128
NARROW_SHAPES = (("band", 8192, 34), ("time", 272, 1024), ("offline_band", 4096, 34),
                 ("band_chunk", 640, 34), ("band_chunk1", 80, 34), ("band_window", 96, 34),
                 ("serve_time", 272, 128), ("serve_band", 1024, 34), ("validation_time", 34, 129),
                 ("validation_band", 129, 34))


def _inputs(R, T, C, H, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    b = 1.0 / math.sqrt(H)
    x = torch.randn(R, T, C, generator=g)
    w = [torch.empty(s).uniform_(-b, b, generator=g)
         for s in [(C, 4 * H), (C, 4 * H), (4 * H,), (4 * H,), (H, 4 * H), (H, 4 * H)]]
    return [t.to("cuda", dtype) for t in [x, *w]]


def _variants(R, C, H, dtype, n_sm, limit):
    """(units, tile rows, kc, stages, groups) of every plan the wide kernel can take."""
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
    """The wide kernel at one plan."""
    from nvse_tpu_torch.ops import lstm as L

    x = args[0]
    R, T, C = x.shape
    H = args[-1].shape[0]
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


def _narrow_clusters(dtype, U, inst, H, smem):
    """Clusters of the narrow kernel's instance that the card holds at once."""
    from nvse_tpu_torch.ops import lstm as L

    n = ctypes.c_int(0)
    L._raise_on(L._kernel_lib().lstm_fused_max_clusters(L._DTYPE_CODE[dtype], 0, U, inst, H, smem,
                                                        ctypes.byref(n)), "lstm_fused (occupancy)")
    return n.value


def _narrow_variants(R, C, H, dtype, limit):
    """Every plan of the narrow kernel: (units, inst, stages, ntiles, clusters a
    direction), for each slice whose cluster fits, instance, ring depth, the two
    tile counts (fill the clusters, or tiles as large as the instance) and
    persistent clusters or a cluster a tile."""
    from nvse_tpu_torch.ops import lstm as L

    top = min((u for u in L._NARROW[dtype]["units"] if u >= H), default=max(L._NARROW[dtype]["units"]))
    seen = set()
    for U in (u for u in L._NARROW[dtype]["units"] if u <= top):
        if math.ceil(H / U) > L._NARROW_MAX_CLUSTER:
            continue
        for inst in L._NARROW_INST:
            bm = L._narrow_tile_rows(U, inst, dtype)
            for stages in L._NARROW_STAGES:
                smem = L._narrow_smem(U, inst, C, H, dtype, stages)
                if smem + L._NARROW_STATIC_SMEM > limit:
                    continue
                per_dir = _narrow_clusters(dtype, U, inst, H, smem) // 2
                if per_dir < 1:
                    continue
                fill = (min(per_dir, R) if R <= per_dir * bm
                        else per_dir * math.ceil(R / (per_dir * bm)))
                for ntiles in {fill, math.ceil(R / bm)}:
                    if math.ceil(R / ntiles) > bm:
                        continue
                    for ncl in {min(per_dir, ntiles), ntiles}:
                        key = (U, inst, stages, ntiles, ncl)
                        if key not in seen:
                            seen.add(key)
                            yield key


def _narrow_launch(args, U, inst, stages, ntiles, ncl):
    """The narrow kernel at one plan."""
    from nvse_tpu_torch.ops import lstm as L

    x = args[0]
    R, T, C = x.shape
    H = args[-1].shape[0]
    out = torch.empty(R, T, 2 * H, device="cuda", dtype=x.dtype)
    smem = L._narrow_smem(U, inst, C, H, x.dtype, stages)
    ptrs = [a.data_ptr() for a in args] + [out.data_ptr()]

    def run():
        err = L._kernel_lib().lstm_fused_launch(
            L._DTYPE_CODE[x.dtype], *ptrs, R, T, C, H, U, inst, ntiles, ncl, stages, smem,
            torch.cuda.current_stream().cuda_stream)
        L._raise_on(err, "lstm_fused")
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


def _bench_wide(emit, iters, n_sm, limit):
    from nvse_tpu_torch.ops import lstm as L

    C = H = 256
    for label, R, T in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            inputs = _inputs(R, T, C, H, dtype, seed=R + T)
            with torch.inference_mode():
                ref = L.lstm_scan_fused(*inputs).float()
            plan = L._fused_wide_card_plan(0, R, C, H, dtype, 0)
            best = None
            for U, rows, kc, stages, groups in _variants(R, C, H, dtype, n_sm, limit):
                run = _launch(inputs, U, rows, kc, stages, groups)
                diff = (run().float() - ref).abs().max().item()
                ms = _ms(run, iters)
                picked = (U, rows, kc, stages, groups) == tuple(
                    plan[k] for k in ("units", "tile_rows", "kc", "stages", "groups"))
                emit(dict(shape=label, rows=R, steps=T, dtype=str(dtype)[6:], units=U,
                          tile_rows=rows, kc=kc, stages=stages, groups=groups, ms=ms,
                          max_abs_diff_vs_plan=diff, picked=picked))
                if best is None or ms < best[0]:
                    best = (ms, U, rows, kc, stages, groups, picked)
            emit(dict(shape=label, dtype=str(dtype)[6:], fastest=dict(
                zip(("ms", "units", "tile_rows", "kc", "stages", "groups", "picked"), best))))


def _bench_narrow(emit, iters, n_sm, limit):
    from nvse_tpu_torch.ops import lstm as L
    from nvse_tpu_torch.ops._measure import cudnn_lstm, no_weight_compaction

    C = H = 128
    keys = ("units", "inst", "stages", "ntiles", "clusters")
    for label, R, T in NARROW_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            inputs = _inputs(R, T, C, H, dtype, seed=R + T)
            x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b = inputs
            lib = cudnn_lstm([(w_ih_f, w_hh_f, b_f), (w_ih_b, w_hh_b, b_b)], dtype,
                             batch_first=True)
            with torch.inference_mode():
                ref = L.lstm_scan_fused(*inputs).float()
            plan = L._fused_narrow_card_plan(0, R, C, H, dtype, 0)
            best = None
            for U, inst, stages, ntiles, ncl in _narrow_variants(R, C, H, dtype, limit):
                run = _narrow_launch(inputs, U, inst, stages, ntiles, ncl)
                diff = (run().float() - ref).abs().max().item()
                ms = _ms(run, iters)
                picked = (U, inst, stages, ntiles, ncl) == tuple(plan[k] for k in keys)
                emit(dict(kernel="lstm_fused", shape=label, rows=R, steps=T, dtype=str(dtype)[6:],
                          units=U, cluster=math.ceil(H / U), inst=inst,
                          tile_rows=L._narrow_tile_rows(U, inst, dtype), stages=stages,
                          ntiles=ntiles, clusters=ncl, persistent=ncl < ntiles, ms=ms,
                          max_abs_diff_vs_plan=diff, picked=picked))
                if best is None or ms < best[0]:
                    best = (ms, U, inst, stages, ntiles, ncl, picked)
            # the yardsticks: the wide kernel at H = 128 at its plan, and cuDNN
            bps = ctypes.c_int(0)
            wide = L.fused_wide_plan(R, C, H, dtype, n_sm, limit, 1)
            L._raise_on(L._fused_wide_lib().lstm_fused_wide_blocks_per_sm(
                L._DTYPE_CODE[dtype], 0, wide["units"], wide["tile_rows"], C, H, wide["kc"],
                wide["stages"], ctypes.byref(bps)), "lstm_fused_wide (occupancy)")
            wide = L.fused_wide_plan(R, C, H, dtype, n_sm, limit, bps.value)
            run = _launch(inputs, *(wide[k] for k in ("units", "tile_rows", "kc", "stages", "groups")))
            diff = (run().float() - ref).abs().max().item()
            emit(dict(kernel="lstm_fused_wide", shape=label, rows=R, steps=T,
                      dtype=str(dtype)[6:], ms=_ms(run, iters), max_abs_diff_vs_plan=diff,
                      **{k: wide[k] for k in ("units", "tile_rows", "kc", "stages", "groups")}))
            with torch.inference_mode(), no_weight_compaction():
                diff = (lib(x)[0].float() - ref).abs().max().item()
                emit(dict(kernel="cudnn", shape=label, rows=R, steps=T, dtype=str(dtype)[6:],
                          ms=_ms(lambda: lib(x), iters), max_abs_diff_vs_plan=diff,
                          library="cuDNN bidirectional torch.nn.LSTM, projection included"))
            emit(dict(shape=label, dtype=str(dtype)[6:], fastest=dict(
                zip(("ms", "units", "inst", "stages", "ntiles", "clusters", "picked"), best))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--hidden", type=int, default=256, choices=(128, 256))
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

    (_bench_narrow if args.hidden == 128 else _bench_wide)(emit, args.iters, n_sm, limit)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
