#!/usr/bin/env python3
"""The narrow scan (csrc/lstm_scan.cu), the wide backward recurrence
(csrc/lstm_bwd_wide.cu) and the wide forward scans (csrc/lstm_scan_wide.cu) at
each launch plan they could take, against the plan ops/lstm.py picks.

    python3 scripts/bench_torch_scan_plan.py [--kernel scan|bwd|scan_wide|all] [--iters 5]
                                             [--out FILE]

scan: at every shape the BSRNN-M paths and the LSTM-layout bench give it (H =
128: the causal decode's time LSTM, a context-recompute window of one file, a
streaming chunk of 8 streams and of one from a carried state, and B7's time
and band scans over both directions), each dtype, it launches the plan that
`scan_narrow_plan` makes for a quarter, a half, three quarters and all of the
clusters the card holds, each at its own tile instance and at every larger
one. bwd: at BSRNN-L's training shapes (H = 256: the time and band BiLSTMs)
and GCRN's (H = 448), each dtype, every instance of the kernel (units a block,
rows a tile) that fits, with a quarter, a half and all of the row groups the
card holds. scan_wide: at every shape BSRNN-L's paths (H = 256: the training
forward at the time and band shapes, the causal decode's time LSTM, the
offline decode beside the streams, a streaming chunk of 8 streams and of one,
a context-recompute window), GCRN's training forward (16 x 65, H = 448) and
B7's bench (both directions, 544 x 1024 and 8192 x 68) give it, each dtype,
every instance (units a block, rows a tile) that fits, with a quarter, a half
and all of the row groups the card holds (and the plan's own). As a yardstick that no route takes,
beside each scan shape: cuDNN's unidirectional torch.nn.LSTM forward, one a
direction, the projection included.

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

# (label, rows of a direction, steps, directions, stateful) of the narrow scan, H = 128
SCAN_SHAPES = (("decode", 272, 1024, 1, False), ("window", 34, 96, 1, False),
               ("chunk", 272, 80, 1, True), ("chunk1", 34, 80, 1, True),
               ("bidir_time", 544, 1024, 2, False), ("bidir_band", 8192, 68, 2, False))
# (label, rows, steps, H) of the wide backward recurrence
BWD_SHAPES = (("time", 544, 65, 256), ("band", 1040, 34, 256), ("gcrn", 16, 65, 448))
# (label, wrapper, rows of a direction, steps, H) of the wide forward scans
SCAN_WIDE_SHAPES = (("time", "lstm_fwd_hc", 544, 65, 256), ("band", "lstm_fwd_hc", 1040, 34, 256),
                    ("gcrn", "lstm_fwd_hc", 16, 65, 448), ("decode", "lstm_scan", 272, 1024, 256),
                    ("stream", "lstm_scan", 272, 512, 256),
                    ("chunk", "lstm_scan_stateful", 272, 80, 256),
                    ("window", "lstm_scan", 34, 96, 256),
                    ("chunk1", "lstm_scan_stateful", 34, 80, 256),
                    ("bidir_time", "lstm_scan_bidir", 544, 1024, 256),
                    ("bidir_band", "lstm_scan_bidir", 8192, 68, 256))


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


def _scan_variants(R, H, dtype, dirs, n_sm, limit):
    """(inst, ntiles, clusters) of every plan the bench tries."""
    from nvse_tpu_torch.ops import lstm as L

    d = L._SCAN[dtype]
    out = []
    for inst in d["insts"]:
        n = ctypes.c_int(0)
        L._raise_on(L._scan_lib().lstm_scan_max_clusters(
            L._DTYPE_CODE[dtype], inst, H, L._scan_smem(inst, dtype, L._SCAN_STAGES),
            ctypes.byref(n)), "lstm_scan (occupancy)")
        for c in sorted({n.value * q // 4 for q in (1, 2, 3, 4)}):
            p = L.scan_narrow_plan(R, H, dtype, n_sm, limit, c, dirs)
            if not p["co_resident"]:
                continue
            for i in d["insts"]:
                if i >= p["inst"]:
                    out.append((i, p["ntiles"], p["clusters"]))
    return sorted(set(out))


def _scan_launch(xp, w, state, dirs, R, inst, ntiles, ncl):
    from nvse_tpu_torch.ops import lstm as L

    T, Rs, G = xp.shape
    H = G // 4
    hs = torch.empty(T, Rs, H, device="cuda", dtype=xp.dtype)
    cs = torch.empty_like(hs)
    lib, code = L._scan_lib(), L._DTYPE_CODE[xp.dtype]
    smem = L._scan_smem(inst, xp.dtype, L._SCAN_STAGES)
    plan = (R, T, H, inst, ntiles, ncl, L._SCAN_STAGES, smem)

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        if dirs == 2:
            err = lib.lstm_scan_bidir_launch(code, xp.data_ptr(), w.data_ptr(), hs.data_ptr(),
                                             *plan, stream)
        elif state is None:
            err = lib.lstm_scan_launch(code, xp.data_ptr(), w.data_ptr(), hs.data_ptr(), *plan,
                                       stream)
        else:
            err = lib.lstm_scan_stateful_launch(code, xp.data_ptr(), w.data_ptr(),
                                                state[0].data_ptr(), state[1].data_ptr(),
                                                hs.data_ptr(), cs.data_ptr(), *plan, stream)
        L._raise_on(err, "lstm_scan")
        return hs
    return run


def _bench_scan(emit, iters, n_sm, limit):
    from nvse_tpu_torch.ops import lstm as L
    from nvse_tpu_torch.ops._measure import cudnn_lstm, no_weight_compaction

    H, G = 128, 512
    for label, R, T, dirs, stateful in SCAN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(R + T)
            b = 1.0 / math.sqrt(H)
            x = torch.randn(T, dirs * R, H, generator=g).to("cuda", dtype)
            w_ih, bias = (torch.empty(sh).uniform_(-b, b, generator=g).to("cuda", dtype)
                          for sh in ((H, G), (G,)))
            w = torch.empty(dirs * H, G).uniform_(-b, b, generator=g).to("cuda", dtype)
            state = tuple((0.3 * torch.randn(R, H, generator=g)).to("cuda", dtype)
                          for _ in range(2)) if stateful else None
            with torch.inference_mode():
                xp = (x @ w_ih + bias).contiguous()
                if dirs == 2:
                    ref = L.lstm_scan_bidir(xp, w).float()
                elif stateful:
                    ref = L.lstm_scan_stateful(xp, w, *state)[0].float()
                else:
                    ref = L.lstm_scan(xp, w).float()
            plan = L._scan_card_plan(0, R, H, dtype, dirs)
            best = None
            for inst, ntiles, ncl in _scan_variants(R, H, dtype, dirs, n_sm, limit):
                run = _scan_launch(xp, w, state, dirs, R, inst, ntiles, ncl)
                diff = (run().float() - ref).abs().max().item()
                ms = _ms(run, iters)
                picked = (inst, ntiles, ncl) == (plan["inst"], plan["ntiles"], plan["clusters"])
                emit(dict(kernel="lstm_scan", shape=label, rows=dirs * R, steps=T,
                          dtype=str(dtype)[6:], inst=inst,
                          tile_rows=L._SCAN[dtype]["rows"] * inst, ntiles=ntiles, clusters=ncl,
                          rounds=math.ceil(ntiles / ncl), ms=ms, us_per_step=ms * 1e3 / T,
                          max_abs_diff_vs_plan=diff, picked=picked))
                if best is None or ms < best[0]:
                    best = (ms, inst, ntiles, ncl, picked)
            lib = [cudnn_lstm([(w_ih, w[d * H:(d + 1) * H], bias)], dtype) for d in range(dirs)]
            lib_state = (state[0][None], state[1][None]) if stateful else None
            with torch.inference_mode(), no_weight_compaction():
                xs = [x[:, d * R:(d + 1) * R].contiguous() for d in range(dirs)]
                call = lambda: [lib[d](xs[d], lib_state) for d in range(dirs)]
                emit(dict(kernel="cudnn", shape=label, rows=dirs * R, steps=T,
                          dtype=str(dtype)[6:], ms=_ms(call, iters),
                          library=f"{dirs} cuDNN torch.nn.LSTM forward, projection included"))
            emit(dict(kernel="lstm_scan", shape=label, dtype=str(dtype)[6:], fastest=dict(
                zip(("ms", "inst", "ntiles", "clusters", "picked"), best))))


def _bench_bwd(emit, iters, n_sm, limit):
    from nvse_tpu_torch.ops import lstm as L

    for label, R, T, H in BWD_SHAPES:
        G = 4 * H
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(R + T)
            b = 1.0 / math.sqrt(H)
            xp = (0.5 * torch.randn(T, R, G, generator=g)).to("cuda", dtype)
            whh = torch.empty(H, G).uniform_(-b, b, generator=g).to("cuda", dtype)
            dhs = torch.randn(T, R, H, generator=g).to("cuda", dtype)
            with torch.inference_mode():
                hs, cs = L.lstm_fwd_hc(xp, whh)
                ref = L.lstm_bwd_recurrence(xp, hs, cs, dhs, whh).float()
            plan = L._bwd_wide_card_plan(0, R, H, dtype)
            lib, code = L._bwd_wide_lib(), L._DTYPE_CODE[dtype]
            best = None
            for U, TM in L._BWD_WIDE[dtype]:
                smem = L._bwd_wide_smem(U, TM, H, dtype)
                if H % U or smem > limit:
                    continue
                bps = ctypes.c_int(0)
                L._raise_on(lib.lstm_bwd_wide_blocks_per_sm(code, U, TM, smem, ctypes.byref(bps)),
                            "lstm_bwd_wide (occupancy)")
                top = min(bps.value * n_sm // (H // U), R)
                counts = {max(1, top * q // 4) for q in (1, 2, 4)}
                if (U, TM) == (plan["units"], plan["tile_rows"]):
                    counts.add(plan["groups"])
                for groups in sorted(counts):
                    share = torch.empty(2, H // U, R, H, device="cuda", dtype=torch.float32)
                    dc = torch.empty(R, H, device="cuda", dtype=torch.float32)
                    dx = torch.empty_like(xp)

                    def run():
                        L._raise_on(lib.lstm_bwd_wide_launch(
                            code, xp.data_ptr(), hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
                            whh.data_ptr(), dx.data_ptr(), share.data_ptr(), dc.data_ptr(), R, T,
                            H, U, TM, groups, smem, torch.cuda.current_stream().cuda_stream),
                            "lstm_bwd_wide")
                        return dx
                    diff = (run().float() - ref).abs().max().item()
                    ms = _ms(run, iters)
                    picked = (U, TM, groups) == (plan["units"], plan["tile_rows"], plan["groups"])
                    emit(dict(kernel="lstm_bwd_wide", shape=label, rows=R, steps=T, H=H,
                              dtype=str(dtype)[6:], units=U, tile_rows=TM, groups=groups,
                              blocks=groups * (H // U), ms=ms, us_per_step=ms * 1e3 / T,
                              max_abs_diff_vs_plan=diff, picked=picked))
                    if best is None or ms < best[0]:
                        best = (ms, U, TM, groups, picked)
            emit(dict(kernel="lstm_bwd_wide", shape=label, dtype=str(dtype)[6:], fastest=dict(
                zip(("ms", "units", "tile_rows", "groups", "picked"), best))))


def _scan_wide_launch(mode, xp, w, state, R, U, TM, groups, launch_dirs, smem):
    """A launch of csrc/lstm_scan_wide.cu in the mode of the wrapper `mode` at
    one plan; -> the call, which returns hs."""
    from nvse_tpu_torch.ops import lstm as L

    T, Rs, G = xp.shape
    H = G // 4
    hs = torch.empty(T, Rs, H, device="cuda", dtype=xp.dtype)
    cs = torch.empty_like(hs)
    c_state = torch.empty(Rs, H, device="cuda", dtype=torch.float32)
    lo = torch.empty(2, R, H, device="cuda", dtype=torch.bfloat16)
    lib, code = L._scan_wide_lib(), L._DTYPE_CODE[xp.dtype]
    plan = (U, TM, groups)

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        p = (xp.data_ptr(), w.data_ptr())
        if mode == "lstm_fwd_hc":
            err = lib.lstm_fwd_hc_wide_launch(code, *p, hs.data_ptr(), cs.data_ptr(),
                                              lo.data_ptr(), c_state.data_ptr(), R, T, H,
                                              *plan, smem, stream)
        elif mode == "lstm_scan":
            err = lib.lstm_scan_wide_launch(code, *p, hs.data_ptr(), c_state.data_ptr(), R, T,
                                            H, *plan, smem, stream)
        elif mode == "lstm_scan_stateful":
            err = lib.lstm_scan_stateful_wide_launch(code, *p, state[0].data_ptr(),
                                                     state[1].data_ptr(), hs.data_ptr(),
                                                     cs.data_ptr(), c_state.data_ptr(), R, T, H,
                                                     *plan, smem, stream)
        else:
            err = lib.lstm_scan_bidir_wide_launch(code, *p, w[H:].data_ptr(), hs.data_ptr(),
                                                  c_state.data_ptr(), R, T, H, *plan,
                                                  launch_dirs, smem, stream)
        L._raise_on(err, mode)
        return hs
    return run


def _bench_scan_wide(emit, iters, n_sm, limit):
    from nvse_tpu_torch.ops import lstm as L
    from nvse_tpu_torch.ops._measure import cudnn_lstm, no_weight_compaction

    for label, mode, R, T, H in SCAN_WIDE_SHAPES:
        G, dirs = 4 * H, 2 if mode == "lstm_scan_bidir" else 1
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(R + T)
            b = 1.0 / math.sqrt(H)
            x = torch.randn(T, dirs * R, H, generator=g).to("cuda", dtype)
            w_ih, bias = (torch.empty(sh).uniform_(-b, b, generator=g).to("cuda", dtype)
                          for sh in ((H, G), (G,)))
            w = torch.empty(dirs * H, G).uniform_(-b, b, generator=g).to("cuda", dtype)
            state = tuple((0.3 * torch.randn(R, H, generator=g)).to("cuda", dtype)
                          for _ in range(2)) if mode == "lstm_scan_stateful" else None
            with torch.inference_mode():
                xp = (x @ w_ih + bias).contiguous()
                if mode == "lstm_fwd_hc":
                    ref = L.lstm_fwd_hc(xp, w)[0]
                elif mode == "lstm_scan_bidir":
                    ref = L.lstm_scan_bidir(xp, w)
                elif state is not None:
                    ref = L.lstm_scan_stateful(xp, w, *state)[0]
                else:
                    ref = L.lstm_scan(xp, w)
                ref = ref.float()
            plan = L._scan_wide_card_plan(0, R, H, dtype, dirs, mode)
            code = L._DTYPE_CODE[dtype]
            best = None
            for U, TM in L._SCAN_WIDE[dtype]:
                smem = L._scan_wide_smem(U, TM, H, dtype, mode)
                if H % U or smem > limit:
                    continue
                bps = ctypes.c_int(0)
                L._raise_on(L._scan_wide_lib().lstm_scan_wide_blocks_per_sm(
                    code, L._SCAN_WIDE_MODE[mode], U, TM, smem, ctypes.byref(bps)),
                    f"{mode} (occupancy)")
                slots = bps.value * n_sm // (H // U)
                launch_dirs = dirs if slots >= dirs else 1
                top = min(slots // launch_dirs, R)
                counts = {max(1, top * q // 4) for q in (1, 2, 4)}
                if (U, TM) == (plan["units"], plan["tile_rows"]):
                    counts.add(plan["groups"])
                for groups in sorted(counts):
                    run = _scan_wide_launch(mode, xp, w, state, R, U, TM, groups, launch_dirs,
                                            smem)
                    diff = (run().float() - ref).abs().max().item()
                    ms = _ms(run, iters)
                    picked = (U, TM, groups) == (plan["units"], plan["tile_rows"], plan["groups"])
                    emit(dict(kernel="lstm_scan_wide", mode=mode, shape=label, rows=dirs * R,
                              steps=T, H=H, dtype=str(dtype)[6:], units=U, tile_rows=TM,
                              groups=groups, launch_dirs=launch_dirs, blocks_per_sm=bps.value,
                              blocks=launch_dirs * groups * (H // U), ms=ms,
                              us_per_step=ms * 1e3 / T * dirs / launch_dirs,
                              max_abs_diff_vs_plan=diff, picked=picked))
                    if best is None or ms < best[0]:
                        best = (ms, U, TM, groups, picked)
            lib = [cudnn_lstm([(w_ih, w[d * H:(d + 1) * H], bias)], dtype) for d in range(dirs)]
            lib_state = (state[0][None], state[1][None]) if state is not None else None
            with torch.inference_mode(), no_weight_compaction():
                xs = [x[:, d * R:(d + 1) * R].contiguous() for d in range(dirs)]
                call = lambda: [lib[d](xs[d], lib_state) for d in range(dirs)]
                emit(dict(kernel="cudnn", mode=mode, shape=label, rows=dirs * R, steps=T, H=H,
                          dtype=str(dtype)[6:], ms=_ms(call, iters),
                          library=f"{dirs} cuDNN torch.nn.LSTM forward, projection included"))
            emit(dict(kernel="lstm_scan_wide", mode=mode, shape=label, dtype=str(dtype)[6:],
                      fastest=dict(zip(("ms", "units", "tile_rows", "groups", "picked"), best))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--kernel", default="all", choices=("scan", "bwd", "scan_wide", "all"))
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--out", default=None, help="also write the lines to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_torch_scan_plan: needs a CUDA GPU")
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

    if args.kernel in ("scan", "all"):
        _bench_scan(emit, args.iters, n_sm, limit)
    if args.kernel in ("bwd", "all"):
        _bench_bwd(emit, args.iters, n_sm, limit)
    if args.kernel in ("scan_wide", "all"):
        _bench_scan_wide(emit, args.iters, n_sm, limit)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
