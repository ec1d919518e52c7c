#!/usr/bin/env python3
"""The narrow scan (csrc/lstm_scan.cu), the wide backward recurrence
(csrc/lstm_bwd_wide.cu), the wide forward scans (csrc/lstm_scan_wide.cu) and
the narrow training kernels (csrc/lstm_scan.cu mode kFwdHc, csrc/lstm_bwd.cu)
at each launch plan they could take, against the plan ops/lstm.py picks.

    python3 scripts/bench_torch_scan_plan.py [--kernel scan|bwd|scan_wide|train_narrow|all]
                                             [--iters 5] [--out FILE]
    python3 scripts/bench_torch_scan_plan.py --kernel train_wrappers [--repo DIR]

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
and all of the row groups the card holds (and the plan's own). train_narrow: at
BSRNN-M's training shapes (H = 128: 544 rows x 65 steps, 1040 x 34), each dtype,
the residual-saving forward and the backward recurrence as the wrappers route
them (`train_route`), the wide kernels at H = 128 through their plans
(csrc/lstm_scan_wide.cu mode kFwdHc with `scan_wide_plan`, csrc/lstm_bwd_wide.cu
with `bwd_wide_plan`; a yardstick that costs no new kernel), and every plan of
the narrow kernels (`scan_narrow_plan` with mode lstm_fwd_hc and
`bwd_narrow_plan` for a quarter, a half, three quarters and all of the clusters
the card holds, each at its own tile instance and every larger one), each with
its bound (bytes over 3.35 TB/s or FLOPs over 67 / 989 TFLOP/s) and its us a
step. train_wrappers: the wrappers lstm_fwd_hc and lstm_bwd_recurrence alone at
those shapes, of the package in DIR (default: this checkout), so that one call
can time a parent checkout's kernels beside these. As a yardstick that no route takes,
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
if "--repo" in sys.argv:                 # the package of another checkout (train_wrappers)
    REPO = os.path.abspath(sys.argv[sys.argv.index("--repo") + 1])
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
# (label, rows, steps) of the narrow training kernels, H = 128
TRAIN_NARROW_SHAPES = (("time", 544, 65), ("band", 1040, 34))
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12


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


def _scan_variants(R, H, dtype, dirs, n_sm, limit, mode="lstm_scan"):
    """(inst, ntiles, clusters) of every plan the bench tries."""
    from nvse_tpu_torch.ops import lstm as L

    insts = L._scan_insts(dtype, mode)
    out = []
    for inst in insts:
        n = ctypes.c_int(0)
        L._raise_on(L._scan_lib().lstm_scan_max_clusters(
            L._DTYPE_CODE[dtype], L._SCAN_MODE[mode], inst, H,
            L._scan_smem(inst, dtype, L._SCAN_STAGES, mode), ctypes.byref(n)),
            "lstm_scan (occupancy)")
        for c in sorted({n.value * q // 4 for q in (1, 2, 3, 4)}):
            p = L.scan_narrow_plan(R, H, dtype, n_sm, limit, c, dirs, mode)
            if not p["co_resident"]:
                continue
            for i in insts:
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


def _train_inputs(R, T, H, dtype):
    """x_proj, W_hh and dhs as chip_smoke.py's training-kernel phase makes them."""
    g = torch.Generator().manual_seed(R + T)
    b = 1.0 / math.sqrt(H)
    xp = (0.5 * torch.randn(T, R, 4 * H, generator=g)).to("cuda", dtype)
    whh = torch.empty(H, 4 * H).uniform_(-b, b, generator=g).to("cuda", dtype)
    dhs = torch.randn(T, R, H, generator=g).to("cuda", dtype)
    return xp, whh, dhs


def _train_bounds(R, T, H, dtype):
    """The least ms the card could take for the forward and the backward
    recurrence (chip_smoke.py's: each input read once, each output written once;
    one product of R T x H x 4H forward, two backward)."""
    G, item = 4 * H, torch.tensor([], dtype=dtype).element_size()
    ops = 2 * R * T * H * G
    nb_f = (R * T * G + H * G + 2 * R * T * H) * item
    nb_b = (2 * R * T * G + 3 * R * T * H + H * G) * item
    return (max(nb_f / PEAK_BYTES, ops / PEAK_FLOPS[dtype]) * 1e3,
            max(nb_b / PEAK_BYTES, 2 * ops / PEAK_FLOPS[dtype]) * 1e3)


def _bench_train_wrappers(emit, iters):
    from nvse_tpu_torch.ops import lstm as L

    H = 128
    for label, R, T in TRAIN_NARROW_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            xp, whh, dhs = _train_inputs(R, T, H, dtype)
            with torch.inference_mode():
                hs, cs = L.lstm_fwd_hc(xp, whh)
                fwd = _ms(lambda: L.lstm_fwd_hc(xp, whh), iters)
                bwd = _ms(lambda: L.lstm_bwd_recurrence(xp, hs, cs, dhs, whh), iters)
            bf, bb = _train_bounds(R, T, H, dtype)
            emit(dict(kernel="train_wrappers", repo=REPO, shape=label, rows=R, steps=T, H=H,
                      dtype=str(dtype)[6:], fwd_ms=fwd, bwd_ms=bwd, fwd_us_per_step=fwd * 1e3 / T,
                      bwd_us_per_step=bwd * 1e3 / T, fwd_bound_ms=bf, bwd_bound_ms=bb))


def _bwd_narrow_variants(R, H, dtype, n_sm, limit):
    """(tile rows, ntiles, clusters, stages) of every narrow backward plan the bench tries."""
    from nvse_tpu_torch.ops import lstm as L

    d = L._BWD_NARROW[dtype]
    out = []
    for BM in d["tiles"]:
        for st in L._BWD_NARROW_STAGES:
            smem = L._bwd_narrow_smem(BM, dtype, st)
            if smem + L._BWD_NARROW_STATIC_SMEM > limit:
                continue
            n = ctypes.c_int(0)
            L._raise_on(L._bwd_lib().lstm_bwd_max_clusters(L._DTYPE_CODE[dtype], BM, H, smem,
                                                          ctypes.byref(n)), "lstm_bwd (occupancy)")
            for c in sorted({n.value * q // 4 for q in (1, 2, 3, 4)}):
                p = L.bwd_narrow_plan(R, H, dtype, n_sm, limit, c)
                if p["co_resident"] and BM >= p["tile_rows"]:
                    out.append((BM, p["ntiles"], p["clusters"], st))
    return sorted(set(out))


def _bench_train_narrow(emit, iters, n_sm, limit):
    from nvse_tpu_torch.ops import lstm as L

    H = 128
    for label, R, T in TRAIN_NARROW_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            xp, whh, dhs = _train_inputs(R, T, H, dtype)
            code, dt = L._DTYPE_CODE[dtype], str(dtype)[6:]
            bf, bb = _train_bounds(R, T, H, dtype)
            with torch.inference_mode():
                hs, cs = L.lstm_fwd_hc(xp, whh)
                ref_f = hs.float()
                ref_b = L.lstm_bwd_recurrence(xp, hs, cs, dhs, whh).float()
                route_f, plan_f = L._card_train_route("lstm_fwd_hc", xp, R, H)
                route_b, plan_b = L._card_train_route("lstm_bwd", xp, R, H)
                emit(dict(kernel="route", shape=label, rows=R, steps=T, H=H, dtype=dt,
                          fwd=route_f, bwd=route_b,
                          fwd_ms=_ms(lambda: L.lstm_fwd_hc(xp, whh), iters),
                          bwd_ms=_ms(lambda: L.lstm_bwd_recurrence(xp, hs, cs, dhs, whh), iters),
                          fwd_bound_ms=bf, bwd_bound_ms=bb))
            best = {}

            def timed(kind, run, ref, **plan):
                diff = (run().float() - ref).abs().max().item()
                ms = _ms(run, iters)
                chain = plan.get("rounds", 1) * T
                emit(dict(kernel=kind, shape=label, rows=R, steps=T, H=H, dtype=dt, **plan,
                          ms=ms, us_per_step=ms * 1e3 / T, us_per_chain_step=ms * 1e3 / chain,
                          bound_ms=bf if "fwd" in kind else bb, max_abs_diff_vs_route=diff))
                side = "fwd" if "fwd" in kind else "bwd"
                if side not in best or ms < best[side][0]:
                    best[side] = (ms, kind, plan)

            # (b) the wide kernels at H = 128 through their plans
            pw = L._scan_wide_card_plan(0, R, H, dtype, 1, "lstm_fwd_hc")
            if pw["co_resident"]:
                hs_w, cs_w = torch.empty_like(hs), torch.empty_like(cs)
                lo = torch.empty(2, R, H, device="cuda", dtype=torch.bfloat16)
                c_state = torch.empty(R, H, device="cuda", dtype=torch.float32)

                def fwd_wide():
                    L._raise_on(L._scan_wide_lib().lstm_fwd_hc_wide_launch(
                        code, xp.data_ptr(), whh.data_ptr(), hs_w.data_ptr(), cs_w.data_ptr(),
                        lo.data_ptr(), c_state.data_ptr(), R, T, H, *L._scan_wide_plan_args(pw),
                        torch.cuda.current_stream().cuda_stream), "lstm_fwd_hc (wide)")
                    return hs_w
                timed("fwd_wide", fwd_wide, ref_f, units=pw["units"], tile_rows=pw["tile_rows"],
                      groups=pw["groups"])
            pb = L._bwd_wide_card_plan(0, R, H, dtype)
            if pb["co_resident"]:
                U = pb["units"]
                share = torch.empty(2, H // U, R, H, device="cuda", dtype=torch.float32)
                dc = torch.empty(R, H, device="cuda", dtype=torch.float32)
                dx_w = torch.empty_like(xp)

                def bwd_wide():
                    L._raise_on(L._bwd_wide_lib().lstm_bwd_wide_launch(
                        code, xp.data_ptr(), hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
                        whh.data_ptr(), dx_w.data_ptr(), share.data_ptr(), dc.data_ptr(), R, T, H,
                        U, pb["tile_rows"], pb["groups"], pb["smem_bytes"],
                        torch.cuda.current_stream().cuda_stream), "lstm_bwd (wide)")
                    return dx_w
                timed("bwd_wide", bwd_wide, ref_b, units=U, tile_rows=pb["tile_rows"],
                      groups=pb["groups"])

            # (c) every plan of the narrow kernels; picked: the route's own plan
            for inst, ntiles, ncl in _scan_variants(R, H, dtype, 1, n_sm, limit, "lstm_fwd_hc"):
                hs_n, cs_n = torch.empty_like(hs), torch.empty_like(cs)
                smem = L._scan_smem(inst, dtype, L._SCAN_STAGES, "lstm_fwd_hc")

                def fwd_narrow(inst=inst, ntiles=ntiles, ncl=ncl, smem=smem, hs_n=hs_n, cs_n=cs_n):
                    L._raise_on(L._scan_lib().lstm_fwd_hc_launch(
                        code, xp.data_ptr(), whh.data_ptr(), hs_n.data_ptr(), cs_n.data_ptr(), R,
                        T, H, inst, ntiles, ncl, L._SCAN_STAGES, smem,
                        torch.cuda.current_stream().cuda_stream), "lstm_fwd_hc (narrow)")
                    return hs_n
                picked = route_f == "lstm_scan" and (inst, ntiles, ncl) == (
                    plan_f["inst"], plan_f["ntiles"], plan_f["clusters"])
                timed("fwd_narrow", fwd_narrow, ref_f, inst=inst, tile_rows=L._SCAN[dtype]["rows"] * inst,
                      ntiles=ntiles, clusters=ncl, rounds=math.ceil(ntiles / ncl), picked=picked)
            for BM, ntiles, ncl, st in _bwd_narrow_variants(R, H, dtype, n_sm, limit):
                dx_n = torch.empty_like(xp)
                smem = L._bwd_narrow_smem(BM, dtype, st)

                def bwd_narrow(BM=BM, ntiles=ntiles, ncl=ncl, st=st, smem=smem, dx_n=dx_n):
                    L._raise_on(L._bwd_lib().lstm_bwd_launch(
                        code, xp.data_ptr(), hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
                        whh.data_ptr(), dx_n.data_ptr(), R, T, H, BM, ntiles, ncl, st, smem,
                        torch.cuda.current_stream().cuda_stream), "lstm_bwd (narrow)")
                    return dx_n
                picked = route_b == "lstm_bwd" and (BM, ntiles, ncl, st) == (
                    plan_b["tile_rows"], plan_b["ntiles"], plan_b["clusters"], plan_b["stages"])
                timed("bwd_narrow", bwd_narrow, ref_b, tile_rows=BM, ntiles=ntiles, clusters=ncl,
                      stages=st, rounds=math.ceil(ntiles / ncl), picked=picked)
            for side in ("fwd", "bwd"):
                ms, kind, plan = best[side]
                emit(dict(kernel=f"train_narrow_{side}", shape=label, dtype=dt,
                          fastest=dict(ms=ms, kind=kind, **plan)))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--kernel", default="all",
                   choices=("scan", "bwd", "scan_wide", "train_narrow", "train_wrappers", "all"))
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--repo", default=REPO,
                   help="train_wrappers: the checkout whose package is timed (default: this one)")
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
    if args.kernel in ("train_narrow", "all"):
        _bench_train_narrow(emit, args.iters, n_sm, limit)
    if args.kernel == "train_wrappers":
        _bench_train_wrappers(emit, args.iters)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
