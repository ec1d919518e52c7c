#!/usr/bin/env python3
"""The port's LSTM-layout microbenchmark: the counterpart of
scripts/bench_lstm_kernel.py, on the kernels of nvse_tpu_torch.

    python3 scripts/bench_torch_lstm_kernel.py [--batch 8] [--frames 1024] [--bands 68]
        [--hidden 128] [--iters 10] [--device cuda|cpu]

At BSRNN's time-LSTM shape (T = frames over batch x bands rows) and band-LSTM
shape (T = bands over batch x frames rows) it times, as the JAX script does:
  unfused    two lstm_scan calls (two launches);
  dualdot    lstm_scan_bidir2, both scans in one launch (the kernel bidir2_plan picks);
  blockdiag  lstm_scan_bidir, both directions as stacked rows of one scan
             (csrc/lstm_scan.cu, csrc/lstm_scan_wide.cu); the label is the JAX
             one, but the port's kernel multiplies each row by its own W_hh only;
these three again in bfloat16 (`<variant>_bf16`; the JAX script times them in
float32 only), and the whole BiLSTM from x:
  endtoend_unfused_{f32,bf16}  x @ W_ih + b in torch, then two float32 lstm_scan;
  fusedproj_{f32,bf16}         lstm_scan_fused (its route, ops/lstm.py `_fused_route`);
and, as the yardstick, `library` / `library_bf16`: two unidirectional
torch.nn.LSTM forwards (cuDNN on the card), the projection included, which the
port never calls. The JAX script times blockdiag with the row concatenation
inside; here the rows are stacked once, outside the timed call.
Inputs come from torch's generator on the device, seeded 0, at the JAX
script's scales.

Prints one JSON line per (shape, variant) with the JAX script's keys (shape,
T, B, H, variant, ms) and `device`: `nvidia-smi --query-gpu=name,power.limit`
on the card, "cpu" otherwise. A time is a mean over --iters calls after one
warm-up: CUDA events on the card, the host clock with --device cpu (the
wrappers then run their plain versions; no kernel is timed). main(argv)
returns the launches each wrapper made, per shape.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from nvse_tpu_torch.ops import lstm as L  # noqa: E402
from nvse_tpu_torch.ops._measure import (cudnn_lstm, launch_delta,  # noqa: E402
                                         no_weight_compaction)

WRAPPERS = ("lstm_scan", "lstm_scan_bidir2", "lstm_scan_bidir", "lstm_scan_fused")


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, device: torch.device) -> float:
    """Mean ms of fn over iters calls after one warm-up."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def resolve(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA GPU visible: run on the card, or pass --device cpu")
    return device


def _scan_variants(xf, xb, wf, wb):
    xcat, wcat = torch.cat([xf, xb], dim=1), torch.cat([wf, wb], dim=0)
    return {"unfused": lambda: (L.lstm_scan(xf, wf), L.lstm_scan(xb, wb)),
            "dualdot": lambda: L.lstm_scan_bidir2(xf, xb, wf, wb),
            "blockdiag": lambda: L.lstm_scan_bidir(xcat, wcat)}


def _endtoend_unfused(x, wif, wib, bf, bb, whf, whb):
    xg_f = (x @ wif + bf).transpose(0, 1)
    xg_b = (x.flip(1) @ wib + bb).transpose(0, 1)
    hs_f = L.lstm_scan(xg_f.float().contiguous(), whf.float()).transpose(0, 1)
    hs_b = L.lstm_scan(xg_b.float().contiguous(), whb.float()).transpose(0, 1)
    return torch.cat([hs_f, hs_b.flip(1)], dim=-1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--frames", type=int, default=1024)
    p.add_argument("--bands", type=int, default=68)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve(args.device)
    label = device_label(device)
    before = {k: dict(getattr(L, k).launches_by_shape) for k in WRAPPERS}

    H = C = args.hidden
    shapes = {"time_lstm": (args.frames, args.batch * args.bands),
              "band_lstm": (args.bands, args.batch * args.frames)}
    g = torch.Generator(device).manual_seed(0)

    def randn(*shape, scale):
        return torch.randn(*shape, generator=g, device=device) * scale

    def say(shape, T, B, variant, ms):
        print(json.dumps({"shape": shape, "T": T, "B": B, "H": H, "variant": variant, "ms": ms,
                          "device": label}), flush=True)

    for shape, (T, B) in shapes.items():
        xf, xb = (randn(T, B, 4 * H, scale=.1) for _ in range(2))
        wf, wb = (randn(H, 4 * H, scale=.05) for _ in range(2))
        for dt, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            scans = [t.to(dt) for t in (xf, xb, wf, wb)]
            with torch.inference_mode():
                for variant, fn in _scan_variants(*scans).items():
                    say(shape, T, B, variant + tag, time_ms(fn, args.iters, device))

        # the whole BiLSTM from x: compare with endtoend_unfused, not the scans above
        x = randn(B, T, C, scale=.1)
        wif, wib = (randn(C, 4 * H, scale=.05) for _ in range(2))
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            a = [v.to(dt) for v in (x, wif, wib)]
            a[3:3] = [torch.zeros(4 * H, device=device, dtype=dt) for _ in range(2)]
            a += [w.to(dt) for w in (wf, wb)]
            with torch.inference_mode():
                say(shape, T, B, f"endtoend_unfused_{tag}",
                    time_ms(lambda: _endtoend_unfused(*a), args.iters, device))
                say(shape, T, B, f"fusedproj_{tag}",
                    time_ms(lambda: L.lstm_scan_fused(*a), args.iters, device))

        # two unidirectional torch.nn.LSTM forwards (cuDNN on the card), projection included
        xs = [randn(T, B, C, scale=.1) for _ in range(2)]
        for dt, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            lstms = [cudnn_lstm([(w_ih.to(dt), w.to(dt),
                                  torch.zeros(4 * H, device=device, dtype=dt))], dt, device=device)
                     for w_ih, w in ((wif, wf), (wib, wb))]
            xd = [v.to(dt) for v in xs]
            with torch.inference_mode(), no_weight_compaction():
                say(shape, T, B, "library" + tag,
                    time_ms(lambda: [m(v)[0] for m, v in zip(lstms, xd)], args.iters, device))
    return {k: launch_delta(getattr(L, k).launches_by_shape, before[k]) for k in WRAPPERS}


if __name__ == "__main__":
    main()
