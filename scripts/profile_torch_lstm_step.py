#!/usr/bin/env python3
"""Per-step split of the port's fused LSTM kernels: the counterpart of
scripts/profile_lstm_step.py, on the kernels of nvse_tpu_torch.

    python3 scripts/profile_torch_lstm_step.py [--dtype float32|bfloat16]
        [--shapes m_time,m_band,l_time,l_band] [--iters 30] [--out FILE [--append]]
        [--device cuda|cpu]

A fused LSTM step reads its input, does two products (x @ W_ih and
h @ W_hh), the cell's sigmoids and tanhs, and writes h. Timing five variants
of one direction of the production kernel (nvse_tpu_torch/ops/lstm_step.py)
splits the step's time into those parts:
  full      the production kernel (csrc/lstm_fused.cu at H = 128,
            csrc/lstm_fused_wide.cu at H = 256);
  no_indma  every step reads x[0], which stays in L2: full - no_indma is the
            input's DRAM traffic;
  no_dot    gates = tile(x_t, 4) * 0.25 + b: full - no_dot is both products;
  no_vpu    no sigmoid or tanh: full - no_vpu is the nonlinearities;
  empty     the zero state written at every step: the floor (launch, step
            loop, its synchronisation, the output writes).
Each variant keeps the launch, the grid of a decode's launch (one direction's
blocks of it), the step loop with its synchronisation (the wide kernel's grid
barrier a step) and the output writes. The shapes are the port's decode shapes
of one direction: BSRNN-M's time LSTM (272 rows x 1024 steps) and band LSTM
(8192 x 34), C = H = 128, and BSRNN-L's at C = H = 256. The TPU script's
unroll k (steps a grid step) is a grid artefact and is not ported
(`_choose_*_unroll` does not carry over): a variant here is the kernel the
decode runs, its whole step loop.
(At k > 1 the TPU `empty` variant writes only the first step of each block;
the others read NaN. Every variant here writes every step.)

Prints one JSON line per (shape, variant): shape, T, B, C, H, dtype, steps,
variant, ms, us_per_step (ms over the steps) and device (`nvidia-smi
--query-gpu=name,power.limit` on the card, "cpu" otherwise). A time is the
mean over --iters launches of the kernel after a warm-up, by CUDA events;
with --device cpu the plain versions run, timed by the host clock. --out has
no default: the lines go to that file only when it is given. Inputs come
from torch's generator on the device, seeded 0. main(argv) returns the rows.
"""
import argparse
import json
import math
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_torch_lstm_kernel import device_label, resolve, time_ms  # noqa: E402
from nvse_tpu_torch.ops.lstm_step import MODES, lstm_step_variant  # noqa: E402

# label: (T, rows, C, H), one direction of the fused BiLSTMs of a B = 8 x 1024 decode
SHAPES = {"m_time": ("bsrnn_m_time", 1024, 272, 128, 128),
          "m_band": ("bsrnn_m_band", 34, 8192, 128, 128),
          "l_time": ("bsrnn_l_time", 1024, 272, 256, 256),
          "l_band": ("bsrnn_l_band", 34, 8192, 256, 256)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def inputs(T, R, C, H, dtype, device, seed=0):
    """x (R, T, C), w_ih (C, 4H), w_hh (H, 4H), b (4H,) on `device`: x
    standard normal, the weights uniform in +-1/sqrt(H) (torch.nn.LSTM's
    init)."""
    g = torch.Generator(device).manual_seed(seed)
    bound = 1.0 / math.sqrt(H)
    x = torch.randn(R, T, C, generator=g, device=device)
    w = [torch.empty(s, device=device).uniform_(-bound, bound, generator=g)
         for s in ((C, 4 * H), (H, 4 * H), (4 * H,))]
    return [t.to(dtype) for t in (x, *w)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    p.add_argument("--shapes", default="m_time,m_band,l_time,l_band",
                   help="comma subset of " + ",".join(SHAPES))
    p.add_argument("--append", action="store_true", help="append to --out instead of overwriting")
    p.add_argument("--out", default=None, help="also write the lines to this file")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve(args.device)
    label = device_label(device)
    dtype = DTYPES[args.dtype]
    rows = []
    out = open(args.out, "a" if args.append else "w") if args.out else None
    try:
        for key in args.shapes.split(","):
            name, T, R, C, H = SHAPES[key]
            x, w_ih, w_hh, b = inputs(T, R, C, H, dtype, device)
            for mode in MODES:
                with torch.inference_mode():
                    ms = time_ms(lambda: lstm_step_variant(x, w_ih, w_hh, b, mode), args.iters,
                                 device)
                row = {"shape": name, "T": T, "B": R, "C": C, "H": H, "dtype": args.dtype,
                       "steps": T, "variant": mode, "ms": ms, "us_per_step": ms * 1e3 / T,
                       "device": label}
                print(json.dumps(row), flush=True)
                if out:
                    out.write(json.dumps(row) + "\n")
                    out.flush()
                rows.append(row)
    finally:
        if out:
            out.close()
    return rows


if __name__ == "__main__":
    main()
