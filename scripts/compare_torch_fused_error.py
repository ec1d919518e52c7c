#!/usr/bin/env python3
"""How far the fused BiLSTM kernel's output lies from its plain version, over
every element, at BSRNN-M's decode shapes, on one GPU.

    python3 scripts/compare_torch_fused_error.py [--tree DIR] [--out FILE]

At C = H = 128 (the time BiLSTM 272 x 1024, the band BiLSTM 8192 x 34), float32
and bfloat16, the same seeded inputs go through `lstm_scan_fused` on the card
and `lstm_scan_fused_plain`; one JSON line a shape and dtype gives the max, the
mean and the 99th and 99.9th percentiles of |kernel - plain|, and the card
(`nvidia-smi --query-gpu=name,power.limit`). --tree names the checkout whose
`nvse_tpu_torch` is measured (default: this one), so that two trees' kernels
(for example with exact and with approximate nonlinearities) are held to the
same plain version on the same inputs. Needs a CUDA GPU.
"""
import argparse
import json
import math
import os
import subprocess
import sys

import torch

SHAPES = (("time", 272, 1024), ("band", 8192, 34))


def _inputs(R, T, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    b = 1.0 / math.sqrt(128)
    x = torch.randn(R, T, 128, generator=g)
    w = [torch.empty(s).uniform_(-b, b, generator=g)
         for s in [(128, 512), (128, 512), (512,), (512,), (128, 512), (128, 512)]]
    return [t.to("cuda", dtype) for t in [x, *w]]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--out", default=None, help="also write the lines to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("compare_torch_fused_error: needs a CUDA GPU")
    sys.path.insert(0, os.path.abspath(args.tree))
    from nvse_tpu_torch import resolve_device
    from nvse_tpu_torch.ops import lstm as L

    resolve_device("cuda")
    device = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60).stdout.strip()
    lines = []
    for label, R, T in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            inputs = _inputs(R, T, dtype, seed=R + T)
            with torch.inference_mode():
                err = (L.lstm_scan_fused(*inputs).float()
                       - L.lstm_scan_fused_plain(*inputs).float()).abs().flatten()
            s = err.sort().values
            q = {f"p{p}": s[min(s.numel() - 1, int(p / 100 * s.numel()))].item() for p in (99, 99.9)}
            line = json.dumps(dict(shape=label, rows=R, steps=T, dtype=str(dtype)[6:],
                                   tree=os.path.abspath(args.tree), max=s[-1].item(),
                                   mean=err.mean().item(), **q, device=device))
            print(line, flush=True)
            lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
