#!/usr/bin/env python3
"""Where the time goes in the port's BSRNN-M decode on one GPU.

    python3 scripts/profile_torch_decode.py [--iters 3]

Runs the B=8 x 1024-frame mel->wave decode of nvse_tpu_torch (seeded
random BSRNN-M weights, float32 then bfloat16) under torch.profiler after
one warmup forward, and prints one JSON line per dtype: wall ms per
forward, device-busy ms per forward (sum of kernel times; one stream, so
kernels do not overlap), the idle share, the fused-LSTM kernel's share,
and the ten kernels with the most device time. Needs a CUDA GPU.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_decode: needs a CUDA GPU")
    sys.path.insert(0, REPO)
    from torch.profiler import ProfilerActivity, profile

    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.utils import load_config

    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", "bsrnn_config.json"))
    B, T = 8, 1024
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, h.num_mels, T)).astype(np.float32) - 4.0).cuda()
    for dtype in ("float32", "bfloat16"):
        hd = type(h)(h)
        hd["compute_dtype"] = dtype
        eng = InferenceEngine(hd, device="cuda")
        eng.forward(mel)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for _ in range(args.iters):
                eng.forward(mel)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3 / args.iters
        kernels = {}
        for evt in prof.key_averages():
            us = _device_us(evt)
            if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
                kernels[evt.key] = kernels.get(evt.key, 0.0) + us
        busy_ms = sum(kernels.values()) / 1e3 / args.iters
        lstm_ms = sum(v for k, v in kernels.items() if "lstm_fused" in k) / 1e3 / args.iters
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
        print(json.dumps({
            "dtype": dtype, "batch": B, "frames": T, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
            "idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else "not measured",
            "lstm_kernel_ms": lstm_ms,
            "lstm_share_of_busy": lstm_ms / busy_ms if busy_ms > 0 else "not measured",
            "top_kernels_ms": [[k[:80], v / 1e3 / args.iters] for k, v in top],
        }), flush=True)
        del eng


if __name__ == "__main__":
    main()
