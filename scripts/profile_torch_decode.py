#!/usr/bin/env python3
"""Where the time goes in the port's BSRNN-M, BSRNN-L, GCRN, ConvTasNet and HD-Demucs decodes on one GPU.

    python3 scripts/profile_torch_decode.py [--iters 3] [--model bsrnn|bsrnn_l|gcrn|convtasnet|hddemucs|both]

Runs the B=8 x 1024-frame mel->wave decode of nvse_tpu_torch (seeded
random weights at full width, float32 then bfloat16) under torch.profiler
after one warmup forward, and prints one JSON line per model and dtype
(ConvTasNet: per dtype with fused_tcn 1, then 0): wall ms per forward,
device-busy ms per forward (sum of kernel times; one stream, so kernels do
not overlap), the idle share, the hand-written kernel's share (`kernel`:
lstm_fused for BSRNN-M, lstm_fused_wide for BSRNN-L, lstm_bidir2 for GCRN,
the tail and its gLN statistics (tcn_) for ConvTasNet, the bottleneck's
lstm_scan_wide (kScanBidir) for HD-Demucs; "both" is BSRNN-M and
GCRN), device ms per
category of kernel name (the hand-written kernels, FFT, convolution, gemm,
elementwise and copies, other) and the twelve kernels with the most device
time. Needs a CUDA GPU.
"""
import argparse
import json
import os
import subprocess
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


# kernel-name fragments of each category, tried in this order
CATEGORIES = (
    ("lstm", ("lstm_",)),
    ("tcn_tail", ("tcn_tail", "tcn_gln")),
    ("fft", ("fft",)),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit", "cudnn", "winograd",
                     "im2col", "col2im", "nchwtonhwc", "nhwctonchw")),
    ("gemm", ("gemm", "gemv", "cublas", "cutlass")),
    ("elementwise_and_copies", ("elementwise", "vectorized", "reduce", "catarray", "copy",
                                "memcpy", "memset", "layer_norm", "index", "fill")),
)
# model -> (config, the hand-written kernel's name fragment, config variants)
CONFIGS = {"bsrnn": ("bsrnn_config.json", "lstm_fused", ({},)),
           "bsrnn_l": ("bsrnn_l_config.json", "lstm_fused_wide", ({},)),
           "gcrn": ("gcrn_config.json", "lstm_bidir2", ({},)),
           "convtasnet": ("convtasnet_config.json", "tcn_",
                          ({"fused_tcn": 1}, {"fused_tcn": 0})),
           "hddemucs": ("hddemucas_config.json", "lstm_scan_wide", ({},))}


def category(kernel_name: str) -> str:
    low = kernel_name.lower()
    for name, fragments in CATEGORIES:
        if any(f in low for f in fragments):
            return name
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--model", default="both",
                    choices=("bsrnn", "bsrnn_l", "gcrn", "convtasnet", "hddemucs", "both"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_decode: needs a CUDA GPU")
    sys.path.insert(0, REPO)
    from torch.profiler import ProfilerActivity, profile

    from nvse_tpu_torch import resolve_device
    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.utils import load_config

    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    B, T = 8, 1024
    for model in ("bsrnn", "gcrn") if args.model == "both" else (args.model,):
        cfg, kernel, variants = CONFIGS[model]
        h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", cfg))
        mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (B, h.num_mels, T)).astype(np.float32) - 4.0).cuda()
        for dtype, variant in [(d, v) for d in ("float32", "bfloat16") for v in variants]:
            hd = type(h)(h)
            hd.update(variant, compute_dtype=dtype)
            eng = InferenceEngine(hd, device="cuda")
            eng.forward(mel)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.time()
                for _ in range(args.iters):
                    eng.forward(mel)
                torch.cuda.synchronize()
                wall_ms = (time.time() - t0) * 1e3 / args.iters
            # the same loop without the profiler: what tracing costs
            t0 = time.time()
            for _ in range(args.iters):
                eng.forward(mel)
            torch.cuda.synchronize()
            untraced_ms = (time.time() - t0) * 1e3 / args.iters
            kernels = {}
            for evt in prof.key_averages():
                us = _device_us(evt)
                if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
                    kernels[evt.key] = kernels.get(evt.key, 0.0) + us
            busy_ms = sum(kernels.values()) / 1e3 / args.iters
            kernel_ms = sum(v for k, v in kernels.items() if kernel in k) / 1e3 / args.iters
            by_cat = {}
            for k, v in kernels.items():
                by_cat[category(k)] = by_cat.get(category(k), 0.0) + v / 1e3 / args.iters
            top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
            print(json.dumps({
                "model": h.model_name, **variant, "dtype": dtype, "batch": B, "frames": T,
                "wall_ms": wall_ms, "wall_ms_untraced": untraced_ms,
                "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
                "idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else "not measured",
                "idle_share_untraced": (1 - busy_ms / untraced_ms if busy_ms > 0
                                        else "not measured"),
                "kernel": kernel, "kernel_ms": kernel_ms,
                "kernel_share_of_busy": kernel_ms / busy_ms if busy_ms > 0 else "not measured",
                "kernel_launches_per_forward": sum(
                    e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / args.iters,
                "category_ms": by_cat,
                "top_kernels_ms": [[k[:80], category(k), v / 1e3 / args.iters] for k, v in top],
            }), flush=True)
            del eng


if __name__ == "__main__":
    main()
