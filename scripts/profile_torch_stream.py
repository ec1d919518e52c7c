#!/usr/bin/env python3
"""Where the time goes in the port's BSRNN streaming decode on one GPU.

    python3 scripts/profile_torch_stream.py [--model bsrnn|bsrnn_l]

Runs synthesize_streaming_stateful of nvse_tpu_torch (seeded random
BSRNN-M weights, or BSRNN-L's with --model bsrnn_l; 8 streams x 512
frames, chunk 64 frames, lookahead 16)
for the causal and the non-causal config, float32 then bfloat16, under torch.profiler after one
warmup chunk, and prints one JSON line per run: wall ms per chunk,
device-busy ms per chunk (sum of kernel times; one stream, so kernels do
not overlap), the idle share, the ms per chunk of each hand-written LSTM
kernel, the number of kernels the card ran per chunk, and the ten kernels
with the most device time. Then the causal offline decode at B=8 x 1024
frames the same way, per forward. Needs a CUDA GPU.
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
# csrc/lstm_scan.cu and csrc/lstm_fused.cu (H <= 128); csrc/lstm_scan_wide.cu
# (the wide scans) and csrc/lstm_fused_wide.cu (BSRNN-L)
LSTM_KERNELS = ("lstm_scan_kernel", "lstm_fused_kernel", "lstm_scan_wide_kernel",
                "lstm_fused_wide_kernel")


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profiled(fn, units: int) -> dict:
    """Run fn() under the profiler; times are per unit (chunk or forward)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / units
    kernels, calls = {}, 0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
            calls += evt.count
    busy_ms = sum(kernels.values()) / 1e3 / units
    if busy_ms <= 0:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}
    lstm = {name: sum(v for k, v in kernels.items() if name in k) / 1e3 / units
            for name in LSTM_KERNELS}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "lstm_kernel_ms": lstm, "lstm_share_of_busy": sum(lstm.values()) / busy_ms,
            "device_kernels": calls / units,
            "top_kernels_ms": [[k[:80], v / 1e3 / units] for k, v in top]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="bsrnn", choices=("bsrnn", "bsrnn_l"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_stream: needs a CUDA GPU")
    sys.path.insert(0, REPO)
    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.utils import load_config

    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", f"{args.model}_config.json"))
    streams, frames, c, la = 8, 512, 64, 16
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal(
        (streams, h.num_mels, frames)).astype(np.float32) - 4.0)
    chunks = -(-frames // c)

    def engine(causal, dtype):
        hd = type(h)(h)
        hd.update(causal=causal, compute_dtype=dtype)
        return InferenceEngine(hd, device="cuda")

    for causal in (True, False):
        for dtype in ("float32", "bfloat16"):
            eng = engine(causal, dtype)
            eng.synthesize_streaming_stateful(mel[..., :c], chunk_frames=c, lookahead_frames=la)
            out = profiled(lambda: eng.synthesize_streaming_stateful(
                mel, chunk_frames=c, lookahead_frames=la), chunks)
            print(json.dumps({"model": args.model, "path": "stream_stateful", "causal": causal,
                              "dtype": dtype,
                              "streams": streams, "frames": frames, "chunk_frames": c,
                              "lookahead_frames": la, "per": "chunk", **out}), flush=True)
            del eng

    B, T, iters = 8, 1024, 3
    mel2 = torch.from_numpy(rng.standard_normal((B, h.num_mels, T)).astype(np.float32)
                            - 4.0).cuda()
    for dtype in ("float32", "bfloat16"):
        eng = engine(True, dtype)
        eng.forward(mel2)
        out = profiled(lambda: [eng.forward(mel2) for _ in range(iters)], iters)
        print(json.dumps({"model": args.model, "path": "decode_causal", "dtype": dtype,
                          "batch": B, "frames": T,
                          "per": "forward", **out}), flush=True)
        del eng
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)


if __name__ == "__main__":
    main()
