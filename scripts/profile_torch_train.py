#!/usr/bin/env python3
"""Where the time goes in one GAN training step of the PyTorch port.

    python scripts/profile_torch_train.py [--model bsrnn|bsrnn_l|gcrn|joint|apnet|apnet2|freeV|vocos|
                                                   hifigan|istftnet|convtasnet|hddemucs]

Full-width BSRNN-M (nvse_tpu_torch/configs/bsrnn_config.json, the default),
BSRNN-L (bsrnn_l_config.json), GCRN (gcrn_config.json) or the joint
denoise+vocoder BSRNN_24k (bsrnn_joint_denoise_vocoder_config.json, a
GANTrainer in the joint domain, each task: denoise on the batch plus seeded
noise, vocoder on the batch itself), or one of the conv T-F vocoders
(apnet, apnet2, freeV, vocos: no LSTM kernel) with MPD + MRD, or a time-domain
model with MPD + MSD (hifigan: hifigan_v1_config.json, istftnet: no kernel of
csrc/; convtasnet with fused_tcn 1: the TCN tail and its statistics, 24 each;
hddemucs: hddemucas_config.json, its bottleneck BiLSTM through the training
kernels at H = 768) on one CUDA card, random weights from the config's seed, a seeded synthetic
batch of 16 16384-sample segments (the training shapes of the LSTM kernels:
BSRNN 544 rows x 65 steps and 1040 rows x 34 steps, at H = 128 for BSRNN-M
and 256 for BSRNN-L, GCRN 16 rows x 65 steps at H = 448, HD-Demucs 16 rows at
H = 768). Per compute dtype (float32, bfloat16)
(and task), after two warmup steps and over three steps it prints one JSON line with:
  * wall ms per step (host clock around synchronised steps);
  * ms per step of the three phases of GANTrainer.step, from CUDA events
    with the card idle at each step's start (so host enqueue time counts
    where the card waits for it): generator forward (features + G),
    discriminator update, generator update (G losses against the updated
    D, backward, AdamW);
  * from torch.profiler over the same number of steps: device-busy ms per
    step (sum of kernel times; one stream), the idle share 1 - busy / wall,
    the LSTM training kernels' ms and share of busy, busy ms by kernel
    category, and the top kernels.
The card's name and power limit are printed first. Needs a CUDA GPU.
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
sys.path.insert(0, REPO)

BATCH, STEPS, DTYPES = 16, 3, ("float32", "bfloat16")
# csrc/lstm_scan.cu (mode kFwdHc, the only scan of a training step) and
# csrc/lstm_bwd.cu (H <= 128), csrc/lstm_scan_wide.cu (mode kFwdHc) and
# csrc/lstm_bwd_wide.cu (128 < H <= 768), and the dW_hh reduction of csrc/lstm_bwd.cu
LSTM_KERNELS = ("lstm_scan_kernel", "lstm_bwd_cluster_kernel", "lstm_dw_mma_kernel",
                "lstm_dw_fma_kernel", "lstm_scan_wide_kernel", "lstm_bwd_wide_kernel")


def _batch(B, n, sr, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400, (B, 1)) * t)
    return torch.from_numpy((x + 0.05 * rng.standard_normal((B, n))).astype(np.float32))


# kernel-name markers of each category, tried in order
CATEGORIES = (
    ("lstm training kernels", LSTM_KERNELS),
    ("convolutions (cuDNN)", ("conv", "xmma", "dgrad", "wgrad", "cudnn", "implicit")),
    ("matmuls (cuBLAS)", ("gemm", "cublas", "cutlass")),
    ("FFT (cuFFT)", ("fft",)),
    ("tcn tail kernels", ("tcn_tail", "tcn_gln")),
)


def _kernel_times(prof, steps):
    """{kernel name: ms per step} from the profiler's device events; the
    spans of user annotations (e.g. Optimizer.step) are not kernels and
    would count their kernels twice."""
    out = {}
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and not evt.name.startswith(("Optimizer.", "ProfilerStep"))):
            out[evt.name] = out.get(evt.name, 0.0) + evt.device_time / 1e3 / steps
    return out


def _categories(kernels):
    out = {name: 0.0 for name, _ in CATEGORIES}
    out["elementwise, reductions, copies"] = 0.0
    for n, v in kernels.items():
        low = n.lower()
        cat = next((c for c, marks in CATEGORIES if any(m in low for m in marks)),
                   "elementwise, reductions, copies")
        out[cat] += v
    return out


CONFIGS = {"joint": "bsrnn_joint_denoise_vocoder", "hifigan": "hifigan_v1",
           "hddemucs": "hddemucas"}
# config overrides by model
OVERRIDES = {"convtasnet": {"fused_tcn": 1}}
TASKS = {"joint": ("denoise", "vocoder")}


def profile(model, dtype, task=None):
    from nvse_tpu_torch.train import GANTrainer
    from nvse_tpu_torch.utils import load_config

    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs",
                                 f"{CONFIGS.get(model, model)}_config.json"))
    h.update(OVERRIDES.get(model, {}), compute_dtype=dtype)
    torch.cuda.reset_peak_memory_stats()            # this dtype's peak, not the run's
    tr = GANTrainer(h, device="cuda", steps_per_epoch=2, joint=task is not None)
    audio = _batch(BATCH, int(h.segment_size), h.sampling_rate).cuda()
    # the step's arguments: the batch; joint, the clean batch, the input wave and the task
    args = (audio,)
    if task is not None:
        noise = 0.1 * _batch(BATCH, int(h.segment_size), h.sampling_rate, seed=1).cuda()
        args = (audio, audio + noise if task == "denoise" else audio, task)
    for _ in range(2):
        tr.step(*args)
    torch.cuda.synchronize()

    t0 = time.time()
    for _ in range(STEPS):
        tr.step(*args)
    torch.cuda.synchronize()
    wall = (time.time() - t0) / STEPS * 1e3

    phases = {"generator_forward": 0.0, "discriminator_update": 0.0, "generator_update": 0.0}
    for _ in range(STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        fwd = tr.generator_forward(*args)
        ev[1].record()
        tr.discriminator_update(fwd)
        ev[2].record()
        tr.generator_update(fwd)
        ev[3].record()
        torch.cuda.synchronize()
        for i, k in enumerate(phases):
            phases[k] += ev[i].elapsed_time(ev[i + 1]) / STEPS
        del fwd

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            tr.step(*args)
        torch.cuda.synchronize()
    kernels = _kernel_times(prof, STEPS)
    busy = sum(kernels.values())
    lstm = {k: sum(v for n, v in kernels.items() if k in n) for k in LSTM_KERNELS
            if any(k in n for n in kernels)}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {
        "model": model, "dtype": dtype, "task": task, "batch": BATCH, "segment": int(h.segment_size), "steps": STEPS,
        "wall_ms_per_step": wall, "phase_ms_per_step": phases,
        "device_busy_ms_per_step": busy if kernels else "not measured",
        "idle_share": (1.0 - busy / wall) if kernels else "not measured",
        "lstm_kernel_ms_per_step": lstm,
        "lstm_share_of_busy": (sum(lstm.values()) / busy) if busy else "not measured",
        "busy_ms_per_step_by_category": _categories(kernels),
        "top_kernels_ms_per_step": [[n[:120], v] for n, v in top],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="bsrnn", choices=("bsrnn", "bsrnn_l", "gcrn", "joint",
                                                         "apnet", "apnet2", "freeV", "vocos",
                                                         "hifigan", "istftnet", "convtasnet",
                                                         "hddemucs"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA GPU")
    from nvse_tpu_torch import resolve_device

    resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for dtype in DTYPES:
        for task in TASKS.get(args.model, (None,)):
            print(json.dumps(profile(args.model, dtype, task)), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
