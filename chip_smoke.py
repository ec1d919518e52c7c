#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (nvse_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits nonzero before
the last line:
  1. build every CUDA kernel of csrc/ from source (one nvcc per source);
  2. hold each kernel against its plain PyTorch version at the shapes of
     the BSRNN-M decode, in float32 and bfloat16, and time kernel, plain
     version and the library yardstick (cuDNN's torch.nn.LSTM, which
     the port never calls);
  3. decode B=8 x 1024 mel frames through InferenceEngine with seeded
     random BSRNN-M weights in float32 and bfloat16 (16 kernel launches
     per forward), check the card's output against the CPU's plain path
     on a small input, and print RTF plus the bf16-vs-f32 deviation;
  4. serve the synthetic test set through run_inference;
  5. print the kernels line, then the ok line.
Exits nonzero without output when no CUDA GPU is visible.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# kernel vs plain: float32 sums in another order over up to 1024 dependent
# steps; bfloat16 rounds h to 8 bits each step (ulp 2^-8 below 1), and a
# one-ulp flip moves later steps by a few ulps
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
DT_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
# generator output on the card vs the CPU's plain path, float32 (the tests'
# tolerances for the whole model: rtol 2e-3, atol 2e-4)
MODEL_RTOL, MODEL_ATOL = 2e-3, 2e-4


def say(**kw):
    print(json.dumps(kw), flush=True)


def cuda_ms(fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from nvse_tpu_torch.ops import _build

    t0 = time.time()
    libs = _build.build_all()
    secs = time.time() - t0
    for name in libs:
        ptxas = [l.strip() for l in _build.build_log(name).splitlines()
                 if "registers" in l or "spill" in l]
        say(phase="build", source=f"nvse_tpu_torch/csrc/{name}.cu", ptxas=ptxas)
    say(phase="build", seconds=round(secs, 3), libraries=sorted(libs))


def _lstm_inputs(R, T, C, H, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    b = 1.0 / math.sqrt(H)
    x = torch.randn(R, T, C, generator=g)
    w = [torch.empty(s).uniform_(-b, b, generator=g)
         for s in [(C, 4 * H), (C, 4 * H), (4 * H,), (4 * H,), (H, 4 * H), (H, 4 * H)]]
    return [t.to("cuda", dtype) for t in [x, *w]]


def _cudnn_lstm(args):
    x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b = args
    C, H = x.shape[-1], w_hh_f.shape[0]
    lstm = torch.nn.LSTM(C, H, batch_first=True, bidirectional=True).to("cuda", x.dtype)
    with torch.no_grad():
        for sfx, w_ih, w_hh, b in (("", w_ih_f, w_hh_f, b_f), ("_reverse", w_ih_b, w_hh_b, b_b)):
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(w_ih.T)
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(w_hh.T)
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(b)
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
    lstm.flatten_parameters()   # one cuDNN weight buffer, not a compaction per call
    return lstm


def _bound_ms(R, T, C, H, dtype):
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (R * T * C + 2 * (C * 4 * H + H * 4 * H + 4 * H) + R * T * 2 * H) * item
    ops = 2 * R * T * 2 * (C + H) * 4 * H
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), ops


def phase_kernels():
    """lstm_scan_fused at the time- and band-BiLSTM shapes of BSRNN-M B=8."""
    from nvse_tpu_torch.ops.lstm import lstm_scan_fused, lstm_scan_fused_plain

    C = H = 128
    rows = []
    for label, R, T in (("time", 272, 1024), ("band", 8192, 34)):
        for dtype in (torch.float32, torch.bfloat16):
            args = _lstm_inputs(R, T, C, H, dtype, seed=R + T)
            with torch.inference_mode():
                got = lstm_scan_fused(*args)
                torch.cuda.synchronize()
                ref = lstm_scan_fused_plain(*args)
                err = (got.float() - ref.float()).abs().max().item()
                lib = _cudnn_lstm(args)
                lib_err = (lib(args[0])[0].float() - ref.float()).abs().max().item()
                ms = cuda_ms(lambda: lstm_scan_fused(*args), iters=10)
                plain_ms = cuda_ms(lambda: lstm_scan_fused_plain(*args), iters=2)
                library_ms = cuda_ms(lambda: lib(args[0]), iters=10)
            bound, bound_by, ops = _bound_ms(R, T, C, H, dtype)
            row = dict(name="lstm_scan_fused", shape=label, rows=R, steps=T, C=C, H=H,
                       dtype=DT_NAME[dtype], max_abs_err=err, tol=TOL[dtype],
                       ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       library_max_abs_err=lib_err, bound_ms=bound, bound_by=bound_by,
                       tflops=ops / (ms * 1e-3) / 1e12)
            say(phase="kernel_vs_plain", **row)
            if not (err <= TOL[dtype]):
                raise SystemExit(f"lstm_scan_fused {label} {DT_NAME[dtype]}: max abs err "
                                 f"{err} over tolerance {TOL[dtype]}")
            rows.append(row)
    return rows


def phase_decode():
    """Full-width BSRNN-M decode through the engine, f32 and bf16."""
    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.ops.lstm import lstm_scan_fused
    from nvse_tpu_torch.ops.spectral import mel_spectrogram
    from nvse_tpu_torch.utils import load_config

    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", "bsrnn_config.json"))
    B, T, iters = 8, 1024, 5
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal((B, h.num_mels, T)).astype(np.float32) - 4.0)
    audio_sec = B * (T - 1) * h.hop_size / h.sampling_rate
    per_forward = 2 * int(h.num_repeat)            # time + band BiLSTM per BSNet

    lstm_scan_fused.launches = 0                   # main path starts here
    lstm_scan_fused.launches_by_shape = {}
    wavs = {}
    for dtype in ("float32", "bfloat16"):
        hd = type(h)(h)
        hd["compute_dtype"] = dtype
        eng = InferenceEngine(hd, device="cuda")
        melc = mel.to("cuda")
        n0 = lstm_scan_fused.launches
        wav = eng.forward(melc)                    # warmup
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(iters):
            wav = eng.forward(melc)
        torch.cuda.synchronize()
        wall = (time.time() - t0) / iters
        launches = lstm_scan_fused.launches - n0
        if launches != per_forward * (iters + 1):
            raise SystemExit(f"{dtype} decode: {launches} kernel launches for {iters + 1} "
                             f"forwards, expected {per_forward} per forward")
        if wav.shape != (B, (T - 1) * h.hop_size) or not torch.isfinite(wav).all():
            raise SystemExit(f"{dtype} decode: bad output {tuple(wav.shape)} "
                             f"finite={bool(torch.isfinite(wav).all())}")
        wavs[dtype] = wav
        say(phase="decode", dtype=dtype, batch=B, frames=T, wall_ms=wall * 1e3,
            rtf=audio_sec / wall, launches_per_forward=launches // (iters + 1),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del eng

    w32, wbf = wavs["float32"], wavs["bfloat16"]
    margs = (h.n_fft, h.num_mels, h.sampling_rate, h.hop_size, h.win_size, h.fmin,
             h.sampling_rate / 2)
    mel_l1 = (mel_spectrogram(w32, *margs) - mel_spectrogram(wbf, *margs)).abs().mean().item()
    wav_rel = ((w32 - wbf).norm() / (w32.norm() + 1e-9)).item()
    main_counts = dict(lstm_scan_fused.launches_by_shape)   # main path ends here
    say(phase="decode", bf16_vs_f32_mel_l1=mel_l1, bf16_vs_f32_wav_rel_l2=wav_rel)

    # the card's output against the CPU's plain path, same weights, small input
    small = mel[:2, :, :64]
    cpu = InferenceEngine(h, device="cpu").forward(small)
    gpu = InferenceEngine(h, device="cuda").forward(small).cpu()
    err = (gpu - cpu).abs()
    ok = bool((err <= MODEL_ATOL + MODEL_RTOL * cpu.abs()).all())
    say(phase="decode_vs_cpu_plain", batch=2, frames=64, max_abs_err=err.max().item(),
        rtol=MODEL_RTOL, atol=MODEL_ATOL, ok=ok)
    if not ok:
        raise SystemExit("decode on the card disagrees with the CPU plain path")
    return main_counts


def phase_serve():
    from nvse_tpu_torch.infer import run_inference
    from nvse_tpu_torch.ops.lstm import lstm_scan_fused
    from nvse_tpu_torch.utils import load_config

    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", "bsrnn_config.json"))
    n0 = lstm_scan_fused.launches
    with tempfile.TemporaryDirectory() as out:
        h.test_output_dir = out
        lines = []
        stats = run_inference(h, log_fn=lines.append, device="cuda")
        written = sorted(os.listdir(out))
    if stats["files"] != 6 or len(written) != 6 or lstm_scan_fused.launches == n0:
        raise SystemExit(f"serving: {stats} wrote {written}")
    say(phase="serve", line=lines[-1], files=stats["files"], rtf=stats["rtf"],
        launches=lstm_scan_fused.launches - n0)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        sys.exit(1)
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    from nvse_tpu_torch import resolve_device

    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    say(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    phase_build()
    rows = phase_kernels()
    main_counts = phase_decode()
    phase_serve()

    kernels = []
    for r in rows:
        key = (r["rows"], r["steps"], r["C"], r["H"], r["dtype"])
        kernels.append({
            "name": "lstm_scan_fused", "shape": r["shape"], "dtype": r["dtype"],
            "route": "cuda", "source": "nvse_tpu_torch/csrc/lstm_fused.cu",
            "replaces": "nvse_tpu/ops/pallas_lstm.py:815",
            "also_replaces": "nvse_tpu/ops/pallas_lstm.py:727",
            "launches": main_counts.get(key, 0), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    if any(k["launches"] == 0 for k in kernels):
        raise SystemExit(f"a kernel of the main path was never launched: {main_counts}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
