#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (nvse_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits nonzero before
the last line:
  1. build every CUDA kernel of csrc/ from source (one nvcc per source,
     all started together);
  2. hold each kernel against its plain PyTorch version at the shapes of
     its main path, in float32 and bfloat16, and time kernel, plain
     version and the library yardstick (cuDNN's torch.nn.LSTM, which
     the port never calls): the fused inference LSTM at the BSRNN-M
     decode shapes; lstm_fwd_hc, lstm_bwd and the dW_hh reduction at the
     BSRNN-M training shapes (batch 16: 544 rows x 65 steps, 1040 rows x
     34 steps), with cuDNN's BiLSTM forward + backward beside the port's
     and one cuBLAS GEMM beside the dW_hh reduction;
  3. decode B=8 x 1024 mel frames through InferenceEngine with seeded
     random BSRNN-M weights in float32 and bfloat16 (16 kernel launches
     per forward), check the card's output against the CPU's plain path
     on a small input, and print RTF plus the bf16-vs-f32 deviation;
  4. serve the synthetic test set through run_inference;
  5. train: GANTrainer steps at full BSRNN-M width, batch 16 x 16384, in
     float32 and bfloat16 (ms per step, peak memory, losses; finite
     losses, G and D changed, a finite nonzero gradient on all 96 LSTM
     parameters and the encoder, 32 launches per step of each training
     kernel, none of the inference kernel);
  6. one step of a small config on the card against the CPU's plain path
     (losses and AdamW first moments), with a TF32 card step as the
     control that the limits must refuse;
  7. the training CLI's train() for 2 steps with a validation pass on the
     synthetic data, then InferenceEngine decoding from the g_ bundle;
  8. print the kernels line, then the ok line.
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


def _bound(nbytes, ops, dtype):
    """(bound ms, what binds it): the larger of bytes over the memory rate
    and operations over the peak rate of the type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def _bound_ms(R, T, C, H, dtype):
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (R * T * C + 2 * (C * 4 * H + H * 4 * H + 4 * H) + R * T * 2 * H) * item
    ops = 2 * R * T * 2 * (C + H) * 4 * H
    return (*_bound(nbytes, ops, dtype), ops)


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


# BSRNN-M training shapes at batch 16 x 16384 samples (65 frames, 34 bands, H = 128)
TRAIN_SHAPES = (("time", 544, 65), ("band", 1040, 34))
TRAIN_H = 128
# training kernels vs plain, as max abs error over max(1, max |plain|):
# float32 sums in another order; bfloat16 stores hs, cs and dx with 8 bits
# of mantissa and the two may round a value apart. The dW reduction sums
# the same stored values in float32 on both sides and returns float32, so
# it is held at the float32 limit in both dtypes. Its control, which the
# limit must refuse: the plain reduction with the last 256 of its
# (step, row) pairs dropped.
TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
DW_TOL, DW_CONTROL_ROWS = 1e-4, 256
# one training step on the card vs the CPU's plain path, float32: losses at
# a relative error of STEP_RTOL, AdamW first moments at a per-tensor
# relative L2 of MOMENT_REL (floored at 1e-4 of the largest moment); cuFFT,
# cuDNN and cuBLAS sum in other orders. Their control, which both limits
# must refuse: the same card step with TF32 on in matmuls and cuDNN. On the
# H100 the step read 5.3e-7 / 1.6e-4 and the control 3.1e-4 / 6.8e-2; each
# limit sits near the geometric mean of the two.
STEP_RTOL, MOMENT_REL = 1e-5, 3e-3


def _err(got, ref):
    """max |got - ref| and that over max(1, max |ref|)."""
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(1.0, ref.float().abs().max().item())


def _training_counters():
    from nvse_tpu_torch.ops import lstm as L

    return {"lstm_fwd_hc": L.lstm_fwd_hc, "lstm_bwd": L.lstm_bwd,
            "lstm_bwd_dw": L.lstm_dw_hh, "lstm_scan_fused": L.lstm_scan_fused}


def phase_train_kernels():
    """lstm_fwd_hc, the lstm_bwd recurrence and the dW_hh reduction at the
    BSRNN-M training shapes, against their plain versions; cuDNN's BiLSTM
    forward + backward beside the port's."""
    from nvse_tpu_torch.ops import lstm as L

    H, G = TRAIN_H, 4 * TRAIN_H
    rows = []
    for label, R, T in TRAIN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(R + T)
            b = 1.0 / math.sqrt(H)
            xp = (0.5 * torch.randn(T, R, G, generator=g)).to("cuda", dtype)
            whh = torch.empty(H, G).uniform_(-b, b, generator=g).to("cuda", dtype)
            dhs = torch.randn(T, R, H, generator=g).to("cuda", dtype)
            item = xp.element_size()
            ops = 2 * R * T * H * G
            with torch.inference_mode():
                hs, cs = L.lstm_fwd_hc(xp, whh)
                dx = L.lstm_bwd_recurrence(xp, hs, cs, dhs, whh)
                dw = L.lstm_dw_hh(hs, dx)
                torch.cuda.synchronize()
                hs_ref, cs_ref = L.lstm_fwd_hc_plain(xp, whh)
                dx_ref, _ = L.lstm_bwd_plain(xp, hs, cs, dhs, whh)
                dw_ref = L.lstm_dw_hh_plain(hs, dx)
                errs = {"lstm_fwd_hc": max(_err(hs, hs_ref), _err(cs, cs_ref), key=lambda e: e[1]),
                        "lstm_bwd": _err(dx, dx_ref), "lstm_bwd_dw": _err(dw, dw_ref)}
                dx_ctl = dx.clone()
                dx_ctl.view(-1, G)[-DW_CONTROL_ROWS:] = 0
                dw_control = _err(L.lstm_dw_hh_plain(hs, dx_ctl), dw_ref)[1]

                def dw_library():                  # one cuBLAS GEMM, in the input dtype
                    return torch.mm(hs[:-1].reshape(-1, H).T, dx[1:].reshape(-1, G))

                dw_library_err = _err(dw_library(), dw_ref)[1]
                dw_library_ms = cuda_ms(dw_library, iters=10)
                times = {
                    "lstm_fwd_hc": (cuda_ms(lambda: L.lstm_fwd_hc(xp, whh), iters=10),
                                    cuda_ms(lambda: L.lstm_fwd_hc_plain(xp, whh), iters=2)),
                    "lstm_bwd": (cuda_ms(lambda: L.lstm_bwd_recurrence(xp, hs, cs, dhs, whh), iters=10),
                                 cuda_ms(lambda: L.lstm_bwd_plain(xp, hs, cs, dhs, whh), iters=2)),
                    "lstm_bwd_dw": (cuda_ms(lambda: L.lstm_dw_hh(hs, dx), iters=10),
                                    cuda_ms(lambda: L.lstm_dw_hh_plain(hs, dx), iters=2)),
                }
            bounds = {
                "lstm_fwd_hc": _bound((R * T * G + H * G + 2 * R * T * H) * item, ops, dtype),
                "lstm_bwd": _bound((2 * R * T * G + 3 * R * T * H + H * G) * item, 2 * ops, dtype),
                "lstm_bwd_dw": _bound(R * T * (H + G) * item + H * G * 4, ops, dtype),
            }
            flops = {"lstm_fwd_hc": ops, "lstm_bwd": 2 * ops, "lstm_bwd_dw": ops}
            tols = {"lstm_fwd_hc": TRAIN_TOL[dtype], "lstm_bwd": TRAIN_TOL[dtype],
                    "lstm_bwd_dw": DW_TOL}
            for name in ("lstm_fwd_hc", "lstm_bwd", "lstm_bwd_dw"):
                (err, rel), (ms, plain_ms), (bound, bound_by) = errs[name], times[name], bounds[name]
                row = dict(name=name, shape=label, rows=R, steps=T, H=H, dtype=DT_NAME[dtype],
                           max_abs_err=err, rel_err=rel, tol=tols[name], ms=ms,
                           plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by=bound_by,
                           tflops=flops[name] / (ms * 1e-3) / 1e12)
                if name == "lstm_bwd_dw":
                    row.update(library_ms=dw_library_ms, library_rel_err=dw_library_err,
                               control_rel_err=dw_control)
                say(phase="kernel_vs_plain", **row)
                if not (rel <= tols[name]):
                    raise SystemExit(f"{name} {label} {DT_NAME[dtype]}: error {err} "
                                     f"({rel} relative) over tolerance {tols[name]}")
                rows.append(row)
            if not (dw_control > DW_TOL):
                raise SystemExit(f"lstm_bwd_dw {label} {DT_NAME[dtype]}: the control with "
                                 f"{DW_CONTROL_ROWS} pairs dropped ({dw_control}) passes "
                                 f"the tolerance {DW_TOL}")
            say(phase="bilstm_train_vs_cudnn", shape=label, rows=R, steps=T, dtype=DT_NAME[dtype],
                **_bilstm_fwd_bwd_ms(R, T, H, dtype))
    return rows


def _bilstm_fwd_bwd_ms(R, T, H, dtype):
    """One BiLSTM forward + backward at (R, T, C = H): the port's training
    route (torch matmuls + lstm_fwd_hc / lstm_bwd) and cuDNN's LSTM."""
    from nvse_tpu_torch.ops.lstm import lstm_scan_fused

    args = [a.requires_grad_() for a in _lstm_inputs(R, T, H, H, dtype, seed=R)]
    grad = torch.randn(R, T, 2 * H, device="cuda", dtype=dtype)
    lib = _cudnn_lstm([a.detach() for a in args])
    x_lib = args[0].detach().clone().requires_grad_()

    def port():
        lstm_scan_fused(*args).backward(grad)

    def cudnn():
        lib(x_lib)[0].backward(grad)

    return dict(port_ms=cuda_ms(port, iters=5), cudnn_ms=cuda_ms(cudnn, iters=5))


def _bsrnn_config(**kw):
    from nvse_tpu_torch.utils import load_config

    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", "bsrnn_config.json"))
    h.update(kw)
    return h


def _audio_batch(B, n, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = rng.uniform(100, 400, (B, 1))
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal((B, n))
    return torch.from_numpy(x.astype(np.float32))


def phase_train():
    """Full-width BSRNN-M GAN steps, batch 16 x 16384, float32 and bfloat16."""
    from nvse_tpu_torch.train import GANTrainer, fetch_scalars

    B, iters = 16, 3
    counters = _training_counters()
    for c in counters.values():                    # this main path starts here
        c.launches = 0
        c.launches_by_shape = {}
    for dtype in ("float32", "bfloat16"):
        h = _bsrnn_config(compute_dtype=dtype)
        audio = _audio_batch(B, int(h.segment_size), h.sampling_rate, seed=0).to("cuda")
        tr = GANTrainer(h, device="cuda", steps_per_epoch=2)
        before = {n: p.detach().clone() for n, p in
                  [*tr.generator.named_parameters(), *tr.disc.named_parameters()]}
        torch.cuda.reset_peak_memory_stats()
        n0 = {k: c.launches for k, c in counters.items()}
        metrics = tr.step(audio)                   # warmup
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(iters):
            metrics = tr.step(audio)
        torch.cuda.synchronize()
        ms = (time.time() - t0) / iters * 1e3
        per_step = {k: (c.launches - n0[k]) / (iters + 1) for k, c in counters.items()}
        losses = fetch_scalars(metrics)
        after = dict([*tr.generator.named_parameters(), *tr.disc.named_parameters()])
        unchanged = [n for n, p in after.items() if torch.equal(p.detach(), before[n])]
        lstm = {n: p for n, p in tr.generator.named_parameters() if ".lstm." in n}
        bad_grad = [n for n, p in lstm.items()
                    if p.grad is None or not torch.isfinite(p.grad).all() or p.grad.abs().sum() == 0]
        enc = {n: p for n, p in tr.generator.named_parameters() if n.startswith("core.encoder.b_")}
        bad_enc = [n for n, p in enc.items() if p.grad is None or p.grad.abs().sum() == 0]
        say(phase="train", dtype=dtype, batch=B, segment=int(h.segment_size), ms_per_step=ms,
            steps_timed=iters, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches_per_step=per_step, lstm_params=len(lstm), losses=losses)
        fails = []
        if not all(math.isfinite(v) for v in losses.values()):
            fails.append(f"non-finite losses {losses}")
        if unchanged:
            fails.append(f"parameters not updated: {unchanged[:5]} ({len(unchanged)})")
        if len(lstm) != 96 or bad_grad:
            fails.append(f"{len(lstm)} LSTM params, without a finite nonzero grad: {bad_grad[:5]}")
        if not enc or bad_enc:
            fails.append(f"encoder without gradient: {bad_enc}")
        expect = {"lstm_fwd_hc": 32, "lstm_bwd": 32, "lstm_bwd_dw": 32, "lstm_scan_fused": 0}
        if per_step != expect:
            fails.append(f"launches per step {per_step}, expected {expect}")
        if fails:
            raise SystemExit(f"train {dtype}: " + "; ".join(fails))
        del tr, before, after, lstm, enc
        torch.cuda.empty_cache()
    return {k: dict(c.launches_by_shape) for k, c in counters.items()}   # ... and ends here


def _set_tf32(on):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def phase_train_vs_cpu_plain():
    """A small config, one step on the card and one on the CPU's plain path
    from the same seeded weights and batch; and the control: one more card
    step with TF32 on, which both limits must refuse."""
    from nvse_tpu_torch.train import GANTrainer, fetch_scalars

    h = _bsrnn_config(feature_dim=16, num_repeat=2, segment_size=4096, batch_size=2)
    audio = _audio_batch(2, 4096, h.sampling_rate, seed=1)
    out = {}
    for run in ("cuda", "cuda_tf32", "cpu"):
        tr = GANTrainer(h, device="cpu" if run == "cpu" else "cuda", steps_per_epoch=2)
        _set_tf32(run == "cuda_tf32")
        try:
            losses = fetch_scalars(tr.step(audio))
        finally:
            _set_tf32(False)
        moments = {n: tr.opt_g.state[p]["exp_avg"].detach().cpu()
                   for n, p in tr.generator.named_parameters()}
        moments.update({n: tr.opt_d.state[p]["exp_avg"].detach().cpu()
                        for n, p in tr.disc.named_parameters()})
        out[run] = losses, moments
    lc, mc = out["cpu"]
    floor = 1e-4 * max(v.norm().item() for v in mc.values())

    def readings(run):
        lg, mg = out[run]
        loss_rel = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
        mom = {k: (mg[k] - mc[k]).norm().item() / max(mc[k].norm().item(), floor) for k in mc}
        worst = max(mom, key=mom.get)
        return loss_rel, mom[worst], worst

    loss_rel, mom_rel, worst = readings("cuda")
    ctl_loss_rel, ctl_mom_rel, _ = readings("cuda_tf32")
    ok = loss_rel <= STEP_RTOL and mom_rel <= MOMENT_REL
    refused = ctl_loss_rel > STEP_RTOL and ctl_mom_rel > MOMENT_REL
    say(phase="train_vs_cpu_plain", feature_dim=16, num_repeat=2, segment=4096, batch=2,
        worst_loss_rel=loss_rel, loss_rtol=STEP_RTOL, worst_moment_rel=mom_rel,
        worst_moment=worst, moment_rel_tol=MOMENT_REL, tf32_control_loss_rel=ctl_loss_rel,
        tf32_control_moment_rel=ctl_mom_rel, ok=ok, control_refused=refused)
    if not ok:
        raise SystemExit("one training step on the card disagrees with the CPU plain path")
    if not refused:
        raise SystemExit("the TF32 control step passes a limit of the card-vs-CPU comparison")


def phase_train_cli():
    """train(h, device="cuda") for 2 full-width steps with a validation pass on
    the synthetic data, then InferenceEngine decoding from its g_ bundle."""
    from nvse_tpu_torch.infer import run_inference
    from nvse_tpu_torch.train import train

    with tempfile.TemporaryDirectory() as tmp:
        h = _bsrnn_config(checkpoint_path=os.path.join(tmp, "ckpt"), training_steps=1,
                          stdout_interval=1, checkpoint_interval=10 ** 6,
                          validation_interval=10 ** 6, test_output_dir=os.path.join(tmp, "out"))
        lines = []
        t0 = time.time()
        train(h, device="cuda", log_fn=lines.append)
        secs = time.time() - t0
        written = sorted(os.listdir(h.checkpoint_path))
        h.checkpoint_file_load = os.path.join(h.checkpoint_path, "g_00000001")
        served = []
        stats = run_inference(h, limit=1, log_fn=served.append, device="cuda")
    ok = ({"g_00000001", "do_00000001"} <= set(written) and stats["files"] == 1
          and any(l.startswith("step 0 validation:") for l in lines)
          and any("training finished" in l for l in lines))
    say(phase="train_cli", seconds=secs, written=written, log=lines[-4:], serve=served[-1:], ok=ok)
    if not ok:
        raise SystemExit("the training CLI path did not checkpoint, validate and serve")


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
    train_rows = phase_train_kernels()
    main_counts = phase_decode()
    phase_serve()
    train_counts = phase_train()
    phase_train_vs_cpu_plain()
    phase_train_cli()

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
    replaces = {"lstm_fwd_hc": "nvse_tpu/ops/pallas_lstm_bwd.py:181",
                "lstm_bwd": "nvse_tpu/ops/pallas_lstm_bwd.py:339",
                "lstm_bwd_dw": "nvse_tpu/ops/pallas_lstm_bwd.py:339"}
    for r in train_rows:
        key = (r["steps"], r["rows"], r["H"], r["dtype"])
        kernels.append({
            "name": r["name"], "shape": r["shape"], "dtype": r["dtype"], "route": "cuda",
            "source": "nvse_tpu_torch/csrc/lstm_bwd.cu", "replaces": replaces[r["name"]],
            "launches": train_counts[r["name"]].get(key, 0), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    if any(k["launches"] == 0 for k in kernels):
        raise SystemExit(f"a kernel of the main path was never launched: {main_counts} "
                         f"{train_counts}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
