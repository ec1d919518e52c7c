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
     decode shapes and at the band shapes of a streaming chunk (640 rows
     x 34 steps for 8 streams, 80 for one) and of a context-recompute
     window (96); lstm_fwd_hc, lstm_bwd and the dW_hh reduction at the
     BSRNN-M training shapes (batch 16: 544 rows x 65 steps, 1040 rows x
     34 steps), with cuDNN's BiLSTM forward + backward beside the port's,
     and at GCRN's (16 rows x 65 steps, H = 448: the wide kernels of
     csrc/lstm_wide.cu), with one cuBLAS GEMM beside the dW_hh reduction; lstm_scan at the
     causal decode and context-recompute window shapes (272 rows x 1024
     steps, 34 x 96) and lstm_scan_stateful at the streaming chunk shapes
     (272 x 80 for 8 streams, 34 x 80 for one; seeded nonzero state; hs
     and cs), with cuDNN's unidirectional LSTM forward (projection
     included) beside them and, as the control the limit must refuse,
     the stateful kernel fed zeros in place of its initial state; a
     cuDNN call that compacts its weights at every call fails the run;
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
  7. the training CLI (its main(), in this process) for 2 steps with a
     validation pass on the synthetic data, then run_inference decoding
     from the g_ bundle it wrote;
  8. stream, at full BSRNN-M width in float32 and bfloat16: 8 streams x 512
     frames through synthesize_streaming_stateful (chunk 64, lookahead
     16) on the causal config (8 lstm_scan_stateful + 8 fused launches
     per chunk, none of lstm_scan; in float32 equal to the card's offline
     decode with and without lookahead) and on the non-causal one (16 +
     8), per-chunk latency (a clock on the engine's own per-chunk step)
     and streams x real time; the causal offline
     decode at B=8 x 1024 (8 lstm_scan + 8 fused launches per forward)
     and against the CPU's plain path on a small input; run_inference
     with stream=True in both stream modes;
  9. causal training: GANTrainer steps of the causal config at batch 16 x
     16384 in float32 (a finite nonzero gradient on all 72 LSTM
     parameters, 24 launches per step of each training kernel, none of
     an inference kernel);
 10. lstm_scan_bidir2 (two scans in one cooperative launch, the hidden
     units spread over the card) against its plain version at the GCRN
     shapes (decode: 1024 steps x 8 rows x H = 448; serving the synthetic
     set: 128 x 8 x 448) and at one H <= 128 shape, in float32 and
     bfloat16, with two cuDNN unidirectional LSTM forwards beside it and,
     as the control the limit must refuse, the two W_hh swapped;
 11. GCRN at its full (only) width through InferenceEngine: decode B=8 x
     1024 frames in float32 and bfloat16 (2 lstm_scan_bidir2 launches per
     forward, none of any other LSTM kernel), run_inference on the
     synthetic set, and the card's decode against the CPU's plain path
     on a small input;
 12. the gradient route of lstm_scan_bidir2 on the card (2 lstm_fwd_hc + 2
     lstm_bwd + 2 dW, none of the inference kernel) against the CPU's
     plain autograd at 65 steps x 16 rows, H = 128 and GCRN's H = 448 (the
     wide kernels of csrc/lstm_wide.cu), with the two W_hh swapped as the
     control the limit must refuse;
 13. GCRN training (gcrn_train): GANTrainer steps at its full width, batch
     16 x 16384, in float32 and bfloat16 (ms per step, peak memory; a
     finite nonzero gradient on all 12 GLSTM LSTM parameters, 4 launches
     per step of each training kernel at 65 x 16 x 448, none of an
     inference kernel); one GCRN step at batch 2 x 4096 on the card
     against the CPU's plain path at the limits of phase 6, TF32 as the
     control (gcrn_train_vs_cpu_plain); the training CLI with the GCRN
     config for 2 steps, then serving its g_ bundle (gcrn_train_cli);
 14. print the kernels line, then the ok line.
Exits nonzero without output when no CUDA GPU is visible.
"""
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

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


def _cudnn_lstm(directions, dtype, **kw):
    """torch.nn.LSTM on the card holding the given (w_ih, w_hh, b) of each
    direction, its weights laid out as one cuDNN buffer. Build it outside
    inference mode. nn.LSTM.flatten_parameters lays out float32 but skips
    bfloat16 (torch.backends.cudnn.is_acceptable does not list the type),
    and cuDNN then compacts the weights at every call: so this calls the op
    that flatten_parameters wraps."""
    import torch.backends.cudnn.rnn as cudnn_rnn

    (w_ih, w_hh, _), *rest = directions
    lstm = torch.nn.LSTM(w_ih.shape[0], w_hh.shape[0], bidirectional=bool(rest),
                         device="cuda", dtype=dtype, **kw)
    with torch.no_grad():
        for sfx, (w_ih, w_hh, b) in zip(("", "_reverse"), directions):
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(w_ih.T)
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(w_hh.T)
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(b)
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
        torch._cudnn_rnn_flatten_weight(
            lstm._flat_weights, 4, lstm.input_size, cudnn_rnn.get_cudnn_mode(lstm.mode),
            lstm.hidden_size, lstm.proj_size, lstm.num_layers, lstm.batch_first,
            bool(lstm.bidirectional))
    return lstm


def _cudnn_bilstm(args):
    x, w_ih_f, w_ih_b, b_f, b_b, w_hh_f, w_hh_b = args
    return _cudnn_lstm([(w_ih_f, w_hh_f, b_f), (w_ih_b, w_hh_b, b_b)], x.dtype,
                       batch_first=True)


@contextlib.contextmanager
def _no_weight_compaction():
    """Fails the run if a cuDNN LSTM call inside warns that its weights are
    compacted at every call: the library's time would include the copy."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        yield
    if any("contiguous chunk" in str(w.message) for w in caught):
        raise SystemExit("the cuDNN yardstick compacts its weights at every call")


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


# lstm_scan_fused (C = H = 128) as (label, rows, steps)
FUSED_SHAPES = (("time", 272, 1024), ("band", 8192, 34), ("band_chunk", 640, 34),
                ("band_chunk1", 80, 34), ("band_window", 96, 34))


def phase_kernels():
    """lstm_scan_fused at every shape the driven paths give it: the time and
    band BiLSTMs of a BSRNN-M decode at B=8 x 1024, and the band BiLSTM of a
    streaming chunk of 8 streams (8 x 80 frames), of one stream (80) and of
    one context-recompute window (96)."""
    from nvse_tpu_torch.ops.lstm import lstm_scan_fused, lstm_scan_fused_plain

    C = H = 128
    rows = []
    for label, R, T in FUSED_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            args = _lstm_inputs(R, T, C, H, dtype, seed=R + T)
            lib = _cudnn_bilstm(args)
            with torch.inference_mode(), _no_weight_compaction():
                got = lstm_scan_fused(*args)
                torch.cuda.synchronize()
                ref = lstm_scan_fused_plain(*args)
                err = (got.float() - ref.float()).abs().max().item()
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


# training shapes at batch 16 x 16384 samples (65 frames) as (label, rows, steps, H):
# BSRNN-M's time and band BiLSTMs (34 bands, H = 128, csrc/lstm_bwd.cu) and GCRN's
# group LSTMs (H = 448, the wide kernels of csrc/lstm_wide.cu)
TRAIN_SHAPES = (("time", 544, 65, 128), ("band", 1040, 34, 128), ("gcrn", 16, 65, 448))
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
            "lstm_bwd_dw": L.lstm_dw_hh, "lstm_scan_fused": L.lstm_scan_fused,
            "lstm_scan": L.lstm_scan, "lstm_scan_stateful": L.lstm_scan_stateful}


def _launched(counters, fn):
    """fn() and the launches of each counter that it made."""
    n0 = {k: c.launches for k, c in counters.items()}
    out = fn()
    return out, {k: c.launches - n0[k] for k, c in counters.items()}


def _all_counters():
    from nvse_tpu_torch.ops import lstm as L

    return {**_training_counters(), "lstm_scan_bidir2": L.lstm_scan_bidir2}


def phase_train_kernels():
    """lstm_fwd_hc, the lstm_bwd recurrence and the dW_hh reduction at the
    BSRNN-M and GCRN training shapes, against their plain versions; at
    BSRNN-M's, cuDNN's BiLSTM forward + backward beside the port's."""
    from nvse_tpu_torch.ops import lstm as L

    rows = []
    for label, R, T, H in TRAIN_SHAPES:
        G = 4 * H
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
                           source=_train_source(name, H),
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
            if H == TRAIN_H:
                say(phase="bilstm_train_vs_cudnn", shape=label, rows=R, steps=T,
                    dtype=DT_NAME[dtype], **_bilstm_fwd_bwd_ms(R, T, H, dtype))
    return rows


def _train_source(name, H):
    """The source of the training kernel that `name` launches at H."""
    from nvse_tpu_torch.ops.lstm import _MAX_H

    wide = H > _MAX_H and name != "lstm_bwd_dw"        # the dW reduction is tiled: any H
    return f"nvse_tpu_torch/csrc/{'lstm_wide' if wide else 'lstm_bwd'}.cu"


# lstm_scan / lstm_scan_stateful at the shapes of their paths (H = 128): the
# causal time LSTM of a B=8 x 1024 decode, of one context-recompute window of
# one file (64 + 2 x 16 frames), and of a streaming chunk (64 + 16) of 8 streams
# and of one
SCAN_SHAPES = (("lstm_scan", "decode", 272, 1024), ("lstm_scan", "window", 34, 96),
               ("lstm_scan_stateful", "chunk", 272, 80),
               ("lstm_scan_stateful", "chunk1", 34, 80))


def phase_scan_kernels():
    """lstm_scan and lstm_scan_stateful against their plain versions, with
    cuDNN's unidirectional LSTM forward on the same x, weights and state
    (it also does the projection x @ W_ih + b, which the port leaves to a
    torch matmul) as the library yardstick."""
    from nvse_tpu_torch.ops import lstm as L

    C = H = TRAIN_H
    G = 4 * H
    rows = []
    for name, label, R, T in SCAN_SHAPES:
        stateful = name == "lstm_scan_stateful"
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(R + T)
            b = 1.0 / math.sqrt(H)
            x = torch.randn(T, R, C, generator=g).to("cuda", dtype)
            w_ih, bias, whh = (torch.empty(sh).uniform_(-b, b, generator=g).to("cuda", dtype)
                               for sh in ((C, G), (G,), (H, G)))
            h0, c0 = ((0.3 * torch.randn(R, H, generator=g)).to("cuda", dtype) for _ in range(2))
            lib_state = (h0[None], c0[None]) if stateful else None
            item = x.element_size()
            ops = 2 * R * T * H * G
            nbytes = (R * T * (G + H) + H * G) * item
            lib = _cudnn_lstm([(w_ih, whh, bias)], dtype)        # time-major, one direction
            with torch.inference_mode(), _no_weight_compaction():
                xp = (x @ w_ih + bias).contiguous()
                if stateful:
                    nbytes += (R * T * H + 2 * R * H) * item
                    run = lambda: L.lstm_scan_stateful(xp, whh, h0, c0)
                    plain = lambda: L.lstm_scan_stateful_plain(xp, whh, h0, c0)
                else:
                    run = lambda: (L.lstm_scan(xp, whh),)
                    plain = lambda: (L.lstm_scan_plain(xp, whh),)
                got = run()
                torch.cuda.synchronize()
                ref = plain()
                err = max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref))
                lib_err = (lib(x, lib_state)[0].float() - ref[0].float()).abs().max().item()
                ms = cuda_ms(run, iters=10)
                plain_ms = cuda_ms(plain, iters=2)
                library_ms = cuda_ms(lambda: lib(x, lib_state), iters=10)
                control = None
                if stateful:      # zeros in place of (h0, c0): the limit must refuse it
                    z = torch.zeros_like(h0)
                    ctl = L.lstm_scan_stateful(xp, whh, z, z)
                    control = max((a.float() - r.float()).abs().max().item()
                                  for a, r in zip(ctl, ref))
            bound, bound_by = _bound(nbytes, ops, dtype)
            row = dict(name=name, shape=label, rows=R, steps=T, H=H, dtype=DT_NAME[dtype],
                       max_abs_err=err, tol=TOL[dtype], ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, library="cuDNN LSTM forward, projection included",
                       library_max_abs_err=lib_err, bound_ms=bound, bound_by=bound_by,
                       tflops=ops / (ms * 1e-3) / 1e12)
            if stateful:
                row["control_max_abs_err"] = control
            say(phase="kernel_vs_plain", **row)
            if not (err <= TOL[dtype]):
                raise SystemExit(f"{name} {label} {DT_NAME[dtype]}: max abs err {err} over "
                                 f"tolerance {TOL[dtype]}")
            if stateful and not (control > TOL[dtype]):
                raise SystemExit(f"{name} {label} {DT_NAME[dtype]}: the control with a zero "
                                 f"initial state ({control}) passes the tolerance {TOL[dtype]}")
            rows.append(row)
    return rows



def _bilstm_fwd_bwd_ms(R, T, H, dtype):
    """One BiLSTM forward + backward at (R, T, C = H): the port's training
    route (torch matmuls + lstm_fwd_hc / lstm_bwd) and cuDNN's LSTM."""
    from nvse_tpu_torch.ops.lstm import lstm_scan_fused

    args = [a.requires_grad_() for a in _lstm_inputs(R, T, H, H, dtype, seed=R)]
    grad = torch.randn(R, T, 2 * H, device="cuda", dtype=dtype)
    lib = _cudnn_bilstm([a.detach() for a in args])
    x_lib = args[0].detach().clone().requires_grad_()

    def port():
        lstm_scan_fused(*args).backward(grad)

    def cudnn():
        lib(x_lib)[0].backward(grad)

    with _no_weight_compaction():
        return dict(port_ms=cuda_ms(port, iters=5), cudnn_ms=cuda_ms(cudnn, iters=5))


def _config(name, **kw):
    """The port's copy of a reference config (bsrnn, gcrn) with overrides."""
    from nvse_tpu_torch.utils import load_config

    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", f"{name}_config.json"))
    h.update(kw)
    return h


def _bsrnn_config(**kw):
    return _config("bsrnn", **kw)


def _audio_batch(B, n, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = rng.uniform(100, 400, (B, 1))
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal((B, n))
    return torch.from_numpy(x.astype(np.float32))


def phase_train(model="bsrnn", causal=False):
    """Full-width GAN steps, batch 16 x 16384: BSRNN-M's non-causal config in
    float32 and bfloat16, its causal one (the time LSTM one direction,
    through lstm_scan's residual-saving route) in float32; GCRN (its four
    group LSTMs through lstm_scan_bidir2's residual-saving route, the wide
    training kernels at 65 steps x 16 rows x H = 448) in float32 and
    bfloat16."""
    from nvse_tpu_torch.train import GANTrainer, fetch_scalars

    B, iters = 16, 3
    # LSTM launches per step of each training kernel, and the LSTM
    # parameters (3 tensors per direction): BSRNN-M, 8 blocks x (time +
    # band) x directions; GCRN, 2 layers x 2 groups, one direction each
    if model == "gcrn":
        n_lstm, is_lstm = 4, (lambda n: n.startswith("glstm.lstms."))
    else:
        n_lstm, is_lstm = 8 * (1 + 2) if causal else 8 * (2 + 2), (lambda n: ".lstm." in n)
    counters = _all_counters()
    for c in counters.values():                    # this main path starts here
        c.launches = 0
        c.launches_by_shape = {}
    for dtype in ("float32",) if causal else ("float32", "bfloat16"):
        h = _config(model, compute_dtype=dtype, causal=causal)
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
        lstm = {n: p for n, p in tr.generator.named_parameters() if is_lstm(n)}
        bad_grad = [n for n, p in lstm.items()
                    if p.grad is None or not torch.isfinite(p.grad).all() or p.grad.abs().sum() == 0]
        say(phase="train" if model == "bsrnn" else f"{model}_train", causal=causal, dtype=dtype,
            batch=B, segment=int(h.segment_size), ms_per_step=ms, steps_timed=iters,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches_per_step=per_step,
            launches_per_step_by_shape={k: {str(sh): n / (iters + 1) for sh, n in
                                            c.launches_by_shape.items() if sh[-1] == dtype}
                                        for k, c in counters.items() if c.launches_by_shape},
            lstm_params=len(lstm), losses=losses)
        fails = []
        if not all(math.isfinite(v) for v in losses.values()):
            fails.append(f"non-finite losses {losses}")
        if unchanged:
            fails.append(f"parameters not updated: {unchanged[:5]} ({len(unchanged)})")
        if len(lstm) != 3 * n_lstm or bad_grad:
            fails.append(f"{len(lstm)} LSTM params, without a finite nonzero grad: {bad_grad[:5]}")
        if model == "bsrnn":
            enc = {n: p for n, p in tr.generator.named_parameters()
                   if n.startswith("core.encoder.b_")}
            bad_enc = [n for n, p in enc.items() if p.grad is None or p.grad.abs().sum() == 0]
            if not enc or bad_enc:
                fails.append(f"encoder without gradient: {bad_enc}")
        expect = {k: 0 for k in counters}              # no inference kernel inside a step
        expect.update(lstm_fwd_hc=n_lstm, lstm_bwd=n_lstm, lstm_bwd_dw=n_lstm)
        if per_step != expect:
            fails.append(f"launches per step {per_step}, expected {expect}")
        if fails:
            raise SystemExit(f"train {model} causal={causal} {dtype}: " + "; ".join(fails))
        del tr, before, after, lstm
        torch.cuda.empty_cache()
    return {k: dict(c.launches_by_shape) for k, c in counters.items()}   # ... and ends here


def _set_tf32(on):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


# the small step of phase_train_vs_cpu_plain: BSRNN-M narrowed; GCRN has no
# width knobs and runs at its full width (the wide training kernels at 17
# steps x 2 rows x H = 448), both at batch 2 x 4096 samples
SMALL_STEP = {"bsrnn": dict(feature_dim=16, num_repeat=2), "gcrn": {}}


def phase_train_vs_cpu_plain(model="bsrnn"):
    """A small config, one step on the card and one on the CPU's plain path
    from the same seeded weights and batch; and the control: one more card
    step with TF32 on, which both limits must refuse."""
    from nvse_tpu_torch.train import GANTrainer, fetch_scalars

    h = _config(model, segment_size=4096, batch_size=2, **SMALL_STEP[model])
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
    say(phase="train_vs_cpu_plain" if model == "bsrnn" else f"{model}_train_vs_cpu_plain",
        **SMALL_STEP[model], segment=4096, batch=2,
        worst_loss_rel=loss_rel, loss_rtol=STEP_RTOL, worst_moment_rel=mom_rel,
        worst_moment=worst, moment_rel_tol=MOMENT_REL, tf32_control_loss_rel=ctl_loss_rel,
        tf32_control_moment_rel=ctl_mom_rel, ok=ok, control_refused=refused)
    if not ok:
        raise SystemExit(f"one {model} training step on the card disagrees with the CPU plain path")
    if not refused:
        raise SystemExit(f"the {model} TF32 control step passes a limit of the card-vs-CPU "
                         "comparison")


def phase_train_cli(model="bsrnn"):
    """The training CLI (python -m nvse_tpu_torch.train --cfg_filename, its
    main() run in this process) on a copy of the model's config for 2
    full-width steps with a validation pass on the synthetic data, then
    run_inference decoding from the g_ bundle it wrote."""
    from nvse_tpu_torch.infer import run_inference
    from nvse_tpu_torch.train.__main__ import main as train_cli

    with tempfile.TemporaryDirectory() as tmp:
        h = _config(model, checkpoint_path=os.path.join(tmp, "ckpt"), training_steps=1,
                    stdout_interval=1, checkpoint_interval=10 ** 6,
                    validation_interval=10 ** 6, test_output_dir=os.path.join(tmp, "out"))
        cfg = os.path.join(tmp, "config.json")
        with open(cfg, "w") as f:
            json.dump(h, f)
        argv, sys.argv = sys.argv, ["nvse_tpu_torch.train", "--cfg_filename", cfg]
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(io.StringIO()) as log:
                train_cli()
        finally:
            sys.argv = argv
        secs = time.time() - t0
        lines = log.getvalue().splitlines()
        written = sorted(os.listdir(h.checkpoint_path))
        h.checkpoint_file_load = os.path.join(h.checkpoint_path, "g_00000001")
        served = []
        stats = run_inference(h, limit=1, log_fn=served.append, device="cuda")
    ok = ({"g_00000001", "do_00000001"} <= set(written) and stats["files"] == 1
          and any(l.startswith("step 0 validation:") for l in lines)
          and any("training finished" in l for l in lines))
    say(phase="train_cli" if model == "bsrnn" else f"{model}_train_cli", seconds=secs,
        written=written, log=lines[-4:], serve=served[-1:], ok=ok)
    if not ok:
        raise SystemExit(f"the {model} training CLI path did not checkpoint, validate and serve")


# state-carrying streaming of a causal config against the card's own offline
# decode, float32: max |diff| / max |offline| (the JAX package's test limit;
# the two differ only in float order); of a non-causal config: the mean
# |diff| / mean |offline| away from the edges, bounded by the lookahead
STREAM_EXACT_REL, STREAM_NONCAUSAL_REL = 1e-4, 0.15


@contextlib.contextmanager
def _chunk_clock(eng):
    """Puts a clock on the engine's per-chunk step while the caller runs a
    streaming entry point: yields a list that receives the host time at
    which each chunk's step is entered, the card idle. The time from one
    entry to the next is one chunk as a user waits for it: the step on the
    card, the frames' copy to the host and the overlap-add."""
    stamps, step = [], eng._stream_step

    def clocked(*args, **kw):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return step(*args, **kw)

    eng._stream_step = clocked
    try:
        yield stamps
    finally:
        del eng._stream_step


def phase_stream():
    """Streaming and causal decode at full BSRNN-M width, f32 and bf16."""
    from nvse_tpu_torch.infer import InferenceEngine, run_inference
    from nvse_tpu_torch.ops import lstm as L

    counters = {"lstm_scan": L.lstm_scan, "lstm_scan_stateful": L.lstm_scan_stateful,
                "lstm_scan_fused": L.lstm_scan_fused}
    for c in counters.values():                    # this main path starts here
        c.launches = 0
        c.launches_by_shape = {}

    B, T, c, la = 8, 512, 64, 16
    n_chunks = T // c
    rng = np.random.default_rng(1)
    base = _bsrnn_config()
    mel = torch.from_numpy(rng.standard_normal((B, base.num_mels, T)).astype(np.float32) - 4.0)
    out_len = (T - 1) * base.hop_size
    chunk_audio_sec = B * c * base.hop_size / base.sampling_rate

    # 8 concurrent streams through synthesize_streaming_stateful
    for causal, per_chunk in ((True, 8), (False, 16)):
        for dtype in ("float32", "bfloat16"):
            eng = InferenceEngine(_bsrnn_config(causal=causal, compute_dtype=dtype), device="cuda")
            eng.synthesize_streaming_stateful(mel[..., :c], chunk_frames=c, lookahead_frames=la)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _chunk_clock(eng) as stamps:
                wav, counts = _launched(counters, lambda: eng.synthesize_streaming_stateful(
                    mel, out_len=out_len, chunk_frames=c, lookahead_frames=la))
                stamps.append(time.perf_counter())    # the last chunk ends with the flush
            wall = stamps[-1] - t0
            ms = sorted(np.diff(stamps) * 1e3)
            expect = {"lstm_scan": 0, "lstm_scan_stateful": per_chunk * n_chunks,
                      "lstm_scan_fused": 8 * n_chunks}
            offline = eng.synthesize_mel(mel, out_len=out_len)
            rel_max = float(np.abs(wav - offline).max() / (np.abs(offline).max() + 1e-9))
            sl = slice(la * base.hop_size, out_len - la * base.hop_size)
            rel_mean = float(np.abs(wav[:, sl] - offline[:, sl]).mean()
                             / (np.abs(offline[:, sl]).mean() + 1e-9))
            line = dict(phase="stream", causal=causal, dtype=dtype, streams=B, frames=T,
                        chunk_frames=c, lookahead_frames=la, chunks=n_chunks,
                        launches_per_chunk={k: v / n_chunks for k, v in counts.items()},
                        wall_ms_per_chunk_mean=wall * 1e3 / n_chunks,
                        streams_x_realtime=B * out_len / base.sampling_rate / wall,
                        vs_offline_rel_max=rel_max, vs_offline_interior_rel_mean=rel_mean)
            fails = []
            if counts != expect:
                fails.append(f"launches {counts}, expected {expect}")
            if wav.shape != (B, out_len) or not np.isfinite(wav).all():
                fails.append(f"bad output {wav.shape}")
            if causal and dtype == "float32":
                wav0 = eng.synthesize_streaming_stateful(mel, out_len=out_len, chunk_frames=c,
                                                         lookahead_frames=0)
                rel0 = float(np.abs(wav0 - offline).max() / (np.abs(offline).max() + 1e-9))
                line.update(vs_offline_rel_max_no_lookahead=rel0, rel_max_tol=STREAM_EXACT_REL)
                if not (rel_max < STREAM_EXACT_REL and rel0 < STREAM_EXACT_REL):
                    fails.append(f"streaming differs from the offline decode: {rel_max} with, "
                                 f"{rel0} without lookahead, limit {STREAM_EXACT_REL}")
            if not causal:
                line.update(interior_rel_mean_tol=STREAM_NONCAUSAL_REL)
                if dtype == "float32" and not (rel_mean < STREAM_NONCAUSAL_REL):
                    fails.append(f"interior error {rel_mean} over {STREAM_NONCAUSAL_REL}")
            line.update(wall_ms_per_chunk_p50=ms[len(ms) // 2], wall_ms_per_chunk_max=ms[-1],
                        streams_x_realtime_p50=chunk_audio_sec / (ms[len(ms) // 2] * 1e-3))
            say(**line)
            if fails:
                raise SystemExit(f"stream causal={causal} {dtype}: " + "; ".join(fails))
            del eng

    # causal offline decode, B = 8 x 1024
    B2, T2, iters = 8, 1024, 5
    mel2 = torch.from_numpy(rng.standard_normal((B2, base.num_mels, T2)).astype(np.float32)
                            - 4.0).to("cuda")
    audio_sec = B2 * (T2 - 1) * base.hop_size / base.sampling_rate
    for dtype in ("float32", "bfloat16"):
        eng = InferenceEngine(_bsrnn_config(causal=True, compute_dtype=dtype), device="cuda")
        eng.forward(mel2)                          # warmup
        torch.cuda.synchronize()
        t0 = time.time()
        wav, counts = _launched(counters, lambda: [eng.forward(mel2) for _ in range(iters)][-1])
        torch.cuda.synchronize()
        wall = (time.time() - t0) / iters
        say(phase="decode_causal", dtype=dtype, batch=B2, frames=T2, wall_ms=wall * 1e3,
            rtf=audio_sec / wall, launches_per_forward={k: v / iters for k, v in counts.items()})
        if counts != {"lstm_scan": 8 * iters, "lstm_scan_stateful": 0, "lstm_scan_fused": 8 * iters}:
            raise SystemExit(f"causal decode {dtype}: launches {counts} for {iters} forwards")
        if wav.shape != (B2, (T2 - 1) * base.hop_size) or not torch.isfinite(wav).all():
            raise SystemExit(f"causal decode {dtype}: bad output {tuple(wav.shape)}")
        del eng

    # run_inference(stream=True) on the synthetic set, both stream modes
    for dtype in ("float32", "bfloat16"):
        for mode in ("recompute", "stateful"):
            with tempfile.TemporaryDirectory() as out:
                h = _bsrnn_config(causal=True, compute_dtype=dtype, stream_mode=mode,
                                  test_output_dir=out)
                lines = []
                stats, counts = _launched(counters, lambda: run_inference(
                    h, stream=True, device="cuda", log_fn=lines.append))
                written = sorted(os.listdir(out))
            say(phase="serve_stream", dtype=dtype, stream_mode=mode, line=lines[-1],
                files=stats["files"], rtf=stats["rtf"], launches=counts)
            used = counts["lstm_scan_stateful" if mode == "stateful" else "lstm_scan"]
            if stats["files"] != 6 or len(written) != 6 or used == 0:
                raise SystemExit(f"streaming serve {dtype} {mode}: {stats} wrote {written}, "
                                 f"launches {counts}")
    main_counts = {k: dict(c.launches_by_shape) for k, c in counters.items()}   # ... and ends here

    # the card's causal decode against the CPU's plain path, same weights, small input
    h = _bsrnn_config(causal=True)
    small = mel[:2, :, :64]
    cpu = InferenceEngine(h, device="cpu").forward(small)
    gpu = InferenceEngine(h, device="cuda").forward(small).cpu()
    err = (gpu - cpu).abs()
    ok = bool((err <= MODEL_ATOL + MODEL_RTOL * cpu.abs()).all())
    say(phase="decode_causal_vs_cpu_plain", batch=2, frames=64, max_abs_err=err.max().item(),
        rtol=MODEL_RTOL, atol=MODEL_ATOL, ok=ok)
    if not ok:
        raise SystemExit("causal decode on the card disagrees with the CPU plain path")
    return main_counts


# lstm_scan_bidir2 as (label, steps, rows, H): GCRN's grouped LSTM at the
# B=8 x 1024 decode and at the serving shape of the synthetic set (6 files of
# 82 frames in one batch of 8 at the 128-frame bucket), and one shape the
# H <= 128 kernels also take
BIDIR2_SHAPES = (("decode", 1024, 8, 448), ("serve", 128, 8, 448), ("small", 65, 16, 128))


def phase_bidir2_kernels():
    """lstm_scan_bidir2 against its plain version; the library yardstick is
    two cuDNN unidirectional LSTM forwards (input H, hidden H) on the x that
    the port projects outside its kernel; the control, which the limit must
    refuse, is the kernel with its two W_hh swapped."""
    from nvse_tpu_torch.ops import lstm as L

    rows = []
    for label, T, R, H in BIDIR2_SHAPES:
        G = 4 * H
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(T + R + H)
            b = 1.0 / math.sqrt(H)
            xs = [torch.randn(T, R, H, generator=g).to("cuda", dtype) for _ in range(2)]
            w_ih, bias, whh = ([torch.empty(sh).uniform_(-b, b, generator=g).to("cuda", dtype)
                                for _ in range(2)] for sh in ((H, G), (G,), (H, G)))
            libs = [_cudnn_lstm([(w_ih[i], whh[i], bias[i])], dtype) for i in range(2)]
            item = xs[0].element_size()
            ops = 2 * 2 * R * T * H * G
            nbytes = 2 * (R * T * (G + H) + H * G) * item
            with torch.inference_mode(), _no_weight_compaction():
                xp = [(xs[i] @ w_ih[i] + bias[i]).contiguous() for i in range(2)]
                run = lambda: L.lstm_scan_bidir2(xp[0], xp[1], whh[0], whh[1])
                plain = lambda: L.lstm_scan_bidir2_plain(xp[0], xp[1], whh[0], whh[1])
                library = lambda: (libs[0](xs[0])[0], libs[1](xs[1])[0])
                got = run()
                torch.cuda.synchronize()
                ref = plain()
                err = max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref))
                lib_err = max((a.float() - r.float()).abs().max().item()
                              for a, r in zip(library(), ref))
                ctl = L.lstm_scan_bidir2(xp[0], xp[1], whh[1], whh[0])
                control = max((a.float() - r.float()).abs().max().item() for a, r in zip(ctl, ref))
                ms = cuda_ms(run, iters=10)
                plain_ms = cuda_ms(plain, iters=2)
                library_ms = cuda_ms(library, iters=10)
            bound, bound_by = _bound(nbytes, ops, dtype)
            row = dict(name="lstm_scan_bidir2", shape=label, rows=R, steps=T, H=H,
                       dtype=DT_NAME[dtype], max_abs_err=err, tol=TOL[dtype], ms=ms,
                       us_per_step=ms * 1e3 / T, plain_ms=plain_ms, library_ms=library_ms,
                       library="2 cuDNN LSTM forwards, projection included",
                       library_max_abs_err=lib_err, control_max_abs_err=control,
                       bound_ms=bound, bound_by=bound_by, tflops=ops / (ms * 1e-3) / 1e12)
            say(phase="kernel_vs_plain", **row)
            if not (err <= TOL[dtype]):
                raise SystemExit(f"lstm_scan_bidir2 {label} {DT_NAME[dtype]}: max abs err {err} "
                                 f"over tolerance {TOL[dtype]}")
            if not (control > TOL[dtype]):
                raise SystemExit(f"lstm_scan_bidir2 {label} {DT_NAME[dtype]}: the control with "
                                 f"the two W_hh swapped ({control}) passes the tolerance "
                                 f"{TOL[dtype]}")
            rows.append(row)
    return rows


def phase_gcrn():
    """GCRN (8.28 M parameters, no width knobs) through the engine: decode at
    B=8 x 1024 in float32 and bfloat16, run_inference on the synthetic set,
    the card against the CPU's plain path."""
    from nvse_tpu_torch.infer import InferenceEngine, run_inference
    from nvse_tpu_torch.ops.spectral import mel_spectrogram

    counters = _all_counters()
    for c in counters.values():                    # this main path starts here
        c.launches = 0
        c.launches_by_shape = {}

    base = _config("gcrn")
    B, T, iters = 8, 1024, 5
    rng = np.random.default_rng(2)
    mel = torch.from_numpy(rng.standard_normal((B, base.num_mels, T)).astype(np.float32) - 4.0)
    melc = mel.to("cuda")
    audio_sec = B * (T - 1) * base.hop_size / base.sampling_rate
    wavs = {}
    for dtype in ("float32", "bfloat16"):
        eng = InferenceEngine(_config("gcrn", compute_dtype=dtype), device="cuda")
        n_params = sum(p.numel() for p in eng.generator.parameters())
        eng.forward(melc)                          # warmup
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        wav, counts = _launched(counters, lambda: [eng.forward(melc) for _ in range(iters)][-1])
        torch.cuda.synchronize()
        wall = (time.time() - t0) / iters
        say(phase="gcrn_decode", dtype=dtype, batch=B, frames=T, parameters=n_params,
            wall_ms=wall * 1e3, rtf=audio_sec / wall,
            launches_per_forward={k: v / iters for k, v in counts.items()},
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        expect = {k: (2 * iters if k == "lstm_scan_bidir2" else 0) for k in counters}
        if counts != expect:
            raise SystemExit(f"GCRN decode {dtype}: launches {counts} for {iters} forwards, "
                             "expected 2 lstm_scan_bidir2 per forward and no other LSTM kernel")
        if wav.shape != (B, (T - 1) * base.hop_size) or not torch.isfinite(wav).all():
            raise SystemExit(f"GCRN decode {dtype}: bad output {tuple(wav.shape)}")
        if not 0.98 * 8.28e6 <= n_params <= 1.02 * 8.28e6:
            raise SystemExit(f"GCRN has {n_params} parameters, not the 8.28 M of its full width")
        wavs[dtype] = wav
        del eng
    w32, wbf = wavs["float32"], wavs["bfloat16"]
    margs = (base.n_fft, base.num_mels, base.sampling_rate, base.hop_size, base.win_size,
             base.fmin, base.sampling_rate / 2)
    mel_l1 = (mel_spectrogram(w32, *margs) - mel_spectrogram(wbf, *margs)).abs().mean().item()
    wav_rel = ((w32 - wbf).norm() / (w32.norm() + 1e-9)).item()
    say(phase="gcrn_decode", bf16_vs_f32_mel_l1=mel_l1, bf16_vs_f32_wav_rel_l2=wav_rel)

    # run_inference on the synthetic set (weights from the seed: the config's
    # checkpoint file is not part of the repository)
    for dtype in ("float32", "bfloat16"):
        with tempfile.TemporaryDirectory() as out:
            lines = []
            stats, counts = _launched(counters, lambda: run_inference(
                _config("gcrn", compute_dtype=dtype, test_output_dir=out), device="cuda",
                log_fn=lines.append))
            written = sorted(os.listdir(out))
        say(phase="gcrn_serve", dtype=dtype, line=lines[-1], files=stats["files"],
            rtf=stats["rtf"], launches=counts)
        others = sum(v for k, v in counts.items() if k != "lstm_scan_bidir2")
        if (stats["files"] != 6 or len(written) != 6 or counts["lstm_scan_bidir2"] == 0
                or others):
            raise SystemExit(f"GCRN serving {dtype}: {stats} wrote {written}, launches {counts}")
    main_counts = dict(counters["lstm_scan_bidir2"].launches_by_shape)   # ... and ends here

    # the card's decode against the CPU's plain path, same weights, small input
    small = mel[:2, :, :64]
    cpu = InferenceEngine(base, device="cpu").forward(small)
    gpu = InferenceEngine(base, device="cuda").forward(small).cpu()
    err = (gpu - cpu).abs()
    ok = bool((err <= MODEL_ATOL + MODEL_RTOL * cpu.abs()).all())
    say(phase="gcrn_decode_vs_cpu_plain", batch=2, frames=64, max_abs_err=err.max().item(),
        max_abs_ref=cpu.abs().max().item(), rtol=MODEL_RTOL, atol=MODEL_ATOL, ok=ok)
    if not ok:
        raise SystemExit("GCRN decode on the card disagrees with the CPU plain path")
    return main_counts


def phase_bidir2_grad():
    """lstm_scan_bidir2 under autograd on the card, its residual-saving route
    (lstm_fwd_hc and lstm_bwd per scan) against the CPU's plain autograd:
    at H = 128 (the kernels of csrc/lstm_bwd.cu) and at GCRN's training
    shape, 65 steps x 16 rows x H = 448 (csrc/lstm_wide.cu); the control,
    which the limit must refuse, is the card's route with the two W_hh
    swapped."""
    from nvse_tpu_torch.ops import lstm as L

    counters = _all_counters()
    names = ("hs_a", "hs_b", "dx_proj_a", "dx_proj_b", "dW_hh_a", "dW_hh_b")
    for T, R, H in ((65, 16, 128), (65, 16, 448)):
        g = torch.Generator().manual_seed(11 + H)
        b = 1.0 / math.sqrt(H)
        host = ([0.5 * torch.randn(T, R, 4 * H, generator=g) for _ in range(2)]
                + [torch.empty(H, 4 * H).uniform_(-b, b, generator=g) for _ in range(2)])
        cots = [torch.randn(T, R, H, generator=g) for _ in range(2)]

        def run(device, swap=False):
            args = [a.to(device).detach().requires_grad_() for a in host]
            xa, xb, wa, wb = args
            outs = L.lstm_scan_bidir2(xa, xb, *((wb, wa) if swap else (wa, wb)))
            torch.autograd.backward(list(outs), [c.to(device) for c in cots])
            return [o.detach().cpu() for o in outs] + [a.grad.cpu() for a in args]

        gpu, counts = _launched(counters, lambda: run("cuda"))
        cpu = run("cpu")
        errs = {n: _err(a, r)[1] for n, a, r in zip(names, gpu, cpu)}
        control = max(_err(a, r)[1] for a, r in zip(run("cuda", swap=True), cpu))
        expect = {k: 0 for k in counters}
        expect.update(lstm_fwd_hc=2, lstm_bwd=2, lstm_bwd_dw=2)
        ok = all(e <= TRAIN_TOL[torch.float32] for e in errs.values())
        refused = control > TRAIN_TOL[torch.float32]
        say(phase="bidir2_grad_vs_cpu_plain", steps=T, rows=R, H=H, rel_err=errs,
            tol=TRAIN_TOL[torch.float32], control_rel_err=control, launches=counts, ok=ok,
            control_refused=refused)
        if not ok or counts != expect:
            raise SystemExit(f"lstm_scan_bidir2 gradient route at H = {H}: errors {errs}, "
                             f"launches {counts}, expected {expect}")
        if not refused:
            raise SystemExit(f"lstm_scan_bidir2 gradient route at H = {H}: the control with "
                             f"the W_hh swapped ({control}) passes the tolerance")


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
    scan_rows = phase_scan_kernels()
    main_counts = phase_decode()
    phase_serve()
    train_counts = phase_train()
    phase_train_vs_cpu_plain()
    phase_train_cli()
    stream_counts = phase_stream()
    phase_train(causal=True)
    bidir2_rows = phase_bidir2_kernels()
    gcrn_counts = phase_gcrn()
    phase_bidir2_grad()
    gcrn_train_counts = phase_train("gcrn")
    phase_train_vs_cpu_plain("gcrn")
    phase_train_cli("gcrn")

    kernels = []
    for r in rows:
        key = (r["rows"], r["steps"], r["C"], r["H"], r["dtype"])
        kernels.append({
            "name": "lstm_scan_fused", "shape": r["shape"], "dtype": r["dtype"],
            "route": "cuda", "source": "nvse_tpu_torch/csrc/lstm_fused.cu",
            "replaces": "nvse_tpu/ops/pallas_lstm.py:815",
            "also_replaces": "nvse_tpu/ops/pallas_lstm.py:727",
            "launches": main_counts.get(key, 0) + stream_counts["lstm_scan_fused"].get(key, 0),
            "max_abs_err": r["max_abs_err"],
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
            "source": r["source"], "replaces": replaces[r["name"]],
            "launches": (train_counts[r["name"]].get(key, 0)
                         + gcrn_train_counts[r["name"]].get(key, 0)),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    scan_replaces = {"lstm_scan": "nvse_tpu/ops/pallas_lstm.py:212",
                     "lstm_scan_stateful": "nvse_tpu/ops/pallas_lstm.py:297"}
    for r in scan_rows:
        key = (r["steps"], r["rows"], r["H"], r["dtype"])
        kernels.append({
            "name": r["name"], "shape": r["shape"], "dtype": r["dtype"], "route": "cuda",
            "source": "nvse_tpu_torch/csrc/lstm_scan.cu", "replaces": scan_replaces[r["name"]],
            "launches": stream_counts[r["name"]].get(key, 0), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    for r in bidir2_rows:
        key = (r["steps"], r["rows"], r["H"], r["dtype"])
        if r["shape"] == "small":      # held against its plain version only: no path has H <= 128
            continue
        kernels.append({
            "name": r["name"], "shape": r["shape"], "dtype": r["dtype"], "route": "cuda",
            "source": "nvse_tpu_torch/csrc/lstm_bidir2.cu",
            "replaces": "nvse_tpu/ops/pallas_lstm.py:499",
            "launches": gcrn_counts.get(key, 0), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    if any(k["launches"] == 0 for k in kernels):
        raise SystemExit(f"a kernel of a driven path was never launched: {main_counts} "
                         f"{train_counts} {stream_counts} {gcrn_counts} {gcrn_train_counts}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
