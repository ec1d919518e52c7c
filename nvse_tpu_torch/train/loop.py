"""Training loop: epochs, checkpoints, optional TensorBoard, validation.

Counterpart of nvse_tpu/train/loop.py:82-330 for the T-F and the time
trainers (reference train_tf_wi_inv.py:158-430, train_time_wi_inv.py:
150-430; the domain is the registry's): checkpoint every
`checkpoint_interval` with keep-N rotation, scalars every
`summary_interval`, validation every `validation_interval` (step 0
included unless `skip_step0_validation`), a final save and stop once
`training_steps` is passed, per-epoch lr decay (in the optimizer
schedule), resume from the newest g_/do_ pair at its epoch.

Batches are random raw-audio segments from threaded readers, copied to
the card from pinned memory one batch ahead. Validation runs whole
utterances at batch 1, zero-padded to a bucket of
`validation_bucket_frames` (64) frames and masked (eval_full), or fixed
crops with `validation_full: false`. TensorBoard (tensorboardX) is used
when installed: scalars, and at each validation the first 4 items' generated
audio, the ground truth once and a mel figure of each of the first
(nvse_tpu/train/loop.py:205-240), each skipped where tensorboardX's audio
encoding (soundfile) or matplotlib is missing. The log says whether the
batches are cropped by the native C++ decoder or in Python (data/dataset.py).

Under torchrun (one process a card) the loop trains data-parallel over
the ranks, and with h.sp_devices > 1 BSRNN sequence-parallel too, by the
rules of nvse_tpu/train/loop.py:86-121 (`parallel_plan`): h.batch_size is
the global batch; each node reads its shard of the file list
(SegmentDataset shard_id / num_shards) in batches of batch_size / nodes,
and the data ranks of a node take their rows of it. Only rank 0 logs,
writes TensorBoard and checkpoints, and validates; the other ranks wait.

Three knobs of nvse_tpu/train/loop.py:48-80, 287, 305-330:
  * `async_checkpoint` (default true): the interval saves write on a
    background thread from host copies taken at the save
    (train/checkpoint.py); the final save is synchronous, after a wait for
    the one in flight, and `train` waits for it when it returns or raises;
  * `debug_nans`: autograd's anomaly mode for the run (`_setup_debug`);
  * `profile_dir` / `profile_steps` (default 5): a torch.profiler trace of
    the first steps on rank 0 (`_StepProfiler`).
"""
from __future__ import annotations

import itertools
import math
import os
import random as _random
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data import PrefetchLoader, SegmentDataset, get_dataset_filelist
from ..ops.spectral import mel_spectrogram
from ..parallel import get_mesh, init_distributed, mesh_barrier, node_shape, shard_batch
from .checkpoint import restore_checkpoint, save_checkpoint, wait_for_checkpoints
from .trainer import GANTrainer, fetch_scalars


def _summary_writer(path: str):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(path)


def _plot_spectrogram(spec: np.ndarray):
    """A matplotlib figure of spec for TensorBoard (reference utils.py:23-32)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(spec, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    fig.canvas.draw()
    return fig


def log_validation_sample(sw, h, i: int, step: int, y_g: torch.Tensor, audio: torch.Tensor,
                          gt_logged: bool) -> bool:
    """TensorBoard samples of validation item i < 4 (nvse_tpu/train/loop.py:
    205-240): the generated wave as generated/y_hat_{i} and, unless gt_logged,
    the ground truth as gt/y_{i}; for item 0 the generated mel as the figure
    generated/y_hat_spec and, unless gt_logged, gt/y_spec. -> False when an
    add raised (tensorboardX encodes audio with soundfile, the figures need
    matplotlib): the ground truth is then tried again at the next validation."""
    ok = True
    try:
        sw.add_audio(f"generated/y_hat_{i}", y_g[0].float().cpu().numpy()[:, None], step,
                     h.sampling_rate)
        if not gt_logged:
            sw.add_audio(f"gt/y_{i}", audio[0].float().cpu().numpy()[:, None], step,
                         h.sampling_rate)
    except Exception:
        ok = False
    if i == 0:
        margs = (h.n_fft, h.num_mels, h.sampling_rate, h.hop_size, h.win_size, h.fmin,
                 h.sampling_rate / 2)
        try:
            m = mel_spectrogram(y_g[:1].float(), *margs)[0].cpu().numpy()
            sw.add_figure("generated/y_hat_spec", _plot_spectrogram(m), step)
            if not gt_logged:
                mg = mel_spectrogram(audio[:1].float(), *margs)[0].cpu().numpy()
                sw.add_figure("gt/y_spec", _plot_spectrogram(mg), step)
        except Exception:
            ok = False
    return ok


def parallel_plan(batch_size: int, nodes: int, local: int, sp: int, log_fn=print):
    """(data ranks a node, seq ranks) that train on `nodes` nodes of `local`
    ranks each, by nvse_tpu/train/loop.py:86-121: sp_devices that does not
    divide the local ranks is dropped with a warning; a node uses as many
    data ranks as evenly divide its share of the batch (warning when that
    leaves ranks idle)."""
    if sp > 1 and local % sp:
        log_fn(f"WARNING: sp_devices={sp} does not divide the {local} "
               "local devices; disabling sequence parallelism.")
        sp = 1
    if batch_size % nodes:
        raise ValueError(f"batch_size={batch_size} must be divisible by the {nodes} "
                         "participating processes")
    n_data_local = math.gcd(batch_size // nodes, local // sp)
    n_dev = n_data_local * nodes * sp
    if n_dev != nodes * local:
        log_fn(f"WARNING: batch_size={batch_size} is not divisible by the "
               f"{nodes * (local // sp)} available data-parallel devices; "
               f"training will use only {n_dev} device(s). Set batch_size to a "
               f"multiple of {nodes * (local // sp)} to use the full mesh.")
    return n_data_local, sp


def _training_mesh(h, dev, log_fn):
    """(mesh or None, nodes): the ranks of torchrun's job that train, by
    `parallel_plan`; a rank outside the mesh has nothing to do."""
    nodes, local = node_shape()
    if nodes * local == 1:
        if int(h.get("sp_devices", 1) or 1) > 1:
            parallel_plan(int(h.batch_size), 1, 1, int(h.sp_devices), log_fn)
        return None, 1
    n_data, n_sp = parallel_plan(int(h.batch_size), nodes, local,
                                 int(h.get("sp_devices", 1) or 1), log_fn)
    ranks = [node * local + i for node in range(nodes) for i in range(n_data * n_sp)]
    return get_mesh(n_seq=n_sp, device=dev, ranks=ranks), nodes


def _setup_debug(h, log_fn) -> tuple[bool, bool] | None:
    """h.debug_nans: autograd's anomaly mode for the run, the stand-in for
    the reference's torch.autograd.set_detect_anomaly(True)
    (train_tf_wi_inv.py:4) as jax_debug_nans is the JAX loop's. -> the
    previous (mode, check_nan) to put back, or None when the knob is off.

    Where it differs from jax_debug_nans: torch checks what each backward
    function returns, and a NaN there raises a RuntimeError naming that
    function (the hand-written kernels' autograd.Functions of ops/lstm.py
    and ops/tcn.py by their class names), with the traceback of the
    forward call that made it, which anomaly mode records for every
    operation; a NaN made in a forward is not stopped where it is made,
    only where a backward returns one."""
    if not h.get("debug_nans"):
        return None
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True)
    log_fn("autograd anomaly detection (torch.autograd.set_detect_anomaly) enabled")
    return prev


class _StepProfiler:
    """h.profile_dir: a torch.profiler trace of the first h.profile_steps
    (default 5) training steps, CPU activity and the card's kernels when the
    device is the card, written under profile_dir by
    torch.profiler.tensorboard_trace_handler (a *.pt.trace.json that
    TensorBoard's profiler plugin and Perfetto open). `step` is called as a
    step starts, as nvse_tpu/train/loop.py:61-80: it starts the trace at the
    first step and stops it as step profile_steps + 1 starts. `stop` also
    ends and writes a trace that is still running when the run ends (a run
    shorter than profile_steps), a repair: the JAX loop never stops it then
    and loses that trace. Rank 0 only."""

    def __init__(self, profile_dir: str | None, profile_steps: int, dev: torch.device, log_fn):
        self.dir = profile_dir
        self.remaining = int(profile_steps) if profile_dir else 0
        self.dev = dev
        self.log_fn = log_fn
        self.prof = None

    def step(self) -> None:
        if not self.dir:
            return
        if self.remaining > 0 and self.prof is None:
            from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

            activities = [ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities,
                                on_trace_ready=tensorboard_trace_handler(self.dir))
            self.prof.start()
            self.log_fn(f"profiler trace started -> {self.dir}")
        elif self.remaining <= 0 and self.prof is not None:
            self.stop()
        self.remaining -= 1

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        prof, self.prof = self.prof, None
        prof.stop()                      # writes the trace (on_trace_ready)
        self.log_fn("profiler trace stopped")


def train(h, device: str = "cuda", log_fn=print) -> None:
    """Run training for config h (the reference's train(h) entry); under
    torchrun, on every rank."""
    dev = init_distributed(device)
    main = not dist.is_initialized() or dist.get_rank() == 0
    log_fn = log_fn if main else (lambda *_: None)
    anomaly = _setup_debug(h, log_fn)
    profiler = _StepProfiler(h.get("profile_dir") if main else None,
                             h.get("profile_steps", 5), dev, log_fn)
    finished = False
    try:
        _train(h, dev, main, log_fn, profiler)
        finished = True
    finally:
        profiler.stop()
        if anomaly is not None:
            torch.autograd.set_detect_anomaly(*anomaly)
        wait_for_checkpoints(barrier=finished)


def _train(h, dev: torch.device, main: bool, log_fn, profiler: _StepProfiler) -> None:
    mesh, nodes = _training_mesh(h, dev, log_fn)
    if mesh is not None and mesh.get_coordinate() is None:
        return                                  # a rank the batch leaves idle
    node = dist.get_rank() // (dist.get_world_size() // nodes) if mesh is not None else 0
    training_files, validation_files = get_dataset_filelist(
        h.input_training_wav_list, h.input_validation_wav_list, h.raw_wavfile_path)
    train_ds = SegmentDataset(training_files, h.segment_size, h.sampling_rate, seed=h.seed,
                              shard_id=node, num_shards=nodes)
    loader = PrefetchLoader(train_ds, int(h.batch_size) // nodes, num_workers=h.num_workers,
                            seed=h.seed)
    steps_per_epoch = max(1, len(loader))
    if nodes > 1:       # every node steps as often as the smallest shard allows
        n = torch.tensor([steps_per_epoch], device=dev)
        for d in range(mesh.ndim):
            dist.all_reduce(n, op=dist.ReduceOp.MIN, group=mesh.get_group(d))
        steps_per_epoch = int(n.item())
    val_full = bool(h.get("validation_full", True))
    val_ds = SegmentDataset(validation_files, h.segment_size * 4, h.sampling_rate,
                            split=not val_full, shuffle=False, seed=h.seed)
    val_bucket = int(h.get("validation_bucket_frames", 64)) * h.hop_size

    trainer = GANTrainer(h, device=dev, steps_per_epoch=steps_per_epoch, mesh=mesh)
    cfg_copy = os.path.join(h.checkpoint_path, "config.json")
    if main:
        os.makedirs(h.checkpoint_path, exist_ok=True)
        if h.get("config_path") and os.path.abspath(h.config_path) != os.path.abspath(cfg_copy):
            shutil.copyfile(h.config_path, cfg_copy)
    steps, last_epoch = restore_checkpoint(h.checkpoint_path, trainer)
    loader.epoch = max(0, last_epoch)   # resume the shuffle/crop streams at that epoch
    log_fn(f"checkpoints directory: {h.checkpoint_path} (resuming at step {steps})")
    log_fn("training crops: " + ("the native C++ batch decoder (native/libnvse_host.so)"
                                 if loader.native else "Python (the native decoder is not "
                                 "loaded, or the corpus is not at the target rate)"))
    sw = _summary_writer(os.path.join(h.checkpoint_path, "logs")) if main else None
    gt_logged = [False]             # the ground-truth samples, logged once

    def validate(step: int) -> None:
        """On rank 0; the other ranks wait for it."""
        if main:
            _validate(step)
        if mesh is not None:
            mesh_barrier(mesh, dev)

    def _validate(step: int) -> None:
        cap = int(h.get("validation_cap", 0))
        n_val = len(val_ds) if cap <= 0 else min(len(val_ds), cap)
        rows = []
        gt_added = True
        for i in range(n_val):
            if val_full:
                wav = val_ds.segment_at(i, _random.Random(0))
                n = len(wav)
                tgt = max(val_bucket, -(-n // val_bucket) * val_bucket)
                audio = torch.from_numpy(np.pad(wav, (0, tgt - n))[None, :])
                y_g, metrics = trainer.eval_full(audio, n)
            else:
                audio = torch.from_numpy(val_ds.segment_at(i, _random.Random(0x5EED + i))[None, :])
                y_g, metrics = trainer.eval_step(audio)
            rows.append(metrics)
            if sw is not None and i < 4:
                gt_added &= log_validation_sample(sw, h, i, step, y_g, audio, gt_logged[0])
        if sw is not None and gt_added and rows:
            gt_logged[0] = True
        if rows:
            agg = {k: sum(fetch_scalars(r)[k] for r in rows) / len(rows) for k in rows[0]}
            if sw is not None:
                for k, v in agg.items():
                    sw.add_scalar(f"validation/{k}", v, step)
            log_fn(f"step {step} validation: "
                   + " ".join(f"{k}={v:.4f}" for k, v in sorted(agg.items())))

    ranks = f", {mesh.size()} ranks {dict(zip(mesh.mesh_dim_names, mesh.shape))} " \
        f"({dist.get_backend()})" if mesh is not None else ""
    log_fn(f"training {h.model_name} ({trainer.domain}-domain) on {len(train_ds)} files, "
           f"{steps_per_epoch} steps/epoch, device {dev}{ranks}")

    def device_batches():
        """Host-to-device copy of this rank's rows of the next batch while the
        current one trains."""
        def put(b):
            t = torch.from_numpy(np.asarray(shard_batch(b, mesh, nodes), np.float32))
            return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t

        nxt = None
        for b in itertools.islice(loader, steps_per_epoch):
            cur, nxt = nxt, put(b)
            if cur is not None:
                yield cur
        if nxt is not None:
            yield nxt

    for epoch in range(max(0, last_epoch), h.training_epochs):
        t0 = time.time()
        for audio in device_batches():
            t_step = time.time()
            profiler.step()
            metrics = trainer.step(audio)
            want_stdout = steps % h.stdout_interval == 0
            want_summary = sw is not None and steps % h.summary_interval == 0
            if want_stdout or want_summary:
                m = fetch_scalars(metrics)
            if want_stdout:
                log_fn(f"epoch {epoch + 1} step {steps} "
                       + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items()))
                       + f" ({time.time() - t_step:.3f}s/b)")
            if steps % h.checkpoint_interval == 0 and steps != 0:
                save_checkpoint(h.checkpoint_path, steps, epoch, trainer, max_to_keep=h.max_to_keep,
                                async_save=bool(h.get("async_checkpoint", True)))
                log_fn(f"saved checkpoint at step {steps}")
            if want_summary:
                for k, v in m.items():
                    sw.add_scalar(f"training/{k}", v, steps)
            if steps % h.validation_interval == 0 and not (
                    steps == 0 and h.get("skip_step0_validation", False)):
                validate(steps)
            steps += 1
            if steps > h.training_steps:
                # synchronous, after the save in flight (save_checkpoint waits first)
                save_checkpoint(h.checkpoint_path, steps - 1, epoch, trainer,
                                max_to_keep=h.max_to_keep)
                log_fn("training finished (step budget reached)")
                return
        log_fn(f"epoch {epoch + 1} took {int(time.time() - t0)}s")
