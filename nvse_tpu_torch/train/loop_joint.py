"""Joint denoise+vocoder training loop (BSRNN_24k).

Counterpart of nvse_tpu/train/loop_joint.py (reference
train_tf_wi_inv_joint_denoise_vocoder.py:43-445): the joint dataset draws
one task per batch (50/50 denoise / vocoder) and mixes noise on the host at
a LUFS-matched SNR; the features are computed on the device in the step.
One GANTrainer in the joint domain takes both tasks (the task is an
argument of its step), so both train one generator, one MPD + MRD and one
pair of AdamW states.

Checkpoints (g_/do_ bundles with keep-N rotation, train/checkpoint.py)
every `checkpoint_interval` and at the step budget; the loop resumes from
the newest pair at its epoch, so the per-batch seeds of (seed, epoch,
index) continue there. Validation every `validation_interval` (step 0
included unless `skip_step0_validation`) scores each task on up to 8
validation items at batch 1, each with the fixed seed seed * 1_000_003 + i,
so every pass scores the same noise, SNR and crop draws. TensorBoard
(tensorboardX) scalars when installed.

Under torchrun on one node the loop trains data-parallel, as the JAX loop
(nvse_tpu/train/loop_joint.py:38-57): as many ranks as evenly divide
h.batch_size, each taking its rows of every batch (every rank draws the
same batches from the same seeds); rank 0 logs, checkpoints and validates.
More than one node raises NotImplementedError, as there: the self-batching
JointDataset has no per-node slicing.

Of the T-F loop's three knobs this loop honours `async_checkpoint` alone, as
nvse_tpu/train/loop_joint.py:176-196: the interval saves write in the
background (train/checkpoint.py), the final save is synchronous, and
`train_joint` waits for the save in flight when it returns or raises.
`debug_nans` and `profile_dir` are read by train/loop.py only.
"""
from __future__ import annotations

import math
import os
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data import JointDataset, PrefetchJointLoader, get_joint_filelist
from ..ops.spectral import JOINT_TASKS
from ..parallel import get_mesh, init_distributed, mesh_barrier, node_shape, shard_batch
from .checkpoint import restore_checkpoint, save_checkpoint, wait_for_checkpoints
from .loop import _summary_writer
from .trainer import GANTrainer, fetch_scalars

# validation items per task (nvse_tpu/train/loop_joint.py:106)
VALIDATION_ITEMS = 8


def train_joint(h, device: str = "cuda", log_fn=print) -> None:
    """Run joint training for config h (the reference's train(h) entry);
    under torchrun, on every rank of one node."""
    nodes, local = node_shape()
    if nodes > 1:
        raise NotImplementedError(
            "multi-host joint training needs per-host slicing of the "
            "self-batching JointDataset; use the single-task trainers "
            "for multi-host runs")
    dev = init_distributed(device)
    main = not dist.is_initialized() or dist.get_rank() == 0
    log_fn = log_fn if main else (lambda *_: None)
    finished = False
    try:
        _train_joint(h, dev, main, local, log_fn)
        finished = True
    finally:
        wait_for_checkpoints(barrier=finished)


def _train_joint(h, dev: torch.device, main: bool, local: int, log_fn) -> None:
    mesh = None
    if local > 1:
        n_dev = math.gcd(int(h.batch_size), local)
        if n_dev != local:
            log_fn(f"WARNING: batch_size={h.batch_size} is not divisible by the {local} "
                   f"available devices; training will use only {n_dev} device(s). Set "
                   f"batch_size to a multiple of {local} to use the full mesh.")
        mesh = get_mesh(n_dev, device=dev)
        if mesh.get_coordinate() is None:
            return                              # a rank the batch leaves idle
    train_files, val_files, train_noise, val_noise = get_joint_filelist(
        h.input_training_wav_list, h.input_validation_wav_list,
        h.raw_wavfile_path, h.input_noise_wav_list)
    log_fn(f"joint training: {len(train_files)} speech files, {len(train_noise)} noise files")

    ds = JointDataset(train_files, train_noise, tuple(h.snr_range), h.segment_size,
                      h.sampling_rate, h.batch_size, task_dict=h.task_dict, seed=h.seed)
    loader = PrefetchJointLoader(ds, num_workers=h.get("num_workers", 4), seed=h.seed)
    steps_per_epoch = max(1, len(ds))
    trainer = GANTrainer(h, device=dev, steps_per_epoch=steps_per_epoch, joint=True, mesh=mesh)

    cfg_copy = os.path.join(h.checkpoint_path, "config.json")
    if main:
        os.makedirs(h.checkpoint_path, exist_ok=True)
        if h.get("config_path") and os.path.abspath(h.config_path) != os.path.abspath(cfg_copy):
            shutil.copyfile(h.config_path, cfg_copy)
    steps, last_epoch = restore_checkpoint(h.checkpoint_path, trainer)
    # continue the (seed, epoch, index) streams of tasks, crops and noise at
    # the restored epoch instead of replaying epoch 0's
    loader.epoch = max(0, last_epoch)
    log_fn(f"checkpoints directory: {h.checkpoint_path} (resuming at step {steps})")
    sw = _summary_writer(os.path.join(h.checkpoint_path, "logs")) if main else None

    val_ds = JointDataset(val_files, val_noise, tuple(h.snr_range), h.segment_size,
                          h.sampling_rate, batch_size=1, task_dict=h.task_dict,
                          shuffle=False, seed=h.seed) if val_files else None

    def validate(step: int) -> None:
        """On rank 0; the other ranks wait for it."""
        if main and val_ds is not None:
            _validate(step)
        if mesh is not None:
            mesh_barrier(mesh, dev)

    def _validate(step: int) -> None:
        for task in JOINT_TASKS:
            val_ds.task_dict = [task]
            rows = []
            for i in range(min(len(val_ds.speech_files), VALIDATION_ITEMS)):
                noisy, clean, _ = val_ds.get_batch(i, seed=int(h.seed) * 1_000_003 + i)
                _, metrics = trainer.eval_step(torch.from_numpy(clean), torch.from_numpy(noisy),
                                               task)
                rows.append(fetch_scalars(metrics))
            if rows:
                agg = {k: sum(r[k] for r in rows) / len(rows) for k in rows[0]}
                if sw is not None:
                    for k, v in agg.items():
                        sw.add_scalar(f"validation/{task}/{k}", v, step)
                log_fn(f"step {step} val[{task}]: "
                       + " ".join(f"{k}={v:.4f}" for k, v in sorted(agg.items())))

    ranks = f", {mesh.size()} ranks ({dist.get_backend()})" if mesh is not None else ""
    log_fn(f"training {h.model_name} (joint) on {len(train_files)} files, "
           f"{steps_per_epoch} steps/epoch, device {dev}{ranks}")

    def device_batches():
        """Host-to-device copy of this rank's rows of the next batch while the
        current one trains."""
        def put(noisy, clean, task):
            def to_dev(a):
                t = torch.from_numpy(np.asarray(shard_batch(a, mesh), np.float32))
                return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t
            return to_dev(clean), to_dev(noisy), task

        nxt = None
        for b in loader:
            cur, nxt = nxt, put(*b)
            if cur is not None:
                yield cur
        if nxt is not None:
            yield nxt

    for epoch in range(max(0, last_epoch), h.training_epochs):
        t0 = time.time()
        for clean, noisy, task in device_batches():
            t_step = time.time()
            metrics = trainer.step(clean, noisy, task)
            want_stdout = steps % h.stdout_interval == 0
            want_summary = sw is not None and steps % h.summary_interval == 0
            if want_stdout or want_summary:
                m = fetch_scalars(metrics)
            if want_stdout:
                log_fn(f"epoch {epoch + 1} step {steps} task={task} "
                       + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items()))
                       + f" ({time.time() - t_step:.3f}s/b)")
            if steps % h.checkpoint_interval == 0 and steps != 0:
                save_checkpoint(h.checkpoint_path, steps, epoch, trainer, max_to_keep=h.max_to_keep,
                                async_save=bool(h.get("async_checkpoint", True)))
                log_fn(f"saved checkpoint at step {steps}")
            if want_summary:
                for k, v in m.items():
                    sw.add_scalar(f"training/{task}/{k}", v, steps)
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
