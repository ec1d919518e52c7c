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
(tensorboardX) scalars when installed. The JAX loop's mesh and multi-host
branches are not ported: sp_devices > 1 and infer_dp_devices raise.
"""
from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from .. import resolve_device
from ..data import JointDataset, PrefetchJointLoader, get_joint_filelist
from ..ops.spectral import JOINT_TASKS
from .checkpoint import restore_checkpoint, save_checkpoint
from .loop import _summary_writer
from .trainer import GANTrainer, fetch_scalars

# validation items per task (nvse_tpu/train/loop_joint.py:106)
VALIDATION_ITEMS = 8


def train_joint(h, device: str = "cuda", log_fn=print) -> None:
    """Run joint training for config h (the reference's train(h) entry)."""
    if int(h.get("infer_dp_devices", 1) or 1) != 1:
        raise NotImplementedError("multi-GPU validation (infer_dp_devices) is not ported yet")
    dev = resolve_device(device)
    train_files, val_files, train_noise, val_noise = get_joint_filelist(
        h.input_training_wav_list, h.input_validation_wav_list,
        h.raw_wavfile_path, h.input_noise_wav_list)
    log_fn(f"joint training: {len(train_files)} speech files, {len(train_noise)} noise files")

    ds = JointDataset(train_files, train_noise, tuple(h.snr_range), h.segment_size,
                      h.sampling_rate, h.batch_size, task_dict=h.task_dict, seed=h.seed)
    loader = PrefetchJointLoader(ds, num_workers=h.get("num_workers", 4), seed=h.seed)
    steps_per_epoch = max(1, len(ds))
    trainer = GANTrainer(h, device=dev, steps_per_epoch=steps_per_epoch, joint=True)

    os.makedirs(h.checkpoint_path, exist_ok=True)
    cfg_copy = os.path.join(h.checkpoint_path, "config.json")
    if h.get("config_path") and os.path.abspath(h.config_path) != os.path.abspath(cfg_copy):
        shutil.copyfile(h.config_path, cfg_copy)
    steps, last_epoch = restore_checkpoint(h.checkpoint_path, trainer)
    # continue the (seed, epoch, index) streams of tasks, crops and noise at
    # the restored epoch instead of replaying epoch 0's
    loader.epoch = max(0, last_epoch)
    log_fn(f"checkpoints directory: {h.checkpoint_path} (resuming at step {steps})")
    sw = _summary_writer(os.path.join(h.checkpoint_path, "logs"))

    val_ds = JointDataset(val_files, val_noise, tuple(h.snr_range), h.segment_size,
                          h.sampling_rate, batch_size=1, task_dict=h.task_dict,
                          shuffle=False, seed=h.seed) if val_files else None

    def validate(step: int) -> None:
        if val_ds is None:
            return
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

    log_fn(f"training {h.model_name} (joint) on {len(train_files)} files, "
           f"{steps_per_epoch} steps/epoch, device {dev}")

    def device_batches():
        """Host-to-device copy of the next batch while the current one trains."""
        def put(noisy, clean, task):
            def to_dev(a):
                t = torch.from_numpy(np.asarray(a, np.float32))
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
                save_checkpoint(h.checkpoint_path, steps, epoch, trainer, max_to_keep=h.max_to_keep)
                log_fn(f"saved checkpoint at step {steps}")
            if want_summary:
                for k, v in m.items():
                    sw.add_scalar(f"training/{task}/{k}", v, steps)
            if steps % h.validation_interval == 0 and not (
                    steps == 0 and h.get("skip_step0_validation", False)):
                validate(steps)
            steps += 1
            if steps > h.training_steps:
                save_checkpoint(h.checkpoint_path, steps - 1, epoch, trainer,
                                max_to_keep=h.max_to_keep)
                log_fn("training finished (step budget reached)")
                return
        log_fn(f"epoch {epoch + 1} took {int(time.time() - t0)}s")
