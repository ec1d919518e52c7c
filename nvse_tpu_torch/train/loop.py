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
when installed; only scalars are logged.
"""
from __future__ import annotations

import os
import random as _random
import shutil
import time

import numpy as np
import torch

from .. import resolve_device
from ..data import PrefetchLoader, SegmentDataset, get_dataset_filelist
from .checkpoint import restore_checkpoint, save_checkpoint
from .trainer import GANTrainer, fetch_scalars


def _summary_writer(path: str):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(path)


def train(h, device: str = "cuda", log_fn=print) -> None:
    """Run training for config h (the reference's train(h) entry)."""
    dev = resolve_device(device)
    training_files, validation_files = get_dataset_filelist(
        h.input_training_wav_list, h.input_validation_wav_list, h.raw_wavfile_path)
    train_ds = SegmentDataset(training_files, h.segment_size, h.sampling_rate, seed=h.seed)
    loader = PrefetchLoader(train_ds, h.batch_size, num_workers=h.num_workers, seed=h.seed)
    steps_per_epoch = max(1, len(loader))
    val_full = bool(h.get("validation_full", True))
    val_ds = SegmentDataset(validation_files, h.segment_size * 4, h.sampling_rate,
                            split=not val_full, shuffle=False, seed=h.seed)
    val_bucket = int(h.get("validation_bucket_frames", 64)) * h.hop_size

    trainer = GANTrainer(h, device=dev, steps_per_epoch=steps_per_epoch)
    os.makedirs(h.checkpoint_path, exist_ok=True)
    cfg_copy = os.path.join(h.checkpoint_path, "config.json")
    if h.get("config_path") and os.path.abspath(h.config_path) != os.path.abspath(cfg_copy):
        shutil.copyfile(h.config_path, cfg_copy)
    steps, last_epoch = restore_checkpoint(h.checkpoint_path, trainer)
    loader.epoch = max(0, last_epoch)   # resume the shuffle/crop streams at that epoch
    log_fn(f"checkpoints directory: {h.checkpoint_path} (resuming at step {steps})")
    sw = _summary_writer(os.path.join(h.checkpoint_path, "logs"))

    def validate(step: int) -> None:
        cap = int(h.get("validation_cap", 0))
        n_val = len(val_ds) if cap <= 0 else min(len(val_ds), cap)
        rows = []
        for i in range(n_val):
            if val_full:
                wav = val_ds.segment_at(i, _random.Random(0))
                n = len(wav)
                tgt = max(val_bucket, -(-n // val_bucket) * val_bucket)
                audio = torch.from_numpy(np.pad(wav, (0, tgt - n))[None, :])
                _, metrics = trainer.eval_full(audio, n)
            else:
                audio = torch.from_numpy(val_ds.segment_at(i, _random.Random(0x5EED + i))[None, :])
                _, metrics = trainer.eval_step(audio)
            rows.append(metrics)
        if rows:
            agg = {k: sum(fetch_scalars(r)[k] for r in rows) / len(rows) for k in rows[0]}
            if sw is not None:
                for k, v in agg.items():
                    sw.add_scalar(f"validation/{k}", v, step)
            log_fn(f"step {step} validation: "
                   + " ".join(f"{k}={v:.4f}" for k, v in sorted(agg.items())))

    log_fn(f"training {h.model_name} ({trainer.domain}-domain) on {len(train_ds)} files, "
           f"{steps_per_epoch} steps/epoch, device {dev}")

    def device_batches():
        """Host-to-device copy of the next batch while the current one trains."""
        def put(b):
            t = torch.from_numpy(np.asarray(b, np.float32))
            return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t

        nxt = None
        for b in loader:
            cur, nxt = nxt, put(b)
            if cur is not None:
                yield cur
        if nxt is not None:
            yield nxt

    for epoch in range(max(0, last_epoch), h.training_epochs):
        t0 = time.time()
        for audio in device_batches():
            t_step = time.time()
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
                save_checkpoint(h.checkpoint_path, steps, epoch, trainer, max_to_keep=h.max_to_keep)
                log_fn(f"saved checkpoint at step {steps}")
            if want_summary:
                for k, v in m.items():
                    sw.add_scalar(f"training/{k}", v, steps)
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
