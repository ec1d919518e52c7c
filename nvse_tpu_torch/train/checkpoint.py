"""Checkpoints: the two-bundle g_/do_ layout with keep-N rotation.

Counterpart of nvse_tpu/train/checkpoint.py (Orbax there; torch.save
here). Per save step two files, the reference repo's own
layout (utils.py:51-86, train_tf_wi_inv.py:288-305):
  g_{step:08d}   {"generator": state_dict}   what inference loads
  do_{step:08d}  {"mpd", "mrd" or "msd", ("cqtd",) "optim_g", "optim_d", "steps", "epoch"}
The time domain's "msd" state_dict carries the spectral-norm buffers `u`
of its first scale, as the JAX bundle's `spectral` (checkpoint.py:89-90);
resuming restores them. A trainer with the CQT discriminator (h.use_cqtd)
adds its state_dict as "cqtd", as the JAX disc state's params hold it.
Rotation keeps `max_to_keep` of each and writes the checkpoint_g /
checkpoint_d manifests. Tensors are saved on the CPU, so a bundle written
on the card loads anywhere.

A save takes a snapshot on the calling thread: every tensor of both trees
is copied to host memory (a CPU tensor is cloned, since the next steps
update parameters and AdamW moments in place), and the call returns once
the copies are complete. With async_save (the loops' `async_checkpoint`,
default true, as nvse_tpu/train/checkpoint.py:55-104) the torch.save and
os.replace of both bundles and their rotation then run on one background
thread; `wait_for_checkpoints` blocks until that write is complete and
raises what the writer raised. Every save, and `restore_checkpoint`, waits
first, so one write at most is in flight and a restore in this process
reads complete bundles.

A trainer over a mesh (data / sequence parallelism) holds the same state on
every rank: rank 0 writes the bundles, and every rank waits at a barrier
until they are complete: after the write of a synchronous save, in the
wait of an asynchronous one. Every rank restores from the same files, each
onto its own device.
"""
from __future__ import annotations

import concurrent.futures
import glob
import os
import re
import threading

import torch
import torch.distributed as dist

from ..parallel import mesh_barrier

# the save in flight (one writer a process: a save waits for the last one):
# [(future of rank 0's write or None, mesh or None, device)]
_PENDING: list = []
_PENDING_LOCK = threading.Lock()
_WRITER: concurrent.futures.ThreadPoolExecutor | None = None   # made at the first async save


def scan_checkpoint(path: str, prefix: str) -> str | None:
    """Newest '{prefix}????????' file in path (reference utils.py:81-86)."""
    cands = [p for p in glob.glob(os.path.join(path, prefix + "????????"))
             if re.fullmatch(rf"{re.escape(prefix)}\d{{8}}", os.path.basename(p))]
    return sorted(cands)[-1] if cands else None


def _rotate(path: str, prefix: str, keep: int) -> None:
    cands = sorted(p for p in glob.glob(os.path.join(path, prefix + "????????"))
                   if re.fullmatch(rf"{re.escape(prefix)}\d{{8}}", os.path.basename(p)))
    for p in cands[:-keep]:
        os.remove(p)
    manifest = os.path.join(path, "checkpoint_g" if prefix == "g_" else "checkpoint_d")
    with open(manifest, "w") as f:
        f.writelines(os.path.basename(p) + "\n" for p in cands[-keep:])


def _host_copy(tree, on_card: list):
    """tree with every tensor copied to host memory: a CPU tensor cloned, a
    card tensor copied into pinned memory without waiting (on_card gets
    its device: the caller synchronises it once)."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.device.type == "cpu":
            return t.clone()
        on_card.append(t.device)
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v, on_card) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v, on_card) for v in tree)
    return tree


def _snapshot(trainer, step: int, epoch: int) -> tuple[dict, dict]:
    """(g_, do_) trees of a GANTrainer at `step` in host memory, complete
    when this returns: later in-place updates of the trainer do not reach
    them."""
    on_card: list = []
    g = _host_copy({"generator": trainer.generator.state_dict()}, on_card)
    do = _host_copy({
        **{k: d.state_dict() for k, d in trainer.disc.items()},
        "optim_g": trainer.opt_g.state_dict(),
        "optim_d": trainer.opt_d.state_dict(),
        "steps": int(step),
        "epoch": int(epoch),
    }, on_card)
    for dev in set(on_card):
        torch.cuda.synchronize(dev)
    return g, do


def _save(obj, dst: str) -> None:
    tmp = dst + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, dst)   # a reader never sees a partial bundle


def _write(path: str, step: int, g: dict, do: dict, max_to_keep: int) -> None:
    os.makedirs(path, exist_ok=True)
    _save(g, os.path.join(path, f"g_{step:08d}"))
    _save(do, os.path.join(path, f"do_{step:08d}"))
    if max_to_keep:
        _rotate(path, "g_", max_to_keep)
        _rotate(path, "do_", max_to_keep)


def wait_for_checkpoints(barrier: bool = True) -> None:
    """Block until the asynchronous save in flight, if any, is written and
    rotated, and raise what its writer raised. Over a mesh every rank then
    meets at the barrier that tells the others rank 0's write is complete;
    barrier=False skips it where a rank leaves on an exception (the others
    may never reach it)."""
    with _PENDING_LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    for future, mesh, device in pending:
        try:
            if future is not None:
                future.result()
        finally:
            if barrier and mesh is not None:
                mesh_barrier(mesh, device)


def save_checkpoint(path: str, step: int, epoch: int, trainer, max_to_keep: int = 5,
                    async_save: bool = False) -> None:
    """Write g_/do_ bundles of a GANTrainer at `step`, then rotate; over a
    mesh rank 0 writes while the others wait. Waits for the save in flight
    first; with async_save, returns once the snapshot is taken and leaves
    the write to the background thread."""
    global _WRITER
    wait_for_checkpoints()
    mesh = getattr(trainer, "mesh", None)
    writer = mesh is None or dist.get_rank() == 0
    g, do = _snapshot(trainer, step, epoch) if writer else (None, None)
    if async_save:
        future = None
        if writer:
            if _WRITER is None:
                _WRITER = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="checkpoint-writer")
            future = _WRITER.submit(_write, path, step, g, do, max_to_keep)
        with _PENDING_LOCK:
            _PENDING.append((future, mesh, trainer.device))
        return
    if writer:
        _write(path, step, g, do, max_to_keep)
    if mesh is not None:
        mesh_barrier(mesh, trainer.device)


def restore_checkpoint(path: str, trainer) -> tuple[int, int]:
    """Load the newest g_/do_ pair into the trainer. Returns (next step,
    epoch), or (0, -1) when there is none (train_tf_wi_inv.py:65-93).
    Waits for the save in flight first."""
    wait_for_checkpoints()
    cp_g, cp_do = scan_checkpoint(path, "g_"), scan_checkpoint(path, "do_")
    if cp_g is None or cp_do is None:
        return 0, -1
    g = torch.load(cp_g, map_location=trainer.device, weights_only=True)
    do = torch.load(cp_do, map_location=trainer.device, weights_only=True)
    trainer.generator.load_state_dict(g["generator"])
    for k, d in trainer.disc.items():
        d.load_state_dict(do[k])
    trainer.opt_g.load_state_dict(do["optim_g"])
    trainer.opt_d.load_state_dict(do["optim_d"])
    return int(do["steps"]) + 1, int(do["epoch"])

