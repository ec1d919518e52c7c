"""Checkpoints: the two-bundle g_/do_ layout with keep-N rotation.

Counterpart of nvse_tpu/train/checkpoint.py (Orbax there; torch.save
here, synchronously). Per save step two files, the reference repo's own
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

A trainer over a mesh (data / sequence parallelism) holds the same state on
every rank: rank 0 writes the bundles and the other ranks wait at a barrier
until they are complete; every rank restores from the same files, each onto
its own device.
"""
from __future__ import annotations

import glob
import os
import re

import torch
import torch.distributed as dist

from ..parallel import mesh_barrier


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


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _save(obj, dst: str) -> None:
    tmp = dst + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, dst)   # a reader never sees a partial bundle


def save_checkpoint(path: str, step: int, epoch: int, trainer, max_to_keep: int = 5) -> None:
    """Write g_/do_ bundles of a GANTrainer at `step`, then rotate; over a
    mesh rank 0 writes while the others wait."""
    mesh = getattr(trainer, "mesh", None)
    if mesh is None or dist.get_rank() == 0:
        _write(path, step, epoch, trainer, max_to_keep)
    if mesh is not None:
        mesh_barrier(mesh, trainer.device)


def _write(path: str, step: int, epoch: int, trainer, max_to_keep: int) -> None:
    os.makedirs(path, exist_ok=True)
    _save({"generator": _to_cpu(trainer.generator.state_dict())},
          os.path.join(path, f"g_{step:08d}"))
    _save(_to_cpu({
        **{k: d.state_dict() for k, d in trainer.disc.items()},
        "optim_g": trainer.opt_g.state_dict(),
        "optim_d": trainer.opt_d.state_dict(),
        "steps": int(step),
        "epoch": int(epoch),
    }), os.path.join(path, f"do_{step:08d}"))
    if max_to_keep:
        _rotate(path, "g_", max_to_keep)
        _rotate(path, "do_", max_to_keep)


def restore_checkpoint(path: str, trainer) -> tuple[int, int]:
    """Load the newest g_/do_ pair into the trainer. Returns (next step,
    epoch), or (0, -1) when there is none (train_tf_wi_inv.py:65-93)."""
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

