"""Multi-rank dry run of the port: the counterpart of
__graft_entry__.dryrun_multichip.

    python -m nvse_tpu_torch.parallel.dryrun --n 4 [--device cpu] [--counts PATH]

Spawns n ranks (one job, `spawn`: NCCL with a card a rank where the machine
has n cards, else gloo; `--device cpu` runs them on the CPU over gloo) and
checks, on the tiny T-F BSRNN of __graft_entry__.py:141-150 (feature_dim 16,
one BSNet, MPD periods 2 and 3 + MRD, batch n x 2048 samples):
  1. one data-parallel GAN step over n ranks: G and D finite, parameters,
     AdamW states and buffers equal on every rank;
  2. (n >= 4 and even) one dp x sp step over an (n / 2, 2) mesh from the
     same weights and batch, BSRNN's trunk sequence-parallel: G and D within
     1e-3 relative of the DP step's;
  3. one more dp x sp step, a checkpoint saved by rank 0, restored on every
     rank into a fresh trainer, and the continuation step of the original
     and the first step of the restored one: G and D within 1e-5 (relative to
     max(1, |G|), as the JAX dry run).
Exits nonzero when a check or a rank fails. `--counts PATH` writes the
launches of every kernel wrapper per shape, summed over the ranks, as JSON.

`step_on_mesh` (one trainer over a mesh, a step on the rank's rows, the
result written by rank 0) and `run_training` (the training loop) are the rank
workers of the CPU tests.
"""
from __future__ import annotations

import argparse
import ast
import glob
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .collectives import replicated
from .mesh import get_mesh, shard_batch, spawn

# __graft_entry__.py:141-150, batch = the rank count
DRYRUN_CONFIG = dict(
    model_name="BSRNN", feature_dim=16, num_repeat=1, dropout=0.0, causal=False,
    sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024, num_mels=80, fmin=0,
    fmax=8000, segment_size=2048, learning_rate=2e-4, adam_b1=0.8, adam_b2=0.99,
    lr_decay=0.999, mrd_weight=0.1, mpd_reshapes=[2, 3])


def trainer_state(tr) -> list[torch.Tensor]:
    """Every tensor that one step replicates: parameters, buffers (the MSD's
    u) and both AdamW states."""
    out = [*tr.generator.state_dict().values(), *tr.disc.state_dict().values()]
    for opt in (tr.opt_g, tr.opt_d):
        for st in opt.state.values():
            out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return out


def launch_counts() -> dict:
    """This process's kernel launches per wrapper and shape (str keys)."""
    from ..ops._measure import counted_wrappers

    return {k: {repr(s): c for s, c in fn.launches_by_shape.items()}
            for k, fn in counted_wrappers().items() if fn.launches_by_shape}


def merge_counts(counts: list[dict]) -> dict:
    """Launch counts of several ranks (launch_counts' dicts, shapes as their
    repr), summed per wrapper and shape, with tuple keys."""
    total: dict = {}
    for one in counts:
        for k, d in one.items():
            for s, c in d.items():
                key = ast.literal_eval(s)
                total.setdefault(k, {})[key] = total.get(k, {}).get(key, 0) + c
    return total


def _close(a: float, b: float, rel: float, floor: float = 0.0) -> bool:
    return abs(a - b) <= rel * max(abs(b), floor)


def _dryrun_rank(dev, n: int, ckdir: str, counts: str | None) -> None:
    from ..train import GANTrainer, fetch_scalars, restore_checkpoint, save_checkpoint
    from ..utils import AttrDict

    t0 = time.monotonic()
    rank = dist.get_rank()

    def phase(msg: str) -> None:
        if rank == 0:
            print(f"[dryrun +{time.monotonic() - t0:7.1f}s] {msg}", flush=True)

    h = AttrDict(dict(DRYRUN_CONFIG, batch_size=n))
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((0.1 * rng.standard_normal((n, h.segment_size))).astype(np.float32))
    mesh = get_mesh(n, device=dev)
    phase(f"DP trainer over {n} ranks ({dist.get_backend()}, {dev.type})")
    tr = GANTrainer(h, device=dev, steps_per_epoch=10, mesh=mesh)
    m = fetch_scalars(tr.step(shard_batch(audio, mesh).to(dev)))
    g, d = m["G"], m["D"]
    if not (math.isfinite(g) and math.isfinite(d)):
        raise AssertionError(f"DP step not finite: G={g} D={d}")
    if not replicated(trainer_state(tr), mesh):
        raise AssertionError("DP step: states differ between ranks")
    phase(f"dryrun({n}): one DP GAN step ok - G={g:.3f} D={d:.3f}")

    if n >= 4 and n % 2 == 0:
        mesh2 = get_mesh(n, n_seq=2, device=dev)
        tr2 = GANTrainer(h, device=dev, steps_per_epoch=10, mesh=mesh2)
        a2 = shard_batch(audio, mesh2).to(dev)
        m2 = fetch_scalars(tr2.step(a2))
        g2, d2 = m2["G"], m2["D"]
        if not (_close(g2, g, 1e-3) and _close(d2, d, 1e-3)):
            raise AssertionError(f"dp x sp step ({g2}, {d2}) off the DP step's ({g}, {d})")
        phase(f"dryrun({n}): one dp x sp (={n // 2}x2) GAN step ok - G={g2:.3f} D={d2:.3f} "
              "(matches DP)")
        tr2.step(a2)
        save_checkpoint(ckdir, 2, 0, tr2, max_to_keep=2)
        fresh = GANTrainer(h, device=dev, steps_per_epoch=10, mesh=mesh2)
        steps_r, _ = restore_checkpoint(ckdir, fresh)
        if steps_r != 3:
            raise AssertionError(f"restored at step {steps_r}, not 3")
        phase("checkpoint saved by rank 0, restored on every rank")
        m_cont = fetch_scalars(tr2.step(a2))
        m_res = fetch_scalars(fresh.step(a2))
        for k in ("G", "D"):
            if not _close(m_res[k], m_cont[k], 1e-5, floor=1.0):
                raise AssertionError(f"resumed {k}={m_res[k]} off the continued {m_cont[k]}")
        phase(f"dryrun({n}): multi-step dp x sp run + checkpoint save/restore ok - "
              f"resumed G={m_res['G']:.3f} matches {m_cont['G']:.3f}")
    if counts:
        with open(f"{counts}.rank{rank}", "w") as f:
            json.dump(launch_counts(), f)


def dryrun(n: int, device: str = "cuda", counts: str | None = None) -> None:
    """Spawn n ranks on `device` and run the checks; raises when one fails."""
    with tempfile.TemporaryDirectory(prefix="nvse_dryrun_") as ckdir:
        spawn(_dryrun_rank, n, args=(n, ckdir, counts), device=device)
    if counts:
        ranks = []
        for p in sorted(glob.glob(f"{counts}.rank*")):
            with open(p) as f:
                ranks.append(json.load(f))
            os.remove(p)
        merged = merge_counts(ranks)
        with open(counts, "w") as f:
            json.dump({k: {repr(s): c for s, c in d.items()} for k, d in merged.items()}, f)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m nvse_tpu_torch.parallel.dryrun")
    p.add_argument("--n", type=int, default=4, help="ranks (processes)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--counts", default=None,
                   help="write the ranks' kernel launches per wrapper and shape here (JSON)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("dryrun: no CUDA GPU visible; pass --device cpu for the CPU")
    dryrun(args.n, args.device, args.counts)


if __name__ == "__main__":
    main()
