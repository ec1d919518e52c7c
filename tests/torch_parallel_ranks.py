"""Rank workers of tests/test_torch_port_parallel.py.

They live in a module of their own so that the ranks, fresh processes started
by nvse_tpu_torch.parallel.spawn, can import them: a spawned child inherits
the parent's sys.path, which holds this directory under pytest.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from nvse_tpu_torch.parallel import get_mesh, replicated, shard_batch
from nvse_tpu_torch.parallel.dryrun import trainer_state


def _moments(opt, module, key):
    return {n: opt.state[p][key].detach().cpu() for n, p in module.named_parameters()
            if key in opt.state.get(p, {})}


def trainer_result(tr, metrics: dict) -> dict:
    """{"metrics": a step's metrics, "generator", "disc" (state dicts), "mu_g",
    "mu_d", "nu_g", "nu_d" (AdamW's moments by parameter name)}, on the CPU."""
    cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}     # noqa: E731
    return {"metrics": metrics, "generator": cpu(tr.generator.state_dict()),
            "disc": cpu(tr.disc.state_dict()),
            "mu_g": _moments(tr.opt_g, tr.generator, "exp_avg"),
            "mu_d": _moments(tr.opt_d, tr.disc, "exp_avg"),
            "nu_g": _moments(tr.opt_g, tr.generator, "exp_avg_sq"),
            "nu_d": _moments(tr.opt_d, tr.disc, "exp_avg_sq")}


def step_on_mesh(dev, h: dict, shape: tuple, batch, out: str, state: str | None = None,
                 joint: bool = False, task: str | None = None,
                 ranks: list[int] | None = None) -> None:
    """Rank worker: a GANTrainer over a mesh of `shape` ((n_data,) or
    (n_data, n_seq)) on `ranks` (default the first ones of the world; a rank
    outside them only joins the mesh), weights from the seed or from
    `state` (a torch.save'd {"generator": ..., "disc": ...}), one step on
    the rank's rows of `batch` (the global batch, numpy; joint: the (clean,
    input) pair and `task`). Raises unless parameters, buffers and
    optimizer states end equal on every rank. Rank 0 of the mesh writes
    trainer_result to `out`."""
    from nvse_tpu_torch.train import GANTrainer, fetch_scalars
    from nvse_tpu_torch.utils import AttrDict

    n = math.prod(shape)
    mesh = get_mesh(n, shape[1] if len(shape) > 1 else 1, dev, ranks=ranks)
    if mesh.get_coordinate() is None:
        return
    h = AttrDict(h)
    tr = GANTrainer(h, device=dev, steps_per_epoch=10, joint=joint, mesh=mesh)
    if state is not None:
        sd = torch.load(state, map_location="cpu", weights_only=True)
        tr.generator.load_state_dict(sd["generator"])
        tr.disc.load_state_dict(sd["disc"])
    rows = shard_batch(tuple(torch.from_numpy(np.asarray(b)) for b in
                             (batch if joint else (batch,))), mesh)
    args = (*rows, task) if joint else rows
    metrics = fetch_scalars(tr.step(*[a.to(dev) if isinstance(a, torch.Tensor) else a
                                      for a in args]))
    if not replicated(trainer_state(tr), mesh):
        raise AssertionError("parameters, buffers or optimizer states differ between ranks")
    if dist.get_rank() == mesh.mesh.flatten()[0].item():
        torch.save(trainer_result(tr, metrics), out)


def run_training(dev, h: dict) -> None:
    """Rank worker: the training loop (train/loop.py train) on this rank."""
    from nvse_tpu_torch.train import train
    from nvse_tpu_torch.utils import AttrDict

    train(AttrDict(h), device=dev)


def run_jobs(dev, jobs: list[tuple]) -> None:
    """Rank worker: worker(dev, **kwargs) for each (worker, kwargs) of `jobs`
    in turn (step_on_mesh, each on its own mesh, or run_training)."""
    for worker, kwargs in jobs:
        worker(dev, **kwargs)
