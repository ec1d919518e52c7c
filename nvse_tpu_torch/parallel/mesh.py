"""Process groups and device meshes for data and sequence parallelism.

Counterpart of nvse_tpu/parallel/mesh.py. The JAX package runs one
program over a `jax.sharding.Mesh` of local (or global) devices; here
every card is a process of its own, started by torchrun (or by
`spawn`), and the mesh is a `torch.distributed.device_mesh.DeviceMesh`
over those processes' ranks with the JAX mesh's axis names: a 1-D
("data",) mesh, or a 2-D ("data", "seq") one whose "seq" axis is the
minor one, as `get_mesh(n, n_seq)` lays out the JAX devices. Batches
are split over "data" (`shard_batch`), parameters and optimizer states
are replicated, and the gradient all-reduce is explicit
(parallel/collectives.py). The "seq" axis carries BSRNN's dual-path
sequence parallelism (models/bsrnn.py).

NCCL joins ranks on the card when every rank of a node has a card of its
own; ranks that share a card (more ranks than cards on a node, as on a
one-card machine) and ranks on the CPU join over gloo.

Serving is one process: `local_devices` lists the replicas' devices
(infer/engine.py).
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import resolve_device

DATA_AXIS = "data"
SEQ_AXIS = "seq"
# a collective that waits longer than this fails the rank (and the run)
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def node_shape() -> tuple[int, int]:
    """(nodes, ranks a node) of this job: the process group's world (or
    torchrun's WORLD_SIZE before it is joined) over LOCAL_WORLD_SIZE (one
    node without it); (1, 1) for one process."""
    world = dist.get_world_size() if dist.is_initialized() else _env_int("WORLD_SIZE", 1)
    local = _env_int("LOCAL_WORLD_SIZE", world)
    if world % local:
        raise ValueError(f"WORLD_SIZE={world} is not a multiple of LOCAL_WORLD_SIZE={local}")
    return world // local, local


def backend_for(device: torch.device, local_world: int) -> str:
    """NCCL when each rank of a node has a card of its own, else gloo."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(device: str | torch.device = "cuda", *, rank: int | None = None,
                     world_size: int | None = None, local_rank: int | None = None,
                     local_world_size: int | None = None, init_method: str | None = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the job's process group and return this rank's device.

    The rank, world size and local rank default to torchrun's RANK,
    WORLD_SIZE, LOCAL_RANK and LOCAL_WORLD_SIZE, the rendezvous to its
    MASTER_ADDR / MASTER_PORT ("env://"); `spawn` passes them with a
    file:// rendezvous. A world of one joins nothing. On the card the
    rank takes card LOCAL_RANK (modulo the node's cards where ranks share
    them), set with torch.cuda.set_device before any other CUDA call.
    Every collective of the group fails after `timeout`. A process that
    has joined already keeps its group and its card.
    """
    dev = torch.device(device)
    if dist.is_initialized():
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return resolve_device(dev)
    rank = _env_int("RANK", 0) if rank is None else rank
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    local_rank = _env_int("LOCAL_RANK", rank) if local_rank is None else local_rank
    if local_world_size is None:
        local_world_size = _env_int("LOCAL_WORLD_SIZE", world_size)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            resolve_device(dev)                      # raises: no card visible
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dev = resolve_device(dev)
    if world_size > 1:
        dist.init_process_group(backend_for(dev, local_world_size),
                                init_method=init_method or "env://", rank=rank,
                                world_size=world_size, timeout=timeout)
    return dev


def get_mesh(n: int | None = None, n_seq: int = 1, device: str | torch.device = "cpu",
             ranks: list[int] | None = None) -> DeviceMesh:
    """A ("data",) mesh over n ranks, or a ("data", "seq") mesh of
    (n / n_seq, n_seq) with "seq" minor, as the JAX get_mesh lays out its
    devices. The ranks are `ranks` when given, else the first n of the
    world (n defaults to the world). Every rank of the world calls it; a
    rank outside the mesh gets a mesh whose get_coordinate() is None."""
    ranks = list(range(dist.get_world_size() if n is None else n)) if ranks is None else ranks
    if len(ranks) % n_seq:
        raise ValueError(f"{len(ranks)} ranks not divisible by n_seq={n_seq}")
    ids = torch.tensor(ranks, dtype=torch.int64)
    device_type = torch.device(device).type
    if n_seq > 1:
        return DeviceMesh(device_type, ids.reshape(-1, n_seq), mesh_dim_names=(DATA_AXIS, SEQ_AXIS))
    return DeviceMesh(device_type, ids, mesh_dim_names=(DATA_AXIS,))


def axis_size(mesh: DeviceMesh | None, axis: str) -> int:
    """Ranks along `axis` (1 without a mesh or without that axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh | None, axis: str) -> int:
    """This rank's index along `axis` (0 without a mesh or that axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def seq_group(mesh: DeviceMesh | None):
    """The "seq" process group of this rank, or None without sequence parallelism."""
    return mesh.get_group(SEQ_AXIS) if axis_size(mesh, SEQ_AXIS) > 1 else None


def local_devices(device: str | torch.device, n: int) -> list[torch.device]:
    """The devices of n serving replicas: cuda:0 ... cuda:n-1 (n = -1: every
    card; no more than there are), or n times the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * max(1, n)
    count = torch.cuda.device_count()
    n = count if n == -1 else min(n, count)
    return [torch.device("cuda", i) for i in range(max(1, n))]


def shard_batch(batch, mesh: DeviceMesh | None, nodes: int = 1):
    """This rank's rows of a batch (axis 0 of a tensor or array, or of each
    one of a tuple): data rank r of n takes rows [r b, (r + 1) b), b = len / n.
    `batch` is the batch of this rank's node: with `nodes` > 1 the node's
    data ranks split it among themselves. Seq ranks take the same rows."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh, nodes) for b in batch)
    n = axis_size(mesh, DATA_AXIS) // nodes
    if n == 1:
        return batch
    r = axis_rank(mesh, DATA_AXIS) % n
    if len(batch) % n:
        raise ValueError(f"a batch of {len(batch)} rows does not split over {n} data ranks")
    b = len(batch) // n
    return batch[r * b:(r + 1) * b]


def spawn(fn: Callable, nprocs: int, args: tuple = (), device: str = "cuda",
          timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Run fn(rank_device, *args) in nprocs fresh processes that form one
    job (a file:// rendezvous in a temporary directory, one node), and
    return when every rank has; a rank that raises fails the call. The
    ranks run on the card unless the caller passes device="cpu"; without a
    visible card the call raises before any process starts. On the CPU
    each rank runs one intra-op thread."""
    import torch.multiprocessing as mp

    resolve_device(device)

    with tempfile.TemporaryDirectory(prefix="nvse_dist_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(_rank_main, args=(nprocs, init, device, timeout, fn, args),
                           nprocs=nprocs, join=True, start_method="spawn")


def _rank_main(rank, nprocs, init, device, timeout, fn, args):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dev = init_distributed(device, rank=rank, world_size=nprocs, local_rank=rank,
                           local_world_size=nprocs, init_method=init, timeout=timeout)
    try:
        fn(dev, *args)
    finally:
        dist.destroy_process_group()
