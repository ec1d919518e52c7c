"""The collectives of data and sequence parallelism.

* `all_reduce_mean_`: the mean over every rank of a mesh, in place, as one
  flat buffer a call; the trainer averages the gradients with it after each
  backward and before the optimizer step, and the step's metrics after it.
  Over a 2-D mesh it sums over "seq", then over "data", then divides.
* `all_to_all_dims`, `all_gather_dim`: BSRNN's switch between band-local and
  frame-local layouts and the final gather, differentiable. Their backward
  is the transposed exchange, so the gather's backward sums the gradient
  that every rank of the group sends back for a slice: with a loss that
  each seq rank computes on the whole (replicated) spectrum, each rank's
  trunk gradient is `sp` times its slice's share, and the mean over the
  whole mesh gives the one-process gradient for every parameter, sliced
  or replicated.
* `split_sizes`: uneven splits are the rule (34 bands over 4 ranks, 33
  frames over 2): the first n % k ranks take one more. The exchanges pass
  every chunk's size (all_to_all_single with split sizes), so nothing is
  padded.

Under gloo a CUDA tensor is staged through host memory for the collective
and copied back (gloo's collectives take CPU tensors; ranks that share one
card run over gloo); bfloat16 travels as float32 there, which is exact.
Under NCCL tensors stay on the card.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def split_sizes(n: int, k: int) -> list[int]:
    """n items over k ranks, the first n % k ranks one more."""
    return [n // k + (1 if i < n % k else 0) for i in range(k)]


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    if t.is_cuda and _gloo(group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)


def _mesh_all_reduce_(t: torch.Tensor, mesh: DeviceMesh, op=dist.ReduceOp.SUM) -> None:
    for dim in range(mesh.ndim):
        if mesh.size(dim) > 1:
            _all_reduce_(t, mesh.get_group(dim), op)


def all_reduce_mean_(tensors: list[torch.Tensor], mesh: DeviceMesh) -> None:
    """Replace each tensor by its mean over the ranks of `mesh`, in place;
    one flat float32 buffer per call."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    _mesh_all_reduce_(flat, mesh)
    flat /= mesh.size()
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def mesh_barrier(mesh: DeviceMesh, device: torch.device) -> None:
    """Wait until every rank of the mesh has arrived (one all-reduce a dim)."""
    all_reduce_mean_([torch.zeros(1, device=device)], mesh)


def _all_to_all_single(x: torch.Tensor, out_splits: list[int], in_splits: list[int],
                       group) -> torch.Tensor:
    staged = x.is_cuda and _gloo(group)
    src = x.float().cpu() if staged else x.contiguous()
    out = torch.empty(sum(out_splits), dtype=src.dtype, device=src.device)
    dist.all_to_all_single(out, src, out_splits, in_splits, group=group)
    return out.to(x.device, x.dtype) if staged else out


class _AllToAll(torch.autograd.Function):
    """1-D all_to_all_single; its backward sends the gradient chunks back."""

    @staticmethod
    def forward(ctx, x, out_splits, in_splits, group):
        ctx.splits, ctx.group = (out_splits, in_splits), group
        return _all_to_all_single(x, out_splits, in_splits, group)

    @staticmethod
    def backward(ctx, grad):
        out_splits, in_splits = ctx.splits
        grad = _all_to_all_single(grad.contiguous(), in_splits, out_splits, ctx.group)
        return grad, None, None, None


def _exchange(pieces: list[torch.Tensor], shapes: list[tuple], dim: int, group) -> torch.Tensor:
    """Send pieces[j] to rank j of `group`; receive from rank j a tensor of
    shapes[j]; concatenate what came in along `dim`."""
    flat = torch.cat([p.reshape(-1) for p in pieces])
    out_splits = [math.prod(s) for s in shapes]
    y = _AllToAll.apply(flat, out_splits, [p.numel() for p in pieces], group)
    return torch.cat([c.view(s) for c, s in zip(y.split(out_splits), shapes)], dim=dim)


def local_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of x along `dim` (`split_sizes` over the group)."""
    sizes = split_sizes(x.shape[dim], dist.get_world_size(group))
    r = dist.get_rank(group)
    return x.narrow(dim, sum(sizes[:r]), sizes[r])


def all_to_all_dims(x: torch.Tensor, scatter_dim: int, gather_dim: int, gather_size: int,
                    group) -> torch.Tensor:
    """x holds all of `scatter_dim` and this rank's chunk of `gather_dim`
    (whose full length is gather_size); -> this rank's chunk of
    `scatter_dim` and all of `gather_dim`, in rank order. Differentiable."""
    k, r = dist.get_world_size(group), dist.get_rank(group)
    s_sizes = split_sizes(x.shape[scatter_dim], k)
    g_sizes = split_sizes(gather_size, k)
    pieces = list(x.split(s_sizes, dim=scatter_dim))
    shapes = []
    for j in range(k):
        s = list(x.shape)
        s[scatter_dim], s[gather_dim] = s_sizes[r], g_sizes[j]
        shapes.append(tuple(s))
    return _exchange(pieces, shapes, gather_dim, group)


def all_gather_dim(x: torch.Tensor, dim: int, full_size: int, group) -> torch.Tensor:
    """x is this rank's chunk of `dim` (full length full_size); -> the whole
    of it on every rank, in rank order. Differentiable: the backward sums,
    for each rank's chunk, the gradients that all ranks hold for it."""
    k = dist.get_world_size(group)
    shapes = []
    for size in split_sizes(full_size, k):
        s = list(x.shape)
        s[dim] = size
        shapes.append(tuple(s))
    return _exchange([x] * k, shapes, dim, group)


def replicated(tensors: list[torch.Tensor], mesh: DeviceMesh) -> bool:
    """True when every rank of the mesh holds the same values (compared by
    their float64 sum and sum of squares, bitwise across ranks); every rank
    gets the same answer."""
    t = [x.detach().double() for x in tensors]
    mine = torch.stack([sum(x.sum() for x in t), sum((x * x).sum() for x in t)])
    both = torch.cat([mine, -mine])
    _mesh_all_reduce_(both, mesh, dist.ReduceOp.MAX)
    return bool(torch.equal(both[:2], mine) and torch.equal(-both[2:], mine))
