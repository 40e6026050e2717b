"""The collectives of the distributed paths, on ``torch.distributed``
(NCCL on cards, gloo on the CPU), with the autograd transposes that XLA
derives for the JAX package's ``psum``, ``all_gather``, ``psum_scatter`` and
``all_to_all``. A group of one rank needs no communication: each
collective returns its input (as the JAX package elides collectives over a
mesh axis of size 1)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

# torch 2.13 renames the two tensor collectives; 2.11 has only the old names
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def world_size(group=None) -> int:
    """The group's size; 1 without a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank_of(group=None) -> int:
    """This process's rank in the group; 0 without a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, in a new tensor (no
    gradient)."""
    out = x.detach().clone()
    if world_size(group) > 1:
        dist.all_reduce(out, group=group)
    return out


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """[S * B, ...] in S blocks of B rows, block d for rank d -> the same
    shape, block j the one rank j sent here: the JAX package's tiled
    ``all_to_all`` over axis 0. It is its own transpose."""
    if world_size(group) == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """[B, ...] on each rank -> [S * B, ...], block j rank j's."""
    s = world_size(group)
    if s == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((s * x.shape[0],) + tuple(x.shape[1:]))
    _ALL_GATHER(out, x, group=group)
    return out


def reduce_scatter_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """[S * B, ...] on each rank -> [B, ...], rank r's block r summed over
    the ranks: the transpose of :func:`all_gather_rows`."""
    s = world_size(group)
    if s == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // s,) + tuple(x.shape[1:]))
    _REDUCE_SCATTER(out, x, group=group)
    return out


class _RankSum(torch.autograd.Function):
    """Sum over the ranks; its transpose sums the cotangents over the
    ranks, the gradient of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def rank_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the group's ranks (``psum``)."""
    if world_size(group) == 1:
        return x
    return _RankSum.apply(x, group)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g, ctx.group), None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable :func:`all_gather_rows`; the backward is the
    reduce-scatter of the cotangent."""
    if world_size(group) == 1:
        return x
    return _AllGatherRows.apply(x, group)


def _floats(tensors) -> list:
    return [t for t in tensors if t is not None and t.is_floating_point()]


def _coalesced(tensors: list, group, scale: Optional[float]) -> None:
    """Sum each tensor in place over the ranks (one collective per dtype
    and device), then multiply by ``scale``."""
    if world_size(group) == 1 or not tensors:
        return
    by_kind: dict = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for group_ts in by_kind.values():
        flat = torch.cat([t.reshape(-1) for t in group_ts])
        dist.all_reduce(flat, group=group)
        if scale is not None:
            flat.mul_(scale)
        for t, v in zip(group_ts, flat.split([t.numel() for t in group_ts])):
            t.copy_(v.view_as(t))


def sum_gradients(module: torch.nn.Module, group=None,
                  average: bool = False) -> None:
    """Sum (``average``: average) every parameter gradient over the
    group's ranks, in place."""
    grads = _floats(p.grad for p in module.parameters())
    _coalesced(grads, group, 1.0 / world_size(group) if average else None)


def average_buffers(module: torch.nn.Module, group=None) -> None:
    """Average every floating-point buffer (BatchNorm's running statistics)
    over the group's ranks, in place (``pmean``)."""
    with torch.no_grad():
        _coalesced(_floats(module.buffers()), group,
                   1.0 / world_size(group))
