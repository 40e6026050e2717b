"""Data parallelism over batched-graph workloads (port of
``sir_gcn_tpu/parallel/data_parallel.py``).

Each rank trains on its own padded ``GraphBatch`` (local node ids, so no
gather crosses ranks); the loss and the parameter gradients are averaged
over the ranks before the optimizer steps, and the stateful step also
averages the floating-point buffers (BatchNorm's running statistics), the
cross-replica treatment of the JAX package's ``pmean``. Parameters and the
optimizer state stay replicated: every rank starts from the same weights
and applies the same averaged gradients.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np
import torch

from .collectives import (
    all_reduce_sum,
    average_buffers,
    sum_gradients,
    world_size,
)


def _make_step(model: torch.nn.Module, loss_fn: Callable,
               optimizer: torch.optim.Optimizer, group, stateful: bool):
    def step(batch, generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, generator)
        loss.backward()
        sum_gradients(model, group, average=True)
        if stateful:
            average_buffers(model, group)
        optimizer.step()
        return all_reduce_sum(loss, group) / world_size(group)

    return step


def make_dp_train_step(model: torch.nn.Module, loss_fn: Callable,
                       optimizer: torch.optim.Optimizer, group=None):
    """``step(batch, generator) -> mean loss``: ``loss_fn(model, batch,
    generator)`` on this rank's batch, gradients averaged over the group's
    ranks, one optimizer step. Every rank calls it, each with its own
    batch."""
    return _make_step(model, loss_fn, optimizer, group, stateful=False)


def make_dp_train_step_stateful(model: torch.nn.Module, loss_fn: Callable,
                                optimizer: torch.optim.Optimizer,
                                group=None):
    """:func:`make_dp_train_step` that also averages the model's
    floating-point buffers (BatchNorm's running statistics, updated by
    each rank's forward) over the ranks."""
    return _make_step(model, loss_fn, optimizer, group, stateful=True)


def rank_batches(order: np.ndarray, batch_size: int, rank: int,
                 world: int) -> Iterator[tuple]:
    """Split the index ``order`` into batches of ``batch_size`` and deal
    them out as the JAX harness stacks them: of each run of ``world``
    consecutive batches, batch i * world + r goes to rank r, as
    ``("dp", indices)``; the last fewer than ``world`` batches go to every
    rank, as ``("all", indices)``, for the same step on each."""
    batches = [order[s:s + batch_size]
               for s in range(0, len(order), batch_size)]
    full = len(batches) - len(batches) % world
    for i in range(rank, full, world):
        yield "dp", batches[i]
    for sel in batches[full:]:
        yield "all", sel
