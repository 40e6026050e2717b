"""Shared low-level layers (port of ``sir_gcn_tpu/models/layers.py``).

``Linear`` keeps the reference's PyTorch default scales: weight and bias
both U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn from an explicit generator;
``Embed`` PyTorch's N(0, 1) for an embedding table.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def uniform_parameter(shape, fan_in: int,
                      generator: Optional[torch.Generator] = None
                      ) -> nn.Parameter:
    """A parameter of ``shape`` drawn U(+-1/sqrt(fan_in)) from
    ``generator``: PyTorch's default for Linear weights and biases, and
    flax's ``torch_kernel_init``."""
    u = torch.rand(*shape, generator=generator)
    return nn.Parameter((2.0 * u - 1.0) * (1.0 / math.sqrt(fan_in)))


class Linear(nn.Module):
    """``nn.Linear`` with weight [out, in] and bias [out], both drawn
    U(+-1/sqrt(in_features)) from ``generator``.

    An input of another floating type than the weight is promoted as flax's
    ``nn.Dense`` (``dtype=None``) promotes it: a bf16 input against f32
    weights is widened to f32 and the product is f32, so only the input's
    rounding to bf16 remains (the JAX package's ``use_bf16`` models)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = uniform_parameter((out_features, in_features),
                                        in_features, generator)
        self.bias = (uniform_parameter((out_features,), in_features,
                                       generator) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        weight, bias = self.weight.to(dtype), self.bias
        if bias is not None:
            bias = bias.to(dtype)
        return F.linear(x.to(dtype), weight, bias)


class Embed(nn.Module):
    """``nn.Embedding``'s table [num_embeddings, features] drawn N(0, 1)
    from ``generator``, as the parameter ``embedding``. ``padding_idx``
    pins that row to zero at init only, as the JAX package's ``Embed`` does
    (it still receives a gradient)."""

    def __init__(self, num_embeddings: int, features: int,
                 padding_idx: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        table = torch.randn(num_embeddings, features, generator=generator)
        if padding_idx is not None:
            table[padding_idx] = 0.0
        self.embedding = nn.Parameter(table)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


# (lo, hi, n) while node-indexed tensors hold rows lo:hi of n (one rank's
# shard of a node-partitioned graph); the same for edge-indexed ones
_ROW_SHARD: contextvars.ContextVar = contextvars.ContextVar("row_shard",
                                                           default=None)
_EDGE_SHARD: contextvars.ContextVar = contextvars.ContextVar("edge_shard",
                                                            default=None)


@contextlib.contextmanager
def row_shard(lo: int, hi: int, n: int, edges: Optional[tuple] = None):
    """Within the block, a random draw for a tensor of ``hi - lo`` rows
    (dropout's mask, :func:`rand_rows`) is made at the whole graph's ``n``
    rows and rows ``lo:hi`` are kept: each rank of a node-partitioned run
    draws what the single-device run draws for its rows, from the same
    generator state. ``edges`` (lo, hi, e) does the same for a draw over
    the rank's run of the whole graph's e edges (``dropout(...,
    edges=True)``)."""
    tokens = _ROW_SHARD.set((lo, hi, n)), _EDGE_SHARD.set(edges)
    try:
        yield
    finally:
        _EDGE_SHARD.reset(tokens[1])
        _ROW_SHARD.reset(tokens[0])


def _global_rows(shape, edges: bool = False) -> Optional[tuple]:
    shard = (_EDGE_SHARD if edges else _ROW_SHARD).get()
    if shard is None or len(shape) == 0 or shape[0] != shard[1] - shard[0]:
        return None
    return shard


def rand_rows(shape, generator: Optional[torch.Generator] = None,
              device=None) -> torch.Tensor:
    """``torch.rand(shape)``, drawn at the whole graph's rows under
    :func:`row_shard`."""
    shard = _global_rows(tuple(shape))
    if shard is None:
        return torch.rand(shape, generator=generator, device=device)
    lo, hi, n = shard
    return torch.rand((n,) + tuple(shape[1:]), generator=generator,
                      device=device)[lo:hi]


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None, *,
            edges: bool = False) -> torch.Tensor:
    """Inverted dropout with an explicit generator (on ``x``'s device);
    rate 0 or eval mode returns ``x``. Under :func:`row_shard` the mask is
    drawn at the whole graph's rows, or with ``edges`` (``x`` indexed by
    edges) at its edges."""
    if p == 0.0 or not training:
        return x
    shard = _global_rows(tuple(x.shape), edges)
    if shard is None:
        keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    else:
        lo, hi, n = shard
        keep = x.new_empty((n,) + tuple(x.shape[1:])).bernoulli_(
            1.0 - p, generator=generator)[lo:hi]
    return torch.where(keep > 0, x / (1.0 - p), torch.zeros_like(x))
