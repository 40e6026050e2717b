"""Shared low-level layers (port of ``sir_gcn_tpu/models/layers.py``).

``Linear`` keeps the reference's PyTorch default scales: weight and bias
both U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn from an explicit generator;
``Embed`` PyTorch's N(0, 1) for an embedding table.
"""

from __future__ import annotations

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


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout with an explicit generator (on ``x``'s device);
    rate 0 or eval mode returns ``x``."""
    if p == 0.0 or not training:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return torch.where(keep > 0, x / (1.0 - p), torch.zeros_like(x))
