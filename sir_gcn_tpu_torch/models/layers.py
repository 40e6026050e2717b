"""Shared low-level layers (port of ``sir_gcn_tpu/models/layers.py``).

``Linear`` keeps the reference's PyTorch default scales: weight and bias
both U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn from an explicit generator.
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
    U(+-1/sqrt(in_features)) from ``generator``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = uniform_parameter((out_features, in_features),
                                        in_features, generator)
        self.bias = (uniform_parameter((out_features,), in_features,
                                       generator) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout with an explicit generator (on ``x``'s device);
    rate 0 or eval mode returns ``x``."""
    if p == 0.0 or not training:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return torch.where(keep > 0, x / (1.0 - p), torch.zeros_like(x))
