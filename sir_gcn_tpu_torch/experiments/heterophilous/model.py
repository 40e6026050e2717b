"""Heterophilous-datasets task model (port of
``experiments/heterophilous/model.py``; reference
``benchmark-datasets/heterophilous-datasets/model.py:12-55``): pre-norm
residual blocks. An input linear and GELU, then per layer
norm -> SIRConv -> dropout -> GELU -> linear -> dropout (+ residual);
an output norm and linear.

GELU is the exact erf form throughout (torch's ``nn.GELU`` default, JAX's
``gelu_exact``): inside each ``SIRConv`` the registry's ``gelu()``, which
runs on the elementwise kernels (or max's) on a FastGraph; between the
blocks ``F.gelu`` on a dense tensor. ``use_bf16`` (``--use-amp``) rounds
the input features to bf16; the input linear promotes them back to f32,
as flax's ``nn.Dense`` does, so all compute stays f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...models import Linear, SIRConv, get_norm
from ...models.layers import dropout as apply_dropout
from ...ops.ell import gelu


class SIRModel(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 1, input_dropout: float = 0.0,
                 dropout: float = 0.0, norm: str = "none",
                 residual: bool = False, feat_dropout: float = 0.0,
                 agg_type: str = "mean", use_bf16: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dropout = input_dropout
        self.dropout = dropout
        self.residual = residual
        self.use_bf16 = use_bf16
        self.input_linear = Linear(input_dim, hidden_dim, generator=generator)
        self.norms = nn.ModuleList(
            get_norm(norm, True, hidden_dim) for _ in range(num_layers + 1))
        self.convs = nn.ModuleList(
            SIRConv(hidden_dim, hidden_dim, hidden_dim, gelu(), feat_dropout,
                    agg_type=agg_type, generator=generator)
            for _ in range(num_layers))
        self.linears = nn.ModuleList(
            Linear(hidden_dim, hidden_dim, generator=generator)
            for _ in range(num_layers))
        self.output_linear = Linear(hidden_dim, output_dim,
                                    generator=generator)

    def forward(self, graph, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [N_pad, output_dim] f32. In training mode dropout draws
        from ``generator`` (on the graph's device) and BatchNorm updates
        its running statistics."""
        if self.use_bf16:
            feats = feats.to(torch.bfloat16)
        x = apply_dropout(self.input_linear(feats), self.input_dropout,
                          self.training, generator)
        x = F.gelu(x)
        for norm, conv, linear in zip(self.norms, self.convs, self.linears):
            h = conv(graph, norm(graph, x), generator=generator)
            h = F.gelu(apply_dropout(h, self.dropout, self.training,
                                     generator))
            h = apply_dropout(linear(h), self.dropout, self.training,
                              generator)
            x = h + x if self.residual else h
        return self.output_linear(self.norms[-1](graph, x)).float()
