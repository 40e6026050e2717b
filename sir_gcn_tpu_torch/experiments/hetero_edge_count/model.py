"""HeteroEdgeCount task models (port of
``experiments/hetero_edge_count/model.py``; reference
``synthetic-datasets/hetero-edge-count/model.py``). ``SIRModel`` applies
its regression head before the sum pooling (model.py:32-34); the
baselines (``_PoolBaseline``) pool first (model.py:59-61)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...models import (
    MLP,
    Embed,
    GATv2Conv,
    GINConv,
    GraphConv,
    Linear,
    PNAConv,
    SAGEConv,
    SIRConv,
)
from ...models.layers import dropout as apply_dropout
from ...ops.pool import sum_pool


class SIRModel(nn.Module):
    """Class embedding, SIRConv stack with σ = ReLU, a bias-free
    regression per node, then the per-graph sum: [G_pad, output_dim]."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int = 1,
                 num_layers: int = 1, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.embedding = Embed(input_dim, hidden_dim, generator=generator)
        self.convs = nn.ModuleList(
            SIRConv(hidden_dim, hidden_dim, hidden_dim, torch.relu,
                    generator=generator)
            for _ in range(num_layers))
        self.regression = Linear(hidden_dim, output_dim, bias=False,
                                 generator=generator)

    def forward(self, graph, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.embedding(feats)
        for conv in self.convs:
            x = apply_dropout(conv(graph, x, generator=generator),
                              self.dropout, self.training, generator)
        return sum_pool(graph, self.regression(x))


class _PoolBaseline(nn.Module):
    """Embedding, the conv stack, the per-graph sum, then the bias-free
    regression (reference model.py:37-169); subclasses give the conv."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int = 1,
                 num_layers: int = 1, dropout: float = 0.0,
                 num_heads: int = 1, mlp_layers: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.embedding = Embed(input_dim, hidden_dim, generator=generator)
        self.convs = nn.ModuleList(
            self.conv(hidden_dim, num_heads, mlp_layers, generator)
            for _ in range(num_layers))
        self.regression = Linear(hidden_dim, output_dim, bias=False,
                                 generator=generator)

    def conv(self, h, num_heads, mlp_layers, generator) -> nn.Module:
        raise NotImplementedError

    def post(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def forward(self, graph, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.embedding(feats)
        for conv in self.convs:
            x = apply_dropout(self.post(conv(graph, x)), self.dropout,
                              self.training, generator)
        return self.regression(sum_pool(graph, x))


class GCNModel(_PoolBaseline):
    def conv(self, h, num_heads, mlp_layers, generator):
        return GraphConv(h, h, generator=generator)


class GATModel(_PoolBaseline):
    def conv(self, h, num_heads, mlp_layers, generator):
        return GATv2Conv(h, h, num_heads, generator=generator)

    def post(self, x):
        return x.mean(1)


class SAGEModel(_PoolBaseline):
    def conv(self, h, num_heads, mlp_layers, generator):
        return SAGEConv(h, h, generator=generator)


class GINModel(_PoolBaseline):
    def conv(self, h, num_heads, mlp_layers, generator):
        return GINConv(MLP(h, h, h, mlp_layers, 0.0, "none", torch.relu,
                           include_last=True, with_graph=False,
                           generator=generator))


class PNAModel(_PoolBaseline):
    def conv(self, h, num_heads, mlp_layers, generator):
        return PNAConv(h, h, generator=generator)


MODELS = {"SIR": SIRModel, "GCN": GCNModel, "SAGE": SAGEModel,
          "GAT": GATModel, "GIN": GINModel, "PNA": PNAModel}
