"""ogbn-arxiv task model (port of ``experiments/ogbn_arxiv/model.py``):
the EGC-style SIRModel of the reference
(``benchmark-datasets/ogbn-arxiv/model.py:42-75``).

Per layer: SIRConv -> norm -> leaky_relu(0.2) -> dropout (+ residual),
then a linear readout; in training, ``edge_dropout`` draws a fresh DropEdge
mask for each layer. Jumping knowledge and MLP residuals are not yet
ported and raise.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...graph import drop_edge_mask
from ...models import Linear, SIRConv, get_norm
from ...models.layers import dropout as apply_dropout
from ...ops.ell import leaky_relu

leaky_relu02 = leaky_relu(0.2)


class SIRModel(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 1, input_dropout: float = 0.0,
                 edge_dropout: float = 0.0, dropout: float = 0.0,
                 norm: str = "none", jumping_knowledge: bool = False,
                 residual: bool = False, resid_layers: int = 0,
                 feat_dropout: float = 0.0, agg_type: str = "mean",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if jumping_knowledge:
            raise NotImplementedError(
                "jumping-knowledge readouts are not yet ported")
        if residual and resid_layers > 0:
            raise NotImplementedError("MLP residuals are not yet ported")
        self.input_dropout = input_dropout
        self.edge_dropout = edge_dropout
        self.dropout = dropout
        self.residual = residual
        self.embedding = Linear(input_dim, hidden_dim, generator=generator)
        self.convs = nn.ModuleList(
            SIRConv(hidden_dim, hidden_dim, hidden_dim, leaky_relu02,
                    feat_dropout, agg_type=agg_type, generator=generator)
            for _ in range(num_layers))
        self.norms = nn.ModuleList(
            get_norm(norm, True, hidden_dim) for _ in range(num_layers))
        self.readout = Linear(hidden_dim, output_dim, generator=generator)

    def forward(self, graph, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [N_pad, output_dim]. In training mode dropout and each
        layer's DropEdge mask draw from ``generator`` (on the graph's
        device) and BatchNorm updates its running statistics; in eval mode,
        or at edge dropout 0, the convs get no mask and keep the static
        scales."""
        act = leaky_relu02
        x = self.embedding(apply_dropout(feats, self.input_dropout,
                                         self.training, generator))
        for conv, norm in zip(self.convs, self.norms):
            emask = None
            if self.edge_dropout > 0 and self.training:
                emask = drop_edge_mask(generator, graph, self.edge_dropout)
            resid = x if self.residual else None
            x = conv(graph, x, edge_mask=emask, generator=generator)
            x = apply_dropout(act(norm(graph, x)), self.dropout,
                              self.training, generator)
            if resid is not None:
                x = x + resid
        return self.readout(x)
