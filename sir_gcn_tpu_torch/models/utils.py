"""Shared model utilities (port of ``sir_gcn_tpu/models/utils.py``; the
reference's ``models/utils.py``): for now the MLP. VirtualNode and
CentralityEncoder are not yet ported."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .layers import Linear, dropout
from .norm import get_norm


class MLP(nn.Module):
    """N-layer MLP with a norm and an activation after each layer and
    dropout at the end (reference ``models/utils.py:7-43``).
    ``include_last=False`` leaves norm and activation off the last layer.
    ``with_graph`` selects the ``(graph, feats)`` call signature and the
    graph-aware norms, else ``(feats)``. Norms 'bn' and 'none'."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, dropout: float = 0.0, norm: str = "none",
                 activation: Callable[[torch.Tensor], torch.Tensor]
                 = torch.relu,
                 include_last: bool = True, with_graph: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.activation = activation
        self.with_graph = with_graph
        dims = ([input_dim] + [hidden_dim] * (num_layers - 1)
                + [output_dim])
        self.linears = nn.ModuleList(
            Linear(dims[i], dims[i + 1], generator=generator)
            for i in range(num_layers))
        normed = num_layers if include_last else num_layers - 1
        self.norms = nn.ModuleList(
            get_norm(norm, with_graph, dims[i + 1]) for i in range(normed))

    def forward(self, *args, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if self.with_graph:
            graph, feats = args
        else:
            (feats,) = args
        for i, linear in enumerate(self.linears):
            feats = linear(feats)
            if i < len(self.norms):
                norm = self.norms[i]
                feats = (norm(graph, feats) if self.with_graph
                         else norm(feats))
                feats = self.activation(feats)
        return dropout(feats, self.dropout, self.training, generator)
