"""ogbn-arxiv task models (port of ``experiments/ogbn_arxiv/model.py``;
reference ``benchmark-datasets/ogbn-arxiv/model.py``): the EGC-style
SIRModel (model.py:42-75) with the optional machinery of the commented
variant (model.py:78-116: input dropout, per-layer DropEdge,
jumping-knowledge readouts, MLP residuals), and the GATv2 baseline
(model.py:119-155).

SIRModel, per layer: [resid MLP], SIRConv -> norm -> leaky_relu(0.2) ->
dropout (+ residual), then a linear readout, or with jumping knowledge
one readout MLP per layer's output and the input features, summed. In
training, ``edge_dropout`` draws a fresh DropEdge mask for each layer.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...graph import drop_edge_mask
from ...models import MLP, GATv2Conv, Linear, SIRConv, get_norm
from ...models.layers import dropout as apply_dropout
from ..common_models import _readouts, leaky_relu02


def _edge_mask(model: nn.Module, graph, generator):
    """A fresh DropEdge mask in training at a positive rate, else None."""
    if model.edge_dropout > 0 and model.training:
        return drop_edge_mask(generator, graph, model.edge_dropout)
    return None


def _readout(model: nn.Module, heads: list, generator) -> torch.Tensor:
    """The sum of the jumping-knowledge readouts over ``heads``, or the
    linear readout of the last."""
    if model.jumping_knowledge:
        return sum(readout(h, generator=generator)
                   for readout, h in zip(model.readouts, heads))
    return model.readout(heads[-1])


class SIRModel(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 1, input_dropout: float = 0.0,
                 edge_dropout: float = 0.0, dropout: float = 0.0,
                 norm: str = "none", readout_layers: int = 1,
                 readout_dropout: float = 0.0,
                 jumping_knowledge: bool = False, residual: bool = False,
                 resid_layers: int = 0, resid_dropout: float = 0.0,
                 feat_dropout: float = 0.0, agg_type: str = "mean",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dropout = input_dropout
        self.edge_dropout = edge_dropout
        self.dropout = dropout
        self.jumping_knowledge = jumping_knowledge
        self.residual = residual
        self.embedding = Linear(input_dim, hidden_dim, generator=generator)
        self.resids = nn.ModuleList(
            MLP(hidden_dim, hidden_dim, hidden_dim, resid_layers,
                resid_dropout, "none", leaky_relu02, include_last=False,
                with_graph=False, generator=generator)
            for _ in range(num_layers if residual and resid_layers else 0))
        self.convs = nn.ModuleList(
            SIRConv(hidden_dim, hidden_dim, hidden_dim, leaky_relu02,
                    feat_dropout, agg_type=agg_type, generator=generator)
            for _ in range(num_layers))
        self.norms = nn.ModuleList(
            get_norm(norm, True, hidden_dim) for _ in range(num_layers))
        if jumping_knowledge:
            self.readouts = _readouts(
                [input_dim] + [hidden_dim] * num_layers, hidden_dim,
                output_dim, readout_layers, readout_dropout, generator)
        else:
            self.readout = Linear(hidden_dim, output_dim,
                                  generator=generator)

    def forward(self, graph, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [N_pad, output_dim]. In training mode dropout and each
        layer's DropEdge mask draw from ``generator`` (on the graph's
        device) and BatchNorm updates its running statistics; in eval mode,
        or at edge dropout 0, the convs get no mask and keep the static
        scales."""
        act = leaky_relu02
        feats = apply_dropout(feats, self.input_dropout, self.training,
                              generator)
        x = self.embedding(feats)
        heads = [feats]
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            emask = _edge_mask(self, graph, generator)
            resid = None
            if self.residual:
                resid = (self.resids[i](x, generator=generator)
                         if len(self.resids) else x)
            x = conv(graph, x, edge_mask=emask, generator=generator)
            x = apply_dropout(act(norm(graph, x)), self.dropout,
                              self.training, generator)
            if resid is not None:
                x = x + resid
            heads.append(x)
        return _readout(self, heads, generator)


class GATModel(nn.Module):
    """GATv2 baseline with jumping knowledge (reference model.py:119-155):
    per layer [DropEdge], GATv2Conv (its own dst weights, attention
    dropout, residual), the heads flattened, norm, leaky_relu(0.2),
    dropout; then the readouts as SIRModel's. No kernel of the port runs
    it: the attention takes the gather and segment primitives of the CSR
    aggregate on a FastGraph too, as JAX sends it to XLA."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 1, input_dropout: float = 0.0,
                 edge_dropout: float = 0.0, dropout: float = 0.0,
                 norm: str = "none", readout_layers: int = 1,
                 readout_dropout: float = 0.0,
                 jumping_knowledge: bool = True, num_heads: int = 1,
                 attn_dropout: float = 0.0, residual: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dropout = input_dropout
        self.edge_dropout = edge_dropout
        self.dropout = dropout
        self.jumping_knowledge = jumping_knowledge
        width = num_heads * hidden_dim
        widths = [input_dim] + [width] * num_layers
        self.convs = nn.ModuleList(
            GATv2Conv(widths[i], hidden_dim, num_heads, share_weights=False,
                      attn_dropout=attn_dropout, residual=residual,
                      generator=generator)
            for i in range(num_layers))
        self.norms = nn.ModuleList(
            get_norm(norm, True, width) for _ in range(num_layers))
        if jumping_knowledge:
            self.readouts = _readouts(widths, hidden_dim, output_dim,
                                      readout_layers, readout_dropout,
                                      generator)
        else:
            self.readout = Linear(width, output_dim, generator=generator)

    def forward(self, graph, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = apply_dropout(feats, self.input_dropout, self.training,
                          generator)
        heads = [x]
        for conv, norm in zip(self.convs, self.norms):
            emask = _edge_mask(self, graph, generator)
            x = conv(graph, x, emask, generator=generator)
            x = leaky_relu02(norm(graph, x.reshape(x.shape[0], -1)))
            x = apply_dropout(x, self.dropout, self.training, generator)
            heads.append(x)
        return _readout(self, heads, generator)
