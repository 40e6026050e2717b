"""Shared batched-graph task models (port of
``experiments/common_models.py``).

The reference repeats one architecture in its ZINC, molhiv, SBM and
super-pixel ``model.py`` files: encoder -> N x [DropEdge, resid-MLP,
SIRConv, norm, LeakyReLU(0.2), dropout] -> jumping-knowledge readout MLPs
-> pooling (e.g. ``benchmark-datasets/zinc/model.py:18-61``). Here it is
one configurable module per conv family, which the workloads instantiate.

Batched graphs are plain ``GraphBatch``es, so every aggregate takes the
CSR route (``ops/segment.py``), as the JAX package sends them to XLA.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..graph import drop_edge_mask
from ..models import MLP, GATv2Conv, GINConv, SIRConv, SIREConv, get_norm
from ..models.layers import dropout as apply_dropout
from ..ops.ell import leaky_relu
from ..ops.pool import get_pool

leaky_relu02 = leaky_relu(0.2)


def _readouts(widths, hidden_dim, output_dim, readout_layers,
              readout_dropout, generator) -> nn.ModuleList:
    """One readout MLP per head (``widths`` their input widths)."""
    return nn.ModuleList(
        MLP(w, hidden_dim, output_dim, readout_layers, readout_dropout,
            "none", leaky_relu02, include_last=False, with_graph=False,
            generator=generator)
        for w in widths)


def _edge_mask(model: nn.Module, graph, generator):
    """A fresh DropEdge mask in training at a positive rate, else None."""
    if model.edge_dropout > 0 and model.training:
        return drop_edge_mask(generator, graph, model.edge_dropout)
    return None


class GraphSIRModel(nn.Module):
    """Batched-graph SIR model (reference zinc/model.py:18-61 and its
    siblings). ``encoder`` embeds the raw node features into
    ``input_dim`` columns; ``edge_encoder(i)`` (optional) makes layer i's
    edge encoder and switches the convs to SIREConv (the SIREConv2 path
    of zinc/model.py:12-15)."""

    def __init__(self, encoder: nn.Module, input_dim: int, hidden_dim: int,
                 output_dim: int, num_layers: int = 1,
                 input_dropout: float = 0.0, edge_dropout: float = 0.0,
                 dropout: float = 0.0, norm: str = "none",
                 readout_layers: int = 1, readout_dropout: float = 0.0,
                 readout_pooling: str = "sum", jumping_knowledge: bool = True,
                 residual: bool = False, resid_layers: int = 0,
                 resid_dropout: float = 0.0, feat_dropout: float = 0.0,
                 agg_type: str = "sum",
                 edge_encoder: Optional[Callable[[int], nn.Module]] = None,
                 pool_after_readout: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dropout = input_dropout
        self.edge_dropout = edge_dropout
        self.dropout = dropout
        self.jumping_knowledge = jumping_knowledge
        self.residual = residual
        self.pool = get_pool(readout_pooling)
        self.pool_after_readout = pool_after_readout
        self.encoder = encoder
        widths = [input_dim] + [hidden_dim] * num_layers
        self.resids = nn.ModuleList(
            MLP(widths[i], hidden_dim, hidden_dim, resid_layers,
                resid_dropout, "none", leaky_relu02, include_last=False,
                with_graph=False, generator=generator)
            for i in range(num_layers if residual and resid_layers else 0))
        self.convs = nn.ModuleList()
        for i in range(num_layers):
            if edge_encoder is not None:
                self.convs.append(SIREConv(
                    widths[i], 0, hidden_dim, hidden_dim, leaky_relu02,
                    feat_dropout, agg_type=agg_type,
                    edge_encoder=edge_encoder(i), generator=generator))
            else:
                self.convs.append(SIRConv(
                    widths[i], hidden_dim, hidden_dim, leaky_relu02,
                    feat_dropout, agg_type=agg_type, generator=generator))
        self.norms = nn.ModuleList(get_norm(norm, True, hidden_dim)
                                   for _ in range(num_layers))
        self.readouts = _readouts(
            widths if jumping_knowledge else widths[-1:], hidden_dim,
            output_dim, readout_layers, readout_dropout, generator)

    def forward(self, graph, nfeats: torch.Tensor,
                efeats: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[G_pad, output_dim] pooled scores, or [N_pad, output_dim] per
        node without ``pool_after_readout``. In training mode dropout and
        each layer's DropEdge mask draw from ``generator``."""
        x = apply_dropout(self.encoder(nfeats), self.input_dropout,
                          self.training, generator)
        xs = [x] if self.jumping_knowledge else []
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            emask = _edge_mask(self, graph, generator)
            resid = 0.0
            if self.residual:
                resid = (self.resids[i](x, generator=generator)
                         if len(self.resids) else x)
            if isinstance(conv, SIREConv):
                x = conv(graph, x, efeats, edge_mask=emask,
                         generator=generator)
            else:
                x = conv(graph, x, edge_mask=emask, generator=generator)
            x = leaky_relu02(norm(graph, x + resid))
            x = apply_dropout(x, self.dropout, self.training, generator)
            if self.jumping_knowledge:
                xs.append(x)
        heads = xs if self.jumping_knowledge else [x]
        score = sum(readout(h, generator=generator)
                    for readout, h in zip(self.readouts, heads))
        return self.pool(graph, score) if self.pool_after_readout else score


class GraphGINModel(nn.Module):
    """GIN baseline (reference zinc/model.py:64-106): GINConv with a
    post-combine MLP (norm inside it), JK readouts, pooling."""

    def __init__(self, encoder: nn.Module, input_dim: int, hidden_dim: int,
                 output_dim: int, num_layers: int = 1,
                 input_dropout: float = 0.0, edge_dropout: float = 0.0,
                 dropout: float = 0.0, norm: str = "none",
                 readout_layers: int = 1, readout_dropout: float = 0.0,
                 readout_pooling: str = "sum", jumping_knowledge: bool = True,
                 residual: bool = False, resid_layers: int = 0,
                 resid_dropout: float = 0.0, mlp_layers: int = 1,
                 agg_type: str = "sum",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dropout = input_dropout
        self.edge_dropout = edge_dropout
        self.jumping_knowledge = jumping_knowledge
        self.residual = residual
        self.pool = get_pool(readout_pooling)
        self.encoder = encoder
        widths = [input_dim] + [hidden_dim] * num_layers
        self.resids = nn.ModuleList(
            MLP(widths[i], hidden_dim, hidden_dim, resid_layers,
                resid_dropout, "none", leaky_relu02, include_last=False,
                with_graph=False, generator=generator)
            for i in range(num_layers if residual and resid_layers else 0))
        self.convs = nn.ModuleList(GINConv(apply_func=lambda h: h,
                                           agg=agg_type)
                                   for _ in range(num_layers))
        self.combs = nn.ModuleList(
            MLP(widths[i], hidden_dim, hidden_dim, mlp_layers, dropout, norm,
                leaky_relu02, with_graph=True, generator=generator)
            for i in range(num_layers))
        self.readouts = _readouts(
            widths if jumping_knowledge else widths[-1:], hidden_dim,
            output_dim, readout_layers, readout_dropout, generator)

    def forward(self, graph, nfeats: torch.Tensor,
                efeats: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = apply_dropout(self.encoder(nfeats), self.input_dropout,
                          self.training, generator)
        xs = [x] if self.jumping_knowledge else []
        for i, (conv, comb) in enumerate(zip(self.convs, self.combs)):
            emask = _edge_mask(self, graph, generator)
            resid = 0.0
            if self.residual:
                resid = (self.resids[i](x, generator=generator)
                         if len(self.resids) else x)
            x = conv(graph, x, edge_mask=emask)
            x = comb(graph, x, generator=generator) + resid
            if self.jumping_knowledge:
                xs.append(x)
        heads = xs if self.jumping_knowledge else [x]
        score = sum(readout(h, generator=generator)
                    for readout, h in zip(self.readouts, heads))
        return self.pool(graph, score)


class GraphGATModel(nn.Module):
    """GATv2 baseline on batched graphs (reference
    ``benchmark-datasets/sbm-dataset/model.py:55-92``): an encoder to
    heads * hidden columns -> N x [DropEdge, GATv2Conv(share_weights, no
    bias, attn_drop, residual), heads flattened, norm, LeakyReLU(0.2),
    dropout] -> jumping-knowledge readout MLPs (per node unless
    pooled)."""

    def __init__(self, encoder: nn.Module, hidden_dim: int, output_dim: int,
                 num_layers: int = 1, input_dropout: float = 0.0,
                 edge_dropout: float = 0.0, dropout: float = 0.0,
                 norm: str = "none", readout_layers: int = 1,
                 readout_dropout: float = 0.0, readout_pooling: str = "sum",
                 jumping_knowledge: bool = True, residual: bool = False,
                 num_heads: int = 1, attn_dropout: float = 0.0,
                 pool_after_readout: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dropout = input_dropout
        self.edge_dropout = edge_dropout
        self.dropout = dropout
        self.jumping_knowledge = jumping_knowledge
        self.pool = get_pool(readout_pooling)
        self.pool_after_readout = pool_after_readout
        self.encoder = encoder
        width = num_heads * hidden_dim
        self.convs = nn.ModuleList(
            GATv2Conv(width, hidden_dim, num_heads, share_weights=True,
                      attn_dropout=attn_dropout, residual=residual,
                      use_bias=False, generator=generator)
            for _ in range(num_layers))
        self.norms = nn.ModuleList(get_norm(norm, True, width)
                                   for _ in range(num_layers))
        self.readouts = _readouts(
            [width] * (num_layers + 1 if jumping_knowledge else 1),
            hidden_dim, output_dim, readout_layers, readout_dropout,
            generator)

    def forward(self, graph, nfeats: torch.Tensor,
                efeats: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = apply_dropout(self.encoder(nfeats), self.input_dropout,
                          self.training, generator)
        xs = [x] if self.jumping_knowledge else []
        for conv, norm in zip(self.convs, self.norms):
            emask = _edge_mask(self, graph, generator)
            x = conv(graph, x, emask, generator=generator)
            x = leaky_relu02(norm(graph, x.reshape(x.shape[0], -1)))
            x = apply_dropout(x, self.dropout, self.training, generator)
            if self.jumping_knowledge:
                xs.append(x)
        heads = xs if self.jumping_knowledge else [x]
        score = sum(readout(h, generator=generator)
                    for readout, h in zip(self.readouts, heads))
        return self.pool(graph, score) if self.pool_after_readout else score
