"""Shared model utilities (port of ``sir_gcn_tpu/models/utils.py``; the
reference's ``models/utils.py``): the MLP, VirtualNode and
CentralityEncoder. DropEdge is ``graph.drop_edge_mask``."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops.pool import sum_pool
from .layers import Embed, Linear, dropout
from .norm import get_norm


class MLP(nn.Module):
    """N-layer MLP with a norm and an activation after each layer and
    dropout at the end (reference ``models/utils.py:7-43``).
    ``include_last=False`` leaves norm and activation off the last layer.
    ``with_graph`` selects the ``(graph, feats)`` call signature and the
    graph-aware norms, else ``(feats)``. ``norm_kwargs`` go to each
    norm's constructor."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, dropout: float = 0.0, norm: str = "none",
                 activation: Callable[[torch.Tensor], torch.Tensor]
                 = torch.relu,
                 include_last: bool = True, with_graph: bool = True,
                 norm_kwargs: Optional[dict] = None,
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
            get_norm(norm, with_graph, dims[i + 1], **(norm_kwargs or {}))
            for i in range(normed))

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


class VirtualNode(nn.Module):
    """Virtual-node hooks around each conv layer (reference
    ``models/utils.py:46-67``): :meth:`node_emb` adds the current VN
    embedding to each graph's nodes (at first the row of a 1-row
    embedding table); :meth:`vn_emb` pools the nodes, adds the previous
    VN state and transforms it through ``mod_emb``, with an optional
    residual. Both hand their inputs back unchanged when ``use_vn`` is
    False."""

    def __init__(self, use_vn: bool, hidden_dim: int, residual: bool,
                 mod_emb: Optional[nn.Module] = None,
                 mod_pool: Callable = sum_pool,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_vn = use_vn
        self.residual = residual
        self.mod_emb = mod_emb
        self.mod_pool = mod_pool
        self.init_emb = (Embed(1, hidden_dim, generator=generator)
                         if use_vn else None)

    def node_emb(self, graph, nfeats: torch.Tensor,
                 vnfeat: Optional[torch.Tensor] = None):
        """(nfeats + the VN row of each node's graph, the VN state
        [G_pad, H])."""
        if not self.use_vn:
            return nfeats, vnfeat
        if vnfeat is None:
            vnfeat = self.init_emb(torch.zeros(
                graph.g_pad, dtype=torch.int64, device=nfeats.device))
        return nfeats + graph.broadcast_nodes(vnfeat), vnfeat

    def vn_emb(self, graph, nfeats: torch.Tensor, vnfeat: torch.Tensor, *,
               generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """The next VN state: ``mod_emb(pool(nfeats) + vnfeat)`` (+
        ``vnfeat`` with the residual)."""
        if not self.use_vn:
            return vnfeat
        pooled = self.mod_pool(graph, nfeats) + vnfeat
        out = self.mod_emb(graph, pooled, generator=generator)
        return out + vnfeat if self.residual else out


class CentralityEncoder(nn.Module):
    """Graphormer-style degree encoding added to the node features
    (reference ``models/utils.py:70-93``): embeddings of the in- and/or
    out-degree clamped to ``max_degree``, padding_idx 0. The identity when
    ``max_degree == 0``."""

    def __init__(self, max_degree: int, embedding_dim: int,
                 direction: str = "both",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_degree = max_degree
        use_in = max_degree > 0 and direction in ("in", "both")
        use_out = max_degree > 0 and direction in ("out", "both")
        self.encoder_in = (Embed(max_degree + 1, embedding_dim,
                                 padding_idx=0, generator=generator)
                           if use_in else None)
        self.encoder_out = (Embed(max_degree + 1, embedding_dim,
                                  padding_idx=0, generator=generator)
                            if use_out else None)

    def forward(self, graph, nfeats: torch.Tensor) -> torch.Tensor:
        for enc, deg in ((self.encoder_in, graph.in_deg),
                         (self.encoder_out, graph.out_deg)):
            if enc is not None:
                nfeats = nfeats + enc(
                    deg.long().clamp(0, self.max_degree))
        return nfeats
