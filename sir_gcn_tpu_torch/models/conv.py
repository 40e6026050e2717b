"""SIR-GCN convolution (port of ``sir_gcn_tpu/models/conv.py``).

  * ``linear_key`` has no bias; ``linear_query``'s bias is ``inner_bias``,
    ``linear_relation``'s is ``outer_bias`` (reference conv.py:36-38).
  * Dropout is applied to eq and ek (and SIREConv's edge projection)
    before message formation.
  * W_R is applied per node after the linear aggregation (conv.py:63-65),
    and per edge before the reduce for max (conv.py:47), where it is the
    explicit ``relation_kernel`` [H, O] and ``relation_bias`` [O] of the
    JAX package's ``_relation_params``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import message_passing as mp
from .layers import Linear, uniform_parameter
from .layers import dropout as apply_dropout


def expand_as_pair(feat):
    """A single feature tensor feeds both endpoints; a ``(feat_src,
    feat_dst)`` pair feeds the key side from src and the query side from
    dst (reference ``expand_as_pair``)."""
    if isinstance(feat, (tuple, list)):
        feat_src, feat_dst = feat
        return feat_src, feat_dst
    return feat, feat


class SIRConv(nn.Module):
    r"""h*_u = agg_{v in N(u)} W_R sigma(W_Q h_u + W_K h_v)
    (reference ``models/conv.py:7-67``), for agg_type sum, mean, sym or
    max."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 activation, dropout: float = 0.0, inner_bias: bool = True,
                 outer_bias: bool = True, agg_type: str = "sum",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if agg_type not in ("sum", "mean", "sym", "max"):
            raise NotImplementedError(f"agg_type = {agg_type} not implemented")
        self.activation = activation
        self.dropout = dropout
        self.agg_type = agg_type
        self.linear_query = Linear(input_dim, hidden_dim, bias=inner_bias,
                                   generator=generator)
        self.linear_key = Linear(input_dim, hidden_dim, bias=False,
                                 generator=generator)
        if agg_type == "max":
            # W_R [H, O] in the JAX layout, for the kernels' per-edge product
            self.relation_kernel = uniform_parameter(
                (hidden_dim, output_dim), hidden_dim, generator)
            self.relation_bias = (uniform_parameter(
                (output_dim,), hidden_dim, generator) if outer_bias
                else None)
        else:
            self.linear_relation = Linear(hidden_dim, output_dim,
                                          bias=outer_bias,
                                          generator=generator)

    def forward(self, graph, feat, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat_src, feat_dst = expand_as_pair(feat)
        eq = apply_dropout(self.linear_query(feat_dst), self.dropout,
                           self.training, generator)
        ek = apply_dropout(self.linear_key(feat_src), self.dropout,
                           self.training, generator)
        if self.agg_type == "max":
            return mp.sir_aggregate(graph, eq, ek, self.activation, "max",
                                    w_relation=self.relation_kernel,
                                    b_relation=self.relation_bias)
        agg = mp.sir_aggregate(graph, eq, ek, self.activation, self.agg_type)
        return self.linear_relation(agg)


class SIREConv(nn.Module):
    r"""h*_u = agg_{v in N(u)} W_R sigma(W_Q h_u + W_E h_uv + W_K h_v)
    (reference ``models/conv.py:70-134``), for agg_type sum, mean or sym.

    ``efeat`` [E, De] comes in original edge order; the layer takes it into
    sorted order through ``graph.edge_perm``. ``linear_edge`` (W_E, no
    bias) is replaced by ``edge_encoder`` when one is given (zinc's
    SIREConv2 uses an ``Embed`` of discrete bond types). With the default
    W_E and no active edge dropout (rate 0 or eval mode) the layer hands
    ``sir_aggregate`` the raw features and W_E [De, H], so the fused-edge
    kernels form the projection themselves; otherwise it forms e, applies
    dropout and takes the ``e`` route. Max with edge features is not yet
    ported."""

    def __init__(self, input_dim: int, edge_dim: int, hidden_dim: int,
                 output_dim: int, activation, dropout: float = 0.0,
                 inner_bias: bool = True, outer_bias: bool = True,
                 agg_type: str = "sum",
                 edge_encoder: Optional[nn.Module] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if agg_type == "max":
            raise NotImplementedError(
                "SIREConv with max aggregation (the edge-term forms of the "
                "max kernels) is not yet ported")
        if agg_type not in ("sum", "mean", "sym"):
            raise NotImplementedError(f"agg_type = {agg_type} not implemented")
        self.activation = activation
        self.dropout = dropout
        self.agg_type = agg_type
        self.linear_query = Linear(input_dim, hidden_dim, bias=inner_bias,
                                   generator=generator)
        self.linear_key = Linear(input_dim, hidden_dim, bias=False,
                                 generator=generator)
        self.edge_encoder = edge_encoder
        self.linear_edge = (Linear(edge_dim, hidden_dim, bias=False,
                                   generator=generator)
                            if edge_encoder is None else None)
        self.linear_relation = Linear(hidden_dim, output_dim,
                                      bias=outer_bias, generator=generator)

    def forward(self, graph, nfeat, efeat: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat_src, feat_dst = expand_as_pair(nfeat)
        eq = apply_dropout(self.linear_query(feat_dst), self.dropout,
                           self.training, generator)
        ek = apply_dropout(self.linear_key(feat_src), self.dropout,
                           self.training, generator)
        edge_drop_off = self.dropout == 0.0 or not self.training
        if (self.edge_encoder is None and edge_drop_off
                and efeat.dim() == 2):
            e_basis = efeat.index_select(0, graph.edge_perm)
            agg = mp.sir_aggregate(graph, eq, ek, self.activation,
                                   self.agg_type, e_basis=e_basis,
                                   w_edge=self.linear_edge.weight.t())
            return self.linear_relation(agg)
        if self.edge_encoder is not None:
            e = self.edge_encoder(efeat)
        else:
            e = self.linear_edge(efeat)
        e = apply_dropout(e, self.dropout, self.training, generator)
        e = e.index_select(0, graph.edge_perm)  # original -> sorted order
        agg = mp.sir_aggregate(graph, eq, ek, self.activation, self.agg_type,
                               e=e)
        return self.linear_relation(agg)
