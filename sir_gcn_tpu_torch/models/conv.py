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


def _relation(conv: nn.Module, hidden_dim: int, output_dim: int,
              outer_bias: bool, agg_type: str, generator) -> None:
    """W_R of a conv: for max the explicit ``relation_kernel`` [H, O] (the
    JAX layout, for the per-edge product) and ``relation_bias`` [O], else
    ``linear_relation``, applied per node after the aggregate."""
    if agg_type == "max":
        conv.relation_kernel = uniform_parameter(
            (hidden_dim, output_dim), hidden_dim, generator)
        conv.relation_bias = (uniform_parameter(
            (output_dim,), hidden_dim, generator) if outer_bias else None)
    else:
        conv.linear_relation = Linear(hidden_dim, output_dim,
                                      bias=outer_bias, generator=generator)


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
        _relation(self, hidden_dim, output_dim, outer_bias, agg_type,
                  generator)

    def forward(self, graph, feat, *,
                edge_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``edge_mask`` bool [E_pad] (DropEdge) drops edges on top of the
        graph's padding mask."""
        feat_src, feat_dst = expand_as_pair(feat)
        eq = apply_dropout(self.linear_query(feat_dst), self.dropout,
                           self.training, generator)
        ek = apply_dropout(self.linear_key(feat_src), self.dropout,
                           self.training, generator)
        if self.agg_type == "max":
            return mp.sir_aggregate(graph, eq, ek, self.activation, "max",
                                    w_relation=self.relation_kernel,
                                    b_relation=self.relation_bias,
                                    edge_mask=edge_mask)
        agg = mp.sir_aggregate(graph, eq, ek, self.activation, self.agg_type,
                               edge_mask=edge_mask)
        return self.linear_relation(agg)


class SIREConv(nn.Module):
    r"""h*_u = agg_{v in N(u)} W_R sigma(W_Q h_u + W_E h_uv + W_K h_v)
    (reference ``models/conv.py:70-134``), for agg_type sum, mean, sym or
    max.

    ``efeat`` [E, De] comes in original edge order; the layer takes it into
    sorted order through ``graph.edge_perm``. ``linear_edge`` (W_E, no
    bias) is replaced by ``edge_encoder`` when one is given (zinc's
    SIREConv2 uses an ``Embed`` of discrete bond types, molhiv a
    ``BondEncoder``). With the default W_E, a linear aggregation and no
    active edge dropout (rate 0 or eval mode) the layer hands
    ``sir_aggregate`` the raw features and W_E [De, H], so the fused-edge
    kernels form the projection themselves, under a DropEdge ``edge_mask``
    too; otherwise it forms e, applies dropout and takes the ``e`` route.
    A registry sigma that is not elementwise (row-wise, or declared
    ``sir_elementwise=False``) takes the general route's edge-term kernels
    with e = e_basis @ W_E formed by ``sir_aggregate``, at any width, as
    JAX's ``sir_aggregate`` does. Max applies W_R per edge before the
    reduce, as ``SIRConv`` does, with the explicit ``relation_kernel``
    [H, O] and ``relation_bias`` [O]: on a plain ``GraphBatch`` through the
    CSR aggregate; on a FastGraph through the edge forms of the max
    kernels, for any registry sigma (a row-wise one included)."""

    def __init__(self, input_dim: int, edge_dim: int, hidden_dim: int,
                 output_dim: int, activation, dropout: float = 0.0,
                 inner_bias: bool = True, outer_bias: bool = True,
                 agg_type: str = "sum",
                 edge_encoder: Optional[nn.Module] = None,
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
        self.edge_encoder = edge_encoder
        self.linear_edge = (Linear(edge_dim, hidden_dim, bias=False,
                                   generator=generator)
                            if edge_encoder is None else None)
        _relation(self, hidden_dim, output_dim, outer_bias, agg_type,
                  generator)

    def forward(self, graph, nfeat, efeat: torch.Tensor, *,
                edge_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat_src, feat_dst = expand_as_pair(nfeat)
        eq = apply_dropout(self.linear_query(feat_dst), self.dropout,
                           self.training, generator)
        ek = apply_dropout(self.linear_key(feat_src), self.dropout,
                           self.training, generator)
        edge_drop_off = self.dropout == 0.0 or not self.training
        if (self.edge_encoder is None and edge_drop_off
                and self.agg_type != "max" and efeat.dim() == 2):
            e_basis = efeat.index_select(0, graph.edge_perm)
            agg = mp.sir_aggregate(graph, eq, ek, self.activation,
                                   self.agg_type, e_basis=e_basis,
                                   w_edge=self.linear_edge.weight.t(),
                                   edge_mask=edge_mask)
            return self.linear_relation(agg)
        if self.edge_encoder is not None:
            e = self.edge_encoder(efeat)
        else:
            e = self.linear_edge(efeat)
        e = apply_dropout(e, self.dropout, self.training, generator)
        e = e.index_select(0, graph.edge_perm)  # original -> sorted order
        if self.agg_type == "max":
            return mp.sir_aggregate(graph, eq, ek, self.activation, "max",
                                    e=e, w_relation=self.relation_kernel,
                                    b_relation=self.relation_bias,
                                    edge_mask=edge_mask)
        agg = mp.sir_aggregate(graph, eq, ek, self.activation, self.agg_type,
                               e=e, edge_mask=edge_mask)
        return self.linear_relation(agg)


class SIRConvBase(nn.Module):
    r"""Generic form h*_u = agg_{v in N(u)} g([h_u || h_v]) for a row-wise
    message module g (reference ``models/conv.py:137-177``), on
    :func:`sir_aggregate_concat`."""

    def __init__(self, message_func, agg_type: str = "sum"):
        super().__init__()
        self.message_func = message_func
        self.agg_type = agg_type

    def forward(self, graph, feat, *,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        feat_src, feat_dst = expand_as_pair(feat)
        return mp.sir_aggregate_concat(graph, feat_dst, feat_src,
                                       self.message_func, self.agg_type,
                                       edge_mask=edge_mask)


class SIREConvBase(nn.Module):
    r"""Generic edge-feature form h*_u = agg g([h_u || h_v || h_uv])
    (reference ``models/conv.py:180-221``). The columns follow the
    reference's code, ``(edges.dst['eq'], edges.src['ek'],
    edges.data['e'])`` (conv.py:201), so message-MLP weights carry over
    column for column; ``efeat`` [E, De] comes in original edge order."""

    def __init__(self, message_func, agg_type: str = "sum"):
        super().__init__()
        self.message_func = message_func
        self.agg_type = agg_type

    def forward(self, graph, nfeat, efeat: torch.Tensor, *,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        feat_src, feat_dst = expand_as_pair(nfeat)
        e = efeat.index_select(0, graph.edge_perm)
        return mp.sir_aggregate_concat(graph, feat_dst, feat_src,
                                       self.message_func, self.agg_type,
                                       e=e, edge_mask=edge_mask)
