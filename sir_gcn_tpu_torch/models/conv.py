"""SIR-GCN convolution (port of ``sir_gcn_tpu/models/conv.py``).

  * ``linear_key`` has no bias; ``linear_query``'s bias is ``inner_bias``,
    ``linear_relation``'s is ``outer_bias`` (reference conv.py:36-38).
  * Dropout is applied to eq and ek before message formation.
  * W_R is applied per node after the linear aggregation (conv.py:63-65).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import message_passing as mp
from .layers import Linear
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
    (reference ``models/conv.py:7-67``), for agg_type sum, mean or sym."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 activation, dropout: float = 0.0, inner_bias: bool = True,
                 outer_bias: bool = True, agg_type: str = "sum",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if agg_type == "max":
            raise NotImplementedError("max aggregation is not yet ported")
        if agg_type not in ("sum", "mean", "sym"):
            raise NotImplementedError(f"agg_type = {agg_type} not implemented")
        self.activation = activation
        self.dropout = dropout
        self.agg_type = agg_type
        self.linear_query = Linear(input_dim, hidden_dim, bias=inner_bias,
                                   generator=generator)
        self.linear_key = Linear(input_dim, hidden_dim, bias=False,
                                 generator=generator)
        self.linear_relation = Linear(hidden_dim, output_dim,
                                      bias=outer_bias, generator=generator)

    def forward(self, graph, feat, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat_src, feat_dst = expand_as_pair(feat)
        eq = apply_dropout(self.linear_query(feat_dst), self.dropout,
                           self.training, generator)
        ek = apply_dropout(self.linear_key(feat_src), self.dropout,
                           self.training, generator)
        agg = mp.sir_aggregate(graph, eq, ek, self.activation, self.agg_type)
        return self.linear_relation(agg)
