"""Baseline conv zoo (port of ``sir_gcn_tpu/models/zoo.py``): GCN, GATv2,
GIN, GINE, PNA and GraphSAGE on the gather and segment primitives of the
CSR aggregate (``ops/segment.py``), for a plain ``GraphBatch``.

The reference takes these from ``dgl.nn`` for its contrast experiments
(``synthetic-datasets/dictionary-lookup/model.py:47-155``); each class
computes the DGL layer's math on the settings the reference uses. Weights
are the JAX package's: ``Linear`` layers with U(+-1/sqrt(fan_in)), the
attention vector and zero biases as there.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import segment as seg
from ..ops.message_passing import _valid, copy_src_aggregate
from .layers import Linear, dropout, uniform_parameter


class GraphConv(nn.Module):
    """Kipf-Welling GCN layer, DGL ``GraphConv`` with norm='both' and
    allow_zero_in_degree=True:
    h_u = b + W sum_v h_v / sqrt(d_out(v) d_in(u)), degrees clamped >= 1.
    A node with no in-edge gets the bias."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = Linear(in_features, features, bias=False,
                             generator=generator)
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, graph, feat: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out_norm = graph.out_deg.clamp_min(1.0).pow(-0.5)
        in_norm = graph.in_deg.clamp_min(1.0).pow(-0.5)
        x = self.linear(feat * out_norm[:, None])
        agg = copy_src_aggregate(graph, x, "sum", edge_mask=edge_mask)
        agg = agg * in_norm[:, None]
        return agg if self.bias is None else agg + self.bias


class GATv2Conv(nn.Module):
    """GATv2 (Brody et al.), DGL ``GATv2Conv``:
    e_vu = a^T LeakyReLU(W h_u + W h_v), softmax over the incoming edges
    of u, h_u = sum_v alpha_vu W h_v. Returns [N, heads, features].

    ``attn_dropout`` drops the normalized attention weights (DGL
    attn_drop), from the ``generator`` given to ``forward``; ``residual``
    adds the input, through a linear ``res_fc`` where its width is not
    heads * features; ``use_bias`` is the bias of fc and res_fc.
    ``share_weights=False`` gives the dst side its own ``fc_dst``."""

    def __init__(self, in_features: int, features: int, num_heads: int = 1,
                 negative_slope: float = 0.2, share_weights: bool = True,
                 attn_dropout: float = 0.0, residual: bool = False,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.features = num_heads, features
        self.negative_slope = negative_slope
        self.attn_dropout = attn_dropout
        width = num_heads * features
        self.fc_src = Linear(in_features, width, bias=use_bias,
                             generator=generator)
        self.fc_dst = (None if share_weights else
                       Linear(in_features, width, bias=use_bias,
                              generator=generator))
        # flax's variance_scaling(1/3, fan_in, uniform) on [H, F]: fan_in H
        self.attn = uniform_parameter((num_heads, features), num_heads,
                                      generator)
        self.residual = residual
        self.res_fc = (Linear(in_features, width, bias=use_bias,
                              generator=generator)
                       if residual and in_features != width else None)

    def forward(self, graph, feat: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h, f = self.num_heads, self.features
        fsrc = self.fc_src(feat).reshape(-1, h, f)
        fdst = fsrc if self.fc_dst is None else self.fc_dst(feat).reshape(
            -1, h, f)
        valid = _valid(graph, edge_mask)
        src_rows = seg.gather_rows(fsrc, graph.src_segments)
        z = seg.gather_rows(fdst, graph.dst_segments) + src_rows  # [E,H,F]
        e = (F.leaky_relu(z, self.negative_slope) * self.attn).sum(-1)
        alpha = seg.segment_softmax(e, graph.dst_segments, graph.n_pad,
                                    valid)
        alpha = dropout(alpha, self.attn_dropout, self.training, generator,
                        edges=True)
        msg = torch.where(valid[:, None, None], src_rows * alpha[..., None],
                          0.0)
        rst = seg.segment_sum(msg, graph.dst_segments, graph.n_pad)
        if self.residual:
            res = feat if self.res_fc is None else self.res_fc(feat)
            rst = rst + res.reshape(-1, h, f)
        return rst


class GINConv(nn.Module):
    """GIN layer, DGL ``GINConv``:
    h_u = apply_func((1 + eps) h_u + agg_v h_v), eps fixed at
    ``init_eps`` or a parameter with ``learn_eps``."""

    def __init__(self, apply_func: Callable[[torch.Tensor], torch.Tensor],
                 init_eps: float = 0.0, learn_eps: bool = False,
                 agg: str = "sum"):
        super().__init__()
        self.apply_func = apply_func
        self.agg = agg
        self.eps = (nn.Parameter(torch.tensor(float(init_eps))) if learn_eps
                    else init_eps)

    def forward(self, graph, feat: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        agg = copy_src_aggregate(graph, feat, self.agg, edge_mask=edge_mask)
        return self.apply_func((1.0 + self.eps) * feat + agg)


class GINEConv(nn.Module):
    """GINE, GIN with edge features, DGL ``GINEConv``:
    h_u = apply_func((1 + eps) h_u + sum_v ReLU(h_v + e_uv)). ``efeat``
    [E, D] comes in original edge order."""

    def __init__(self, apply_func: Callable[[torch.Tensor], torch.Tensor],
                 init_eps: float = 0.0):
        super().__init__()
        self.apply_func = apply_func
        self.eps = init_eps

    def forward(self, graph, feat: torch.Tensor, efeat: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        valid = _valid(graph, edge_mask)
        e = efeat.index_select(0, graph.edge_perm)  # original -> sorted
        msg = torch.relu(seg.gather_rows(feat, graph.src_segments) + e)
        msg = torch.where(valid[:, None], msg, 0.0)
        agg = seg.segment_sum(msg, graph.dst_segments, graph.n_pad)
        return self.apply_func((1.0 + self.eps) * feat + agg)


class PNAConv(nn.Module):
    """Principal Neighbourhood Aggregation, DGL ``PNAConv``: aggregators
    sum, mean, max, min, std and var; scalers identity, amplification
    log(d+1)/delta and attenuation delta/log(d+1) (d the in-degree,
    clamped >= 1); towers over an even split of the features, mixed by a
    linear when there are several. Per tower t:
        m_vu = M_t([h_u^t || h_v^t]),  h_u' = U_t([h_u^t || scaled aggs]).
    std is sqrt(relu(E[m^2] - E[m]^2) + 1e-10), so its gradient is finite
    at zero variance; max and min over no edge read 0. The reference's
    setting is one tower, ('sum', 'max', 'std') and ('identity',)
    (``synthetic-datasets/dictionary-lookup/model.py:155``)."""

    def __init__(self, in_features: int, features: int,
                 aggregators: tuple = ("sum", "max", "std"),
                 scalers: tuple = ("identity",), num_towers: int = 1,
                 delta: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        t = num_towers
        if in_features % t or features % t:
            raise ValueError("in/out feature dims must divide num_towers")
        for agg in aggregators:
            if agg not in ("sum", "mean", "max", "min", "std", "var"):
                raise NotImplementedError(agg)
        for sc in scalers:
            if sc not in ("identity", "amplification", "attenuation"):
                raise NotImplementedError(sc)
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.num_towers, self.delta = t, delta
        din = in_features // t
        width = din * (1 + len(aggregators) * len(scalers))
        self.M = nn.ModuleList(Linear(2 * din, din, generator=generator)
                               for _ in range(t))
        self.U = nn.ModuleList(Linear(width, features // t,
                                      generator=generator)
                               for _ in range(t))
        self.mixing = (Linear(features, features, generator=generator)
                       if t > 1 else None)

    def forward(self, graph, feat: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        valid = _valid(graph, edge_mask)
        vmask = valid[:, None]
        n, segs = graph.n_pad, graph.dst_segments
        din = feat.shape[-1] // self.num_towers
        counts = seg.segment_sum(valid.to(feat.dtype), segs,
                                 n).clamp_min(1.0)[:, None]
        logd = torch.log(graph.in_deg.clamp_min(1.0) + 1.0)[:, None]
        h_dst = seg.gather_rows(feat, segs)
        h_src = seg.gather_rows(feat, graph.src_segments)

        outs = []
        for t in range(self.num_towers):
            sl = slice(t * din, (t + 1) * din)
            m = self.M[t](torch.cat([h_dst[:, sl], h_src[:, sl]], -1))
            s = seg.segment_sum(torch.where(vmask, m, 0.0), segs, n)
            aggs = []
            for agg in self.aggregators:
                if agg == "sum":
                    aggs.append(s)
                elif agg == "mean":
                    aggs.append(s / counts)
                elif agg == "max":
                    aggs.append(seg.segment_max(m, segs, n, valid))
                elif agg == "min":
                    aggs.append(-seg.segment_max(-m, segs, n, valid))
                else:  # std, var
                    mean = s / counts
                    sq = seg.segment_sum(torch.where(vmask, m * m, 0.0),
                                         segs, n) / counts
                    v = torch.relu(sq - mean * mean)
                    aggs.append(v if agg == "var"
                                else torch.sqrt(v + 1e-10))
            parts = [feat[:, sl]]
            for a in aggs:
                for sc in self.scalers:
                    if sc == "identity":
                        parts.append(a)
                    elif sc == "amplification":
                        parts.append(a * (logd / self.delta))
                    else:
                        parts.append(a * (self.delta / logd))
            outs.append(self.U[t](torch.cat(parts, -1)))
        if self.mixing is None:
            return outs[0]
        return self.mixing(torch.cat(outs, -1))


def pna_delta(graphs_in_deg) -> float:
    """Train-set normalization of PNA's degree scalers:
    delta = the mean over nodes of log(d + 1) (Corso et al. eq. 5)."""
    d = np.concatenate([np.asarray(x).ravel() for x in graphs_in_deg])
    return float(np.mean(np.log(np.maximum(d, 1.0) + 1.0)))


class SAGEConv(nn.Module):
    """GraphSAGE, DGL ``SAGEConv`` with aggregator_type='pool':
    h_pool = max_v ReLU(W_pool h_v + b) (0 with no in-edge),
    h_u = W_self h_u + W_neigh h_pool + b."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc_pool = Linear(in_features, in_features, generator=generator)
        self.fc_self = Linear(in_features, features, bias=False,
                              generator=generator)
        self.fc_neigh = Linear(in_features, features, generator=generator)

    def forward(self, graph, feat: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        pooled = torch.relu(self.fc_pool(feat))
        msg = seg.gather_rows(pooled, graph.src_segments)
        h_neigh = seg.segment_max(msg, graph.dst_segments, graph.n_pad,
                                  _valid(graph, edge_mask))
        return self.fc_self(feat) + self.fc_neigh(h_neigh)
