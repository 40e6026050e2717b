"""Normalisation zoo (port of ``sir_gcn_tpu/models/norm.py``; reference
``models/norm.py``): GraphNorm, the masked BatchNorm, LayerNorm,
ContraNorm, their ``(graph, feats)`` adapters and the identities.

Every graph-aware norm computes its statistics over real nodes only, the
static-shape form of the reference's exact per-graph statistics.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.segment import segment_sum


class GraphNorm(nn.Module):
    """Per-graph normalisation with a learnable mean scale (reference
    ``models/norm.py:7-29``): for each graph g,

        out = weight * (x - mean_g(x) * mean_scale) / sqrt(var_g + eps)
              + bias

    with mean and var over g's real nodes; a graph slot with no node
    counts as one node."""

    def __init__(self, dim: int, eps: float = 1e-5, use_bias: bool = True,
                 use_mean_scale: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None
        self.mean_scale = (nn.Parameter(torch.ones(dim)) if use_mean_scale
                           else None)

    def forward(self, graph, feats: torch.Tensor) -> torch.Tensor:
        g = graph.g_pad
        mask = graph.node_mask.to(feats.dtype)[:, None]
        n_per_graph = graph.batch_num_nodes().clamp_min(1.0)[:, None]
        mean = segment_sum(feats * mask, graph.graph_segments,
                           g) / n_per_graph
        demean = graph.broadcast_nodes(mean)
        if self.mean_scale is not None:
            demean = demean * self.mean_scale
        demean = feats - demean
        var = segment_sum(demean.square() * mask, graph.graph_segments,
                          g) / n_per_graph
        out = self.weight * demean / graph.broadcast_nodes(
            torch.sqrt(var + self.eps))
        return out if self.bias is None else out + self.bias


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the rows where ``mask`` is set. ``nn.BatchNorm1d``
    cannot leave padding rows out, hence this module. The running
    variance is unbiased over the n real rows, with momentum 0.1 as in
    torch."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, feats: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                reduce: Optional[Callable] = None) -> torch.Tensor:
        """BatchNorm of ``feats`` [N, dim] over the rows where ``mask``
        [N] is set (every row without one); eval mode uses the running
        statistics. ``reduce`` sums a partial statistic over the ranks
        that hold the other rows (a differentiable all-reduce; a
        ``HaloGraph``'s ``rank_sum``)."""
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            reduce = reduce or (lambda t: t)
            m = (torch.ones_like(feats[:, :1]) if mask is None
                 else mask.to(feats.dtype)[:, None])
            n = reduce(m.sum()).clamp_min(1.0)
            mean = reduce((feats * m).sum(0)) / n
            var = reduce(((feats - mean).square() * m).sum(0)) / n
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp_min(1.0)
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased)
        return self.weight * (feats - mean) * torch.rsqrt(var + self.eps) \
            + self.bias


class LayerNorm(nn.Module):
    """``nn.LayerNorm`` over the last axis with an elementwise affine, eps
    1e-5 (flax's ``scale`` is ``weight`` here). Padding rows are
    normalised too; nothing reads them."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, feats: torch.Tensor, *_) -> torch.Tensor:
        return F.layer_norm(feats, feats.shape[-1:], self.weight, self.bias,
                            self.eps)


class ContraNorm(nn.Module):
    """Feature-decorrelation norm (reference ``models/norm.py:32-45``):

        W = softmax(X^T X / temp, axis=1)
        X <- (1 + use_scale * scale) * X - scale * X W
        X <- BatchNorm1d(X)

    Padding rows are left out of the Gram matrix and of the BatchNorm
    statistics."""

    def __init__(self, dim: int, scale: float = 0.0, temp: float = 1.0,
                 use_scale: bool = False):
        super().__init__()
        self.scale = scale
        self.temp = temp
        self.use_scale = use_scale
        self.norm = MaskedBatchNorm(dim)

    def forward(self, feats: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                reduce: Optional[Callable] = None) -> torch.Tensor:
        """``reduce`` sums the Gram matrix and the BatchNorm statistics
        over the ranks that hold the other rows."""
        x = feats if mask is None else feats * mask.to(feats.dtype)[:, None]
        gram = x.t() @ x
        if reduce is not None:
            gram = reduce(gram)
        weights = torch.softmax(gram / self.temp, dim=1)
        multiplier = 1.0 + int(self.use_scale) * self.scale
        out = multiplier * feats - self.scale * (feats @ weights)
        return self.norm(out, mask, reduce)


class GraphContraNorm(nn.Module):
    """``(graph, feats)`` adapter: ContraNorm over the graph's real
    nodes."""

    def __init__(self, dim: int, scale: float = 0.0, temp: float = 1.0,
                 use_scale: bool = False):
        super().__init__()
        self.norm = ContraNorm(dim, scale, temp, use_scale)

    def forward(self, graph, feats: torch.Tensor) -> torch.Tensor:
        return self.norm(feats, graph.node_mask,
                         getattr(graph, "rank_sum", None))


class GraphBatchNorm(nn.Module):
    """``(graph, feats)`` adapter: BatchNorm over the graph's real nodes."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = MaskedBatchNorm(dim)

    def forward(self, graph, feats: torch.Tensor) -> torch.Tensor:
        """Over every rank's real nodes on a ``HaloGraph``."""
        return self.norm(feats, graph.node_mask,
                         getattr(graph, "rank_sum", None))


class GraphLayerNorm(nn.Module):
    """``(graph, feats)`` adapter of :class:`LayerNorm`."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)

    def forward(self, graph, feats: torch.Tensor) -> torch.Tensor:
        return self.norm(feats)


class GraphIdentity(nn.Module):
    def forward(self, graph, feats: torch.Tensor) -> torch.Tensor:
        return feats


class Identity(nn.Module):
    def forward(self, feats: torch.Tensor, *_) -> torch.Tensor:
        return feats


def get_norm(norm: str, with_graph: bool, dim: int, **kwargs) -> nn.Module:
    """'gn', 'cn', 'bn', 'ln' or 'none' (reference ``models/norm.py:
    68-82``): the ``(graph, feats)`` modules with a graph, the ``(feats,
    mask)`` ones without; 'gn' needs a graph. ``kwargs`` go to the norm's
    constructor ('none' takes none)."""
    if with_graph:
        table = {"gn": GraphNorm, "cn": GraphContraNorm, "bn": GraphBatchNorm,
                 "ln": GraphLayerNorm, "none": GraphIdentity}
    else:
        table = {"cn": ContraNorm, "bn": MaskedBatchNorm, "ln": LayerNorm,
                 "none": Identity}
    if norm not in table:
        raise NotImplementedError(f"norm = {norm} not implemented")
    if norm == "none":
        return table[norm]()
    return table[norm](dim, **kwargs)
