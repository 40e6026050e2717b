"""Normalisation (port of ``sir_gcn_tpu/models/norm.py``): the masked
BatchNorm, its graph adapter and the identities. Statistics cover real
nodes only."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


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
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """BatchNorm of ``feats`` [N, dim] over the rows where ``mask``
        [N] is set (every row without one); eval mode uses the running
        statistics."""
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            m = (torch.ones_like(feats[:, :1]) if mask is None
                 else mask.to(feats.dtype)[:, None])
            n = m.sum().clamp_min(1.0)
            mean = (feats * m).sum(0) / n
            var = ((feats - mean).square() * m).sum(0) / n
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp_min(1.0)
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased)
        return self.weight * (feats - mean) * torch.rsqrt(var + self.eps) \
            + self.bias


class GraphBatchNorm(nn.Module):
    """``(graph, feats)`` adapter: BatchNorm over the graph's real nodes."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = MaskedBatchNorm(dim)

    def forward(self, graph, feats: torch.Tensor) -> torch.Tensor:
        return self.norm(feats, graph.node_mask)


class GraphIdentity(nn.Module):
    def forward(self, graph, feats: torch.Tensor) -> torch.Tensor:
        return feats


def get_norm(norm: str, with_graph: bool, dim: int) -> nn.Module:
    """'bn' or 'none', in the ``(graph, feats)`` signature with a graph
    and the ``(feats)`` one without; gn, cn and ln are not yet ported."""
    if norm not in ("gn", "cn", "bn", "ln", "none"):
        raise NotImplementedError(f"norm = {norm} not implemented")
    if norm not in ("bn", "none"):
        raise NotImplementedError(
            f"norm = {norm} (with_graph={with_graph}) is not yet ported")
    if with_graph:
        return GraphBatchNorm(dim) if norm == "bn" else GraphIdentity()
    return MaskedBatchNorm(dim) if norm == "bn" else nn.Identity()
