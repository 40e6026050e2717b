"""Graph readout pooling (port of ``sir_gcn_tpu/ops/pool.py``; the
reference uses ``dgl.nn.SumPooling`` / ``dgl.nn.AvgPooling``, e.g.
``benchmark-datasets/zinc/model.py:41``)."""

from __future__ import annotations

import torch

from .segment import _rows, segment_sum


def sum_pool(graph, feats: torch.Tensor) -> torch.Tensor:
    """Per-graph node sum -> [G_pad, ...]; padding nodes excluded."""
    masked = torch.where(_rows(graph.node_mask, feats), feats, 0.0)
    return segment_sum(masked, graph.graph_segments, graph.g_pad)


def avg_pool(graph, feats: torch.Tensor) -> torch.Tensor:
    """Per-graph node mean -> [G_pad, ...] (0 for a graph with no node)."""
    s = sum_pool(graph, feats)
    n = segment_sum(graph.node_mask.to(s.dtype), graph.graph_segments,
                    graph.g_pad)
    return s / _rows(n.clamp_min(1.0), s)


def get_pool(name: str):
    if name in ("sum",):
        return sum_pool
    if name in ("mean", "avg"):
        return avg_pool
    raise NotImplementedError(f"pool = {name} not implemented")
