"""Segment and gather primitives of the CSR aggregate on a plain
``GraphBatch`` (port of ``sir_gcn_tpu/ops/segment.py``): DGL's
``update_all`` reducers ``fn.sum``, ``fn.mean`` and ``fn.max`` over edge
arrays sorted by dst, in plain PyTorch.

``segment_sum`` adds with ``index_add``: on the CPU in edge order, on a
CUDA device in the order its atomic adds land, so a card's f32 sums may
differ between runs in their last bits (the JAX package's sorted segment
sum is deterministic). The maxes do not depend on order.
"""

from __future__ import annotations

import torch


def _rows(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """A per-row [E] tensor shaped to broadcast over ``data``'s rows."""
    return mask.reshape((-1,) + (1,) * (data.dim() - 1))


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``x[idx]`` (DGL's ``edges.src[...]`` / ``edges.dst[...]``
    access)."""
    return x.index_select(0, idx)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Segment sum over rows (``fn.sum``); empty segments read 0."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, true_counts: torch.Tensor
                 ) -> torch.Tensor:
    """``fn.mean``: sum / true in-degree, 0 for a segment with none.
    ``true_counts`` [num_segments] counts each segment's real contributing
    edges (padding and dropped edges must already be zero in ``data``)."""
    s = segment_sum(data, segment_ids, num_segments)
    return s / _rows(true_counts.clamp_min(1.0), s)


def _segment_amax(data: torch.Tensor, segment_ids: torch.Tensor,
                  num_segments: int, fill: float) -> torch.Tensor:
    """Per-segment max over rows, ``fill`` for an empty segment; a
    cotangent is split equally among the rows that equal the max."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), fill)
    # int64: with the graph's int32 ids scatter_reduce's backward reads
    # its index wrongly (NaN gradients)
    idx = _rows(segment_ids.long(), data).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=False)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, valid: torch.Tensor) -> torch.Tensor:
    """``fn.max`` with DGL's zero fill: the max over each segment's valid
    rows (``valid`` bool [E]; padding and dropped edges excluded), 0 for a
    segment with none. Ties split the cotangent equally. The zero fill
    comes from a count of valid rows, not from the max, which a valid row
    at the f32 min would fool."""
    neg = torch.finfo(data.dtype).min
    m = _segment_amax(torch.where(_rows(valid, data), data, neg),
                      segment_ids, num_segments, neg)
    has_any = segment_sum(valid.to(data.dtype), segment_ids,
                          num_segments) > 0
    return torch.where(_rows(has_any, m), m, 0.0)


def segment_softmax(data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, valid: torch.Tensor) -> torch.Tensor:
    """Softmax over each dst segment's edges (GATv2-style attention), 0 on
    invalid edges."""
    vmask = _rows(valid, data)
    neg = torch.finfo(data.dtype).min
    seg_max = _segment_amax(torch.where(vmask, data, neg), segment_ids,
                            num_segments, neg)
    # an empty or all-invalid segment (max == neg) gets max 0; invalid
    # edges are masked BEFORE exp, or exp overflows for them and its
    # backward turns inf * 0 into NaN in every gradient
    seg_max = torch.where(seg_max > neg / 2, seg_max, 0.0)
    shifted = torch.where(
        vmask, data - seg_max.index_select(0, segment_ids), neg)
    e = torch.exp(shifted)  # exp(neg) == 0 on invalid edges
    denom = segment_sum(e, segment_ids, num_segments).clamp_min(
        torch.finfo(data.dtype).tiny)
    return e / denom.index_select(0, segment_ids)
