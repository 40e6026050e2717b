"""Segment and gather primitives of the CSR aggregate on a plain
``GraphBatch`` (port of ``sir_gcn_tpu/ops/segment.py``): DGL's
``update_all`` reducers ``fn.sum``, ``fn.mean`` and ``fn.max`` over edge
arrays sorted by dst, in plain PyTorch.

``segment_sum`` adds with ``index_add`` on the CPU, in row order. On a
CUDA device it sums each segment in a fixed order, as the JAX package's
sorted segment sum does, so that a card's sums repeat their bits from run
to run (``index_add`` there adds in the order its atomics land): a
:class:`Segments` plan of ``torch.segment_reduce`` levels over the sorted
runs of ids, whose pieces hold at most ``PIECE`` rows, so that no thread
walks a long segment alone (the batched graphs' padding edges all land
on one node). ``gather_rows``'s backward, a sum of the cotangent's rows
by index, takes the same plans there in place of ``index_select``'s
atomic backward. A graph keeps the plans of its dst, src and
``node2graph`` ids (``GraphBatch.dst_segments``, ``src_segments``,
``graph_segments``), so a step builds each once. Integer data keeps
``index_add``: its sums are exact in any order. The maxes do not depend
on order.

Each reducer takes its ids as a tensor (unsorted, for all the function
knows: a CUDA sum sorts them first, stably) or as :class:`Segments`.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

# the most rows a piece of one level of the card's fixed-order sum holds
PIECE = 128


class Segments:
    """Segment ids [E] in [0, num_segments), with the plan of the card's
    fixed-order sum, built at its first use: the stable order that sorts
    the ids (None if ``sorted_ids``) and each level's row offsets. Each
    level cuts its rows into pieces that lie within one segment and within
    one aligned run of ``PIECE`` rows; the next level's rows are the piece
    sums, still sorted by segment, until no segment can hold more than
    ``PIECE`` of them; the last level's offsets are the segments'. The
    plan is built on the ids' device with no host sync.

    What a graph knows shortens the plan: the last ``tail`` rows (in
    sorted order) all hold the last id (a graph's padding edges or nodes)
    and are summed apart by one reduction over rows, and no other run is
    longer than ``max_run`` (None: the ids' length), so a batch of small
    graphs takes no level but the last.

    ``source``, where given, makes the table the ids index from the rows
    that :func:`gather_rows` is handed: on one rank's shard of a graph
    partitioned by node ranges, the whole graph's rows (an all-gather with
    a gradient) from the rank's own."""

    def __init__(self, ids: torch.Tensor, num_segments: int,
                 sorted_ids: bool = False, *, tail: int = 0,
                 max_run: Optional[int] = None,
                 source: Optional[Callable] = None):
        self.ids = ids
        self.num_segments = num_segments
        self.sorted_ids = sorted_ids
        self.tail = tail
        self.max_run = max_run
        self.source = source
        self._plan: Optional[tuple] = None

    def plan(self) -> tuple:
        """(order or None, [offsets of each level])."""
        if self._plan is None:
            self._plan = _build_plan(self.ids, self.num_segments,
                                     self.sorted_ids, self.tail,
                                     self.max_run)
        return self._plan

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        """The segment sum of ``data``'s rows in the plan's order; its
        gradient is a gather of the cotangent."""
        order, levels = self.plan()
        if order is not None:
            data = data.index_select(0, order)
        rows = data.shape[0] - self.tail
        head = data[:rows]
        for offsets in levels:
            head = torch.segment_reduce(head, "sum", offsets=offsets,
                                        unsafe=True, initial=0)
        if not self.tail:
            return head
        last = head[-1:] + data[rows:].sum(0, keepdim=True)
        return torch.cat([head[:-1], last])


def _build_plan(ids: torch.Tensor, n: int, sorted_ids: bool, tail: int,
                max_run: Optional[int]) -> tuple:
    ids = ids.long()
    order = None
    if not sorted_ids:
        ids, order = torch.sort(ids, stable=True)
    ids = ids[:ids.shape[0] - tail]
    seg = torch.arange(n + 1, device=ids.device)
    levels = []
    rows = ids.shape[0]
    span = rows if max_run is None else max_run  # the longest run
    while span > PIECE:
        starts = torch.searchsorted(ids, seg)  # [n + 1], the last = rows
        cuts = torch.arange(0, rows, PIECE, device=ids.device)
        # a piece starts at each segment's start (an empty one's stays
        # empty, its own) and at each cut (the segment that holds it);
        # ordered by (start, segment), the pieces' segments stay sorted
        key = torch.sort(torch.cat([
            starts[:-1] * (n + 1) + seg[:-1],
            cuts * (n + 1) + torch.searchsorted(starts[1:], cuts,
                                                right=True)])).values
        levels.append(torch.cat([
            torch.div(key, n + 1, rounding_mode="floor"), starts[-1:]]))
        ids = key % (n + 1)
        rows, span = key.shape[0], -(-span // PIECE) + 2
    levels.append(torch.searchsorted(ids, seg))
    return order, levels


SegmentIds = Union[torch.Tensor, Segments]


def _ids(segment_ids: SegmentIds) -> torch.Tensor:
    return (segment_ids.ids if isinstance(segment_ids, Segments)
            else segment_ids)


def _rows(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """A per-row [E] tensor shaped to broadcast over ``data``'s rows."""
    return mask.reshape((-1,) + (1,) * (data.dim() - 1))


class _Gather(torch.autograd.Function):
    """``x[ids]`` whose backward sums the cotangent's rows into x's rows
    in the fixed order of ``segments`` (where ``index_select``'s backward
    adds by atomics on a card)."""

    @staticmethod
    def forward(ctx, x, segments):
        ctx.segments, ctx.rows = segments, x.shape[0]
        return x.index_select(0, segments.ids)

    @staticmethod
    def backward(ctx, g):
        return segment_sum(g, ctx.segments, ctx.rows), None


def gather_rows(x: torch.Tensor, idx: SegmentIds) -> torch.Tensor:
    """Row gather ``x[idx]`` (DGL's ``edges.src[...]`` / ``edges.dst[...]``
    access). On a CUDA device, where ``x`` needs a gradient, the backward
    is the fixed-order segment sum over ``idx`` (given as ``Segments`` over
    x's rows, a graph's own, so that its plan is built once). Segments
    with a ``source`` gather from ``source(x)``."""
    if isinstance(idx, Segments) and idx.source is not None:
        x = idx.source(x)
    ids = _ids(idx)
    if (x.device.type == "cpu" or not x.is_floating_point()
            or not (torch.is_grad_enabled() and x.requires_grad)):
        return x.index_select(0, ids)
    if not (isinstance(idx, Segments) and idx.num_segments == x.shape[0]):
        idx = Segments(ids, x.shape[0])
    return _Gather.apply(x, idx)


def segment_sum(data: torch.Tensor, segment_ids: SegmentIds,
                num_segments: int) -> torch.Tensor:
    """Segment sum over rows (``fn.sum``); empty segments read 0. On a
    CUDA device a float sum is summed in a fixed order (:class:`Segments`)."""
    if data.device.type == "cpu" or not data.is_floating_point():
        out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
        return out.index_add(0, _ids(segment_ids), data)
    if not isinstance(segment_ids, Segments):
        segment_ids = Segments(segment_ids, num_segments)
    return segment_ids.sum(data)


def segment_mean(data: torch.Tensor, segment_ids: SegmentIds,
                 num_segments: int, true_counts: torch.Tensor
                 ) -> torch.Tensor:
    """``fn.mean``: sum / true in-degree, 0 for a segment with none.
    ``true_counts`` [num_segments] counts each segment's real contributing
    edges (padding and dropped edges must already be zero in ``data``)."""
    s = segment_sum(data, segment_ids, num_segments)
    return s / _rows(true_counts.clamp_min(1.0), s)


def _segment_amax(data: torch.Tensor, segment_ids: SegmentIds,
                  num_segments: int, fill: float) -> torch.Tensor:
    """Per-segment max over rows, ``fill`` for an empty segment; a
    cotangent is split equally among the rows that equal the max."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), fill)
    # int64: with the graph's int32 ids scatter_reduce's backward reads
    # its index wrongly (NaN gradients)
    idx = _rows(_ids(segment_ids).long(), data).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=False)


def segment_max(data: torch.Tensor, segment_ids: SegmentIds,
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


def segment_softmax(data: torch.Tensor, segment_ids: SegmentIds,
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
        vmask, data - gather_rows(seg_max, segment_ids), neg)
    e = torch.exp(shifted)  # exp(neg) == 0 on invalid edges
    denom = segment_sum(e, segment_ids, num_segments).clamp_min(
        torch.finfo(data.dtype).tiny)
    return e / gather_rows(denom, segment_ids)
