"""The SIR-GCN message-passing pipeline (port of
``sir_gcn_tpu/ops/message_passing.py``).

Math contract (reference ``models/conv.py``):

  sum/mean/sym:  h*_u = reduce_{(v,u) in E} s_vu * sigma(eq_u + ek_v [+ e_vu])
                 followed by W_R applied per node in the caller
  max:           h*_u = max_{(v,u) in E} sigma(eq_u + ek_v [+ e_vu]) @ W_R
                 + b_R, W_R per edge before the reduce; 0 for a node with
                 no incoming edge
  sym scale:     s_vu = out_deg(v)^-1/2 * in_deg(u)^-1/2, degrees clamped
                 >= 1; mean divides by the count of valid in-edges.

Every route of the JAX package's ``sir_aggregate``: on a FastGraph the
kernels (static scales, or DropEdge's dynamic ones under ``edge_mask``),
or the pure ELL route for a sigma outside the activation registry that
holds tensors (JAX's XLA route); on a plain ``GraphBatch`` the CSR
aggregate over ``ops/segment.py``, which a ``ShardedGraph`` (one rank's
rows of a graph partitioned by node ranges, ``parallel/full_graph.py``)
takes too, its src gathers reading every rank's rows; on a ``HaloGraph``
(one rank's shard for the boundary-only exchange) the halo aggregate of
``parallel/halo.py``. Max on a FastGraph takes the max kernels for every
registry sigma, elementwise or row-wise, with or without an edge term. On
a CUDA tensor a parameter-free sigma outside the registry raises (JAX
runs it on its Pallas kernels).
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch

from ..graph import GraphBatch
from . import segment as seg
from .ell import (
    Activation,
    FastGraph,
    ell_sir_aggregate,
    ell_sir_aggregate_fused_edge,
    ell_sir_aggregate_max,
)

_EDGE_DTYPE: Optional[torch.dtype] = None  # None (f32) | torch.bfloat16

# Scale guards: an edge term or max aggregation off the kernels (the pure
# ELL route, the halo's pure variants, the CSR aggregate) forms an
# [E_pad, H] table per layer and differentiates through gathers of it.
# Above these sizes sir_aggregate warns once per padded edge count.
EDGE_FEATURE_EDGE_LIMIT = 500_000
MAX_AGG_WARN_EDGES = 500_000
_ALLOW_LARGE_EDGE_AGG = False
_EDGE_AGG_WARNED: set = set()
_MAX_AGG_WARNED: set = set()


def allow_large_edge_aggregate(enabled: bool = True) -> None:
    """Silence the edge-term scale warning of :func:`sir_aggregate` (an
    edge term off the kernels above ``EDGE_FEATURE_EDGE_LIMIT`` padded
    edges)."""
    global _ALLOW_LARGE_EDGE_AGG
    _ALLOW_LARGE_EDGE_AGG = bool(enabled)


def _scale_guards(graph, agg_type: str, has_edge_feats: bool,
                  kernel_route: bool) -> None:
    """Once-per-size cost warnings for an edge term or max aggregation
    that no kernel computes (``kernel_route`` False): the pure ELL route,
    the halo's pure variants or the CSR aggregate, each of which keeps
    per-edge [E_pad, H] tables for the backward."""
    if kernel_route:
        return
    e_pad = int(graph.e_pad)
    if (has_edge_feats and e_pad > EDGE_FEATURE_EDGE_LIMIT
            and not _ALLOW_LARGE_EDGE_AGG and e_pad not in _EDGE_AGG_WARNED):
        _EDGE_AGG_WARNED.add(e_pad)
        warnings.warn(
            f"sir_aggregate with an edge term on a graph with {e_pad} "
            f"padded edges (> {EDGE_FEATURE_EDGE_LIMIT}) takes a route with "
            f"no kernel (the pure ELL route, the halo's pure variant or the "
            f"CSR aggregate): it forms [E_pad, H] edge tables each layer "
            f"and runs several times slower than the kernel routes "
            f"(PERF.md). On a FastGraph with a registry sigma the edge "
            f"kernels take it; pass (e_basis, w_edge) for the fused edge "
            f"route. Call sir_gcn_tpu_torch.ops.message_passing."
            f"allow_large_edge_aggregate(True) to silence this warning.",
            stacklevel=3)
    if (agg_type == "max" and e_pad > MAX_AGG_WARN_EDGES
            and e_pad not in _MAX_AGG_WARNED):
        _MAX_AGG_WARNED.add(e_pad)
        warnings.warn(
            f"max aggregation on a graph with {e_pad} padded edges takes a "
            f"route with no kernel (the pure ELL route, the halo's pure "
            f"variant or the CSR aggregate): the per-edge W_R product "
            f"before the reduce (reference models/conv.py:47) runs on "
            f"[E_pad, H] tables. On a FastGraph with a registry sigma the "
            f"max kernels take it; consider sum, mean or sym at full-graph "
            f"scale otherwise.", stacklevel=3)


def set_edge_dtype(dtype: Optional[torch.dtype]) -> None:
    """Set the type the edge pipeline carries its gathered operands in
    (None = f32; torch.bfloat16 halves the gathered bytes, sums stay
    f32)."""
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"edge dtype {dtype} is not f32 or bf16")
    global _EDGE_DTYPE
    _EDGE_DTYPE = None if dtype == torch.float32 else dtype


def get_edge_dtype() -> Optional[torch.dtype]:
    return _EDGE_DTYPE


def _edge_scale(graph, agg_type: str) -> Optional[torch.Tensor]:
    """Per-edge symmetric-norm scale s_vu [E_pad] of the CSR aggregate from
    the graph's full degrees (DropEdge does not renormalize it), or None
    for the other aggregations. The src side is read through the graph's
    src gather, which on a rank's ``ShardedGraph`` reads every rank's
    rows."""
    if agg_type != "sym":
        return None
    in_norm = graph.in_deg.clamp_min(1.0).pow(-0.5)
    out_norm = graph.out_deg.clamp_min(1.0).pow(-0.5)
    return (seg.gather_rows(out_norm, graph.src_segments)
            * seg.gather_rows(in_norm, graph.dst_segments))


def _valid(graph, edge_mask) -> torch.Tensor:
    """The graph's edge mask, and ``edge_mask`` (DropEdge) when given."""
    return graph.edge_mask if edge_mask is None else (graph.edge_mask
                                                      & edge_mask)


def sir_aggregate(graph, eq: torch.Tensor, ek: torch.Tensor, activation,
                  agg_type: str = "sum", *, e=None,
                  e_basis: Optional[torch.Tensor] = None,
                  w_edge: Optional[torch.Tensor] = None,
                  w_relation: Optional[torch.Tensor] = None,
                  b_relation: Optional[torch.Tensor] = None,
                  edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused SIR edge aggregation: [N_pad, H] query and key projections
    -> [N_pad, H] for sum/mean/sym, [N_pad, O] for max.

    ``e`` [E_pad, H] is an edge term in sorted edge order, added inside
    sigma. ``e_basis`` [E_pad, De] and ``w_edge`` [De, H] are the
    alternative for an affine edge encoder, e = e_basis @ w_edge: on a
    FastGraph with a linear aggregation and a registry sigma whose route is
    elementwise they take the fused route, whose kernels form the
    projection themselves; otherwise (as in JAX) the projection is formed
    here and ``e`` takes the route, the general route's edge-term kernels
    for a sigma that is not elementwise. ``e_basis`` gets no gradient. max
    needs ``w_relation`` [H, O] (and takes ``b_relation`` [O]), the W_R
    applied per edge before the reduce; the linear aggregations ignore
    both.
    ``edge_mask`` bool [E_pad] (DropEdge) drops edges on top of the
    padding mask.

    On a FastGraph, a registry sigma takes the kernels: with no
    ``edge_mask`` the static per-slot scales, with one those of the kept
    edges (``ops/ell.py`` ``slot_scale``; mean divides by the kept
    in-edges after the aggregate, max takes them as validity). A sigma
    that is not elementwise takes the general route of a linear
    aggregation, with or without an edge term, at any width; max takes
    the max kernels for every registry sigma (a row-wise one over each
    slot's H features), with or without an edge term. A sigma
    outside the registry that holds tensors takes the
    pure ELL route (``pure_ell_sir_aggregate``, the JAX package's XLA
    route), for every aggregation, with or without ``e`` and
    ``edge_mask``; on the CPU any callable does. On a plain ``GraphBatch``
    the CSR aggregate runs with any torch callable sigma, differentiated by
    autograd.

    On a ``HaloGraph`` ``eq`` and ``ek`` are the rank's own node rows
    and ``e`` and ``edge_mask`` are global, in sorted edge order
    (``parallel/halo.py`` ``halo_sir_aggregate``). A ``ShardedGraph`` is a
    plain ``GraphBatch`` of the rank's rows and in-edges and takes the CSR
    aggregate with any sigma: ``eq`` and ``ek`` are the rank's rows, ``e``
    and ``edge_mask`` its run of edges, and the gather of ``ek`` by src
    all-gathers every rank's rows first (no kernel, as on JAX's GSPMD
    path).

    An edge term or max off the kernels warns once per graph size above
    ``EDGE_FEATURE_EDGE_LIMIT`` and ``MAX_AGG_WARN_EDGES`` padded edges
    (:func:`allow_large_edge_aggregate` silences the first).

    Raises on a CUDA tensor for a parameter-free sigma outside the
    registry (``resolve_activation``), which JAX runs on its Pallas
    kernels."""
    if agg_type not in ("sum", "mean", "max", "sym"):
        raise NotImplementedError(f"agg_type = {agg_type} not implemented")
    if e is not None and e_basis is not None:
        raise ValueError("pass e or (e_basis, w_edge), not both")
    if e_basis is not None and w_edge is None:
        raise ValueError("e_basis needs w_edge")
    if agg_type == "max" and w_relation is None:
        raise ValueError("max aggregation needs W_R per edge (w_relation)")
    from ..parallel.halo import HaloGraph, halo_sir_aggregate

    if not isinstance(graph, (FastGraph, GraphBatch, HaloGraph)):
        raise NotImplementedError(
            f"sir_aggregate on a {type(graph).__name__}: not a GraphBatch, "
            f"FastGraph or HaloGraph")
    fused = (e_basis is not None and isinstance(graph, FastGraph)
             and agg_type != "max" and isinstance(activation, Activation)
             and activation.elementwise)
    if e_basis is not None and not fused:
        e = (e_basis @ w_edge).to(eq.dtype)
    _scale_guards(graph, agg_type, e is not None or fused,
                  kernel_route=(isinstance(graph, FastGraph)
                                and isinstance(activation, Activation)))
    if isinstance(graph, HaloGraph):
        return halo_sir_aggregate(graph, eq, ek, activation, agg_type, e=e,
                                  w_relation=w_relation,
                                  b_relation=b_relation,
                                  edge_mask=edge_mask)
    if not isinstance(graph, FastGraph):
        return _csr_aggregate(graph, eq, ek, activation, agg_type, e,
                              w_relation, b_relation, edge_mask)

    if agg_type == "max":
        return ell_sir_aggregate_max(graph, eq, ek, w_relation, b_relation,
                                     activation, e=e, edge_mask=edge_mask,
                                     edge_dtype=get_edge_dtype())
    if fused:
        return ell_sir_aggregate_fused_edge(
            graph, eq, ek, e_basis, w_edge, activation, agg_type,
            edge_mask=edge_mask, edge_dtype=get_edge_dtype())
    return ell_sir_aggregate(graph, eq, ek, activation, agg_type, e=e,
                             edge_mask=edge_mask, edge_dtype=get_edge_dtype())


def _reduce_messages(graph, m: torch.Tensor, agg_type: str,
                     valid: torch.Tensor,
                     scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Reduce per-edge messages [E_pad, ...] by dst: the max over valid
    edges (0 for none), or the masked sum of ``scale`` * m, divided by the
    valid in-degree for mean."""
    n, dst = graph.n_pad, graph.dst_segments
    if agg_type == "max":
        return seg.segment_max(m, dst, n, valid)
    vmask = valid.reshape((-1,) + (1,) * (m.dim() - 1))
    if scale is not None:
        m = m * scale.reshape(vmask.shape)
    m = torch.where(vmask, m, 0.0)
    if agg_type == "mean":
        counts = seg.segment_sum(valid.to(m.dtype), dst, n)
        return seg.segment_mean(m, dst, n, counts)
    return seg.segment_sum(m, dst, n)


def _csr_aggregate(graph, eq, ek, activation, agg_type, e, w_relation,
                   b_relation, edge_mask) -> torch.Tensor:
    """The generic branch of ``sir_aggregate``: per-edge messages over the
    dst-sorted edge arrays, reduced by segment."""
    z = (seg.gather_rows(eq, graph.dst_segments)
         + seg.gather_rows(ek, graph.src_segments))
    if e is not None:
        z = z + e
    m = activation(z)
    if agg_type == "max":
        m = m @ w_relation
        if b_relation is not None:
            m = m + b_relation
    return _reduce_messages(graph, m, agg_type, _valid(graph, edge_mask),
                            _edge_scale(graph, agg_type))


def sir_aggregate_concat(graph, eq: torch.Tensor, ek: torch.Tensor,
                         message_func: Callable, agg_type: str = "sum", *,
                         e: Optional[torch.Tensor] = None,
                         edge_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The concatenated form ``reduce g([h_u || h_v (|| h_uv)])`` of
    ``SIRConvBase`` / ``SIREConvBase`` (reference conv.py:156-158,
    199-201), on the dst-sorted edge arrays of a ``GraphBatch`` or
    FastGraph. The columns are ordered as the reference's
    ``torch.cat((edges.dst['eq'], edges.src['ek'], edges.data['e']))``, so
    its message-MLP weights carry over; ``message_func`` is any row-wise
    torch callable; sym scales by the degree norms."""
    if agg_type not in ("sum", "mean", "max", "sym"):
        raise NotImplementedError(f"agg_type = {agg_type} not implemented")
    parts = [seg.gather_rows(eq, graph.dst_segments),
             seg.gather_rows(ek, graph.src_segments)]
    if e is not None:
        parts.append(e)
    m = message_func(torch.cat(parts, -1))
    return _reduce_messages(graph, m, agg_type, _valid(graph, edge_mask),
                            _edge_scale(graph, agg_type))


def copy_src_aggregate(graph, x: torch.Tensor, agg_type: str = "sum", *,
                       edge_scale: Optional[torch.Tensor] = None,
                       edge_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """``update_all(fn.copy_u, fn.sum|mean|max)``: the plain SpMM of the
    Correct & Smooth label spreading
    (``benchmark-datasets/ogbn-arxiv/correct_and_smooth.py:41-58``) and of
    GCN/GIN-style baseline convs. ``edge_scale`` [E_pad] weights each
    edge's message for sum and mean."""
    m = seg.gather_rows(x, graph.src_segments)
    return _reduce_messages(graph, m, agg_type, _valid(graph, edge_mask),
                            edge_scale)
