"""The SIR-GCN message-passing pipeline (port of
``sir_gcn_tpu/ops/message_passing.py``).

Math contract (reference ``models/conv.py``):

  sum/mean/sym:  h*_u = reduce_{(v,u) in E} s_vu * sigma(eq_u + ek_v [+ e_vu])
                 followed by W_R applied per node in the caller
  max:           h*_u = max_{(v,u) in E} sigma(eq_u + ek_v) @ W_R + b_R,
                 W_R per edge before the reduce; 0 for a node with no
                 incoming edge
  sym scale:     s_vu = out_deg(v)^-1/2 * in_deg(u)^-1/2, degrees clamped
                 >= 1; mean folds 1/clamp(in_deg(u), 1) into s_vu.

This port has the FastGraph branches: static scales for sum/mean/sym, with
an optional edge term (``e``, or ``e_basis`` and ``w_edge`` for the fused
route), and the max kernels, for a sigma in the activation registry. A
sigma that is not elementwise (centered_relu, softmax, or an entry with
``sir_elementwise=False``) takes the general route of sum/mean/sym without
an edge term. The other branches raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ell import (
    Activation,
    FastGraph,
    ell_sir_aggregate,
    ell_sir_aggregate_fused_edge,
    ell_sir_aggregate_max,
)

_EDGE_DTYPE: Optional[torch.dtype] = None  # None (f32) | torch.bfloat16


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


def sir_aggregate(graph, eq: torch.Tensor, ek: torch.Tensor, activation,
                  agg_type: str = "sum", *, e=None,
                  e_basis: Optional[torch.Tensor] = None,
                  w_edge: Optional[torch.Tensor] = None,
                  w_relation: Optional[torch.Tensor] = None,
                  b_relation: Optional[torch.Tensor] = None,
                  edge_mask=None) -> torch.Tensor:
    """Fused SIR edge aggregation: [N_pad, H] query and key projections
    -> [N_pad, H] for sum/mean/sym, [N_pad, O] for max. ``graph`` must be a
    FastGraph.

    ``e`` [E_pad, H] is an edge term in sorted edge order, added inside
    sigma. ``e_basis`` [E_pad, De] and ``w_edge`` [De, H] are the
    alternative for an affine edge encoder, e = e_basis @ w_edge: with a
    linear aggregation and a sigma in the registry they take the fused
    route, whose kernels form the projection themselves (the route the JAX
    package takes on its accelerator); otherwise the projection is formed
    here and the ``e`` route runs. ``e_basis`` gets no gradient.

    max needs ``w_relation`` [H, O] (and takes ``b_relation`` [O]), the W_R
    applied per edge before the reduce, and takes the max kernels for a
    sigma in the activation registry (the route of the JAX package's
    ``_max_pallas_route``); the linear aggregations ignore both (the caller
    applies W_R per node). A sigma that is not elementwise takes the
    general route (``ell_sir_aggregate``) of a linear aggregation. Any
    other sigma raises; so do max with edge features, a sigma that is not
    elementwise with edge features or max, and DropEdge masks (dynamic
    scales), not yet ported."""
    if agg_type not in ("sum", "mean", "max", "sym"):
        raise NotImplementedError(f"agg_type = {agg_type} not implemented")
    if e is not None and e_basis is not None:
        raise ValueError("pass e or (e_basis, w_edge), not both")
    if e_basis is not None and w_edge is None:
        raise ValueError("e_basis needs w_edge")
    if edge_mask is not None:
        raise NotImplementedError("DropEdge masks (dynamic scales) are not "
                                  "yet ported")
    if not isinstance(graph, FastGraph):
        raise NotImplementedError(
            "the CSR aggregate on a plain GraphBatch is not yet ported; "
            "build a FastGraph")
    if e_basis is not None:
        if agg_type != "max" and isinstance(activation, Activation):
            return ell_sir_aggregate_fused_edge(
                graph, eq, ek, e_basis, w_edge, activation, agg_type,
                edge_dtype=get_edge_dtype())
        e = (e_basis @ w_edge).to(eq.dtype)
    if agg_type == "max":
        if e is not None:
            raise NotImplementedError("max aggregation with edge features "
                                      "is not yet ported")
        if w_relation is None:
            raise ValueError("max aggregation needs W_R per edge "
                             "(w_relation)")
        return ell_sir_aggregate_max(graph, eq, ek, w_relation, b_relation,
                                     activation,
                                     edge_dtype=get_edge_dtype())
    return ell_sir_aggregate(graph, eq, ek, activation, agg_type, e=e,
                             edge_dtype=get_edge_dtype())
