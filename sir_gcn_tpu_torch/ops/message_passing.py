"""The SIR-GCN message-passing pipeline (port of
``sir_gcn_tpu/ops/message_passing.py``).

Math contract (reference ``models/conv.py``):

  sum/mean/sym:  h*_u = reduce_{(v,u) in E} s_vu * sigma(eq_u + ek_v)
                 followed by W_R applied per node in the caller
  sym scale:     s_vu = out_deg(v)^-1/2 * in_deg(u)^-1/2, degrees clamped
                 >= 1; mean folds 1/clamp(in_deg(u), 1) into s_vu.

This slice ports the FastGraph static-scale branch, the one the ogbn-arxiv
training step takes. The other branches raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ell import FastGraph, ell_sir_aggregate

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
                  agg_type: str = "sum", *, e=None, edge_mask=None
                  ) -> torch.Tensor:
    """Fused SIR edge aggregation: [N_pad, H] query and key projections
    -> [N_pad, H]. ``graph`` must be a FastGraph; edge features and
    DropEdge masks (dynamic scales) are not yet ported."""
    if agg_type not in ("sum", "mean", "max", "sym"):
        raise NotImplementedError(f"agg_type = {agg_type} not implemented")
    if agg_type == "max":
        raise NotImplementedError("max aggregation is not yet ported")
    if e is not None:
        raise NotImplementedError("edge features are not yet ported")
    if edge_mask is not None:
        raise NotImplementedError("DropEdge masks are not yet ported")
    if not isinstance(graph, FastGraph):
        raise NotImplementedError(
            "the CSR aggregate on a plain GraphBatch is not yet ported; "
            "build a FastGraph")
    return ell_sir_aggregate(graph, eq, ek, activation, agg_type,
                             edge_dtype=get_edge_dtype())
