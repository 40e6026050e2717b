"""Distributed ELL aggregate with the all-gather exchange (port of
``sir_gcn_tpu/parallel/ell_distributed.py``): the full graph's nodes split
into equal contiguous ranges, one a rank, and each rank aggregates into
its own dst rows.

Host side (once): the dst-sorted edges of shard s are one contiguous
slice; per shard a dst :class:`~sir_gcn_tpu_torch.ops.ell.ReducePlan` over
local dst keys and a src plan over global src keys, harmonized to one
bucket structure (:func:`~sir_gcn_tpu_torch.ops.ell.harmonize_reduce_plans`).

Step, on each rank:

    ek_full = all_gather(ek_shard)          # in the edge dtype
    out_shard = the local SIR aggregate over the dst plan, reading src rows
                of ek_full

Backward: g_eq = g * sbar (the derivative mass of the forward), and the
src-keyed partials of g_ek over the src plan, reduce-scattered back to
their owners (the transpose of the all-gather, in f32).

With a registry sigma that is elementwise the local compute runs the port's
kernels: ``ell_act_reduce2`` (#2) forward, ``ell_src_bwd`` (#4) backward,
``ell_act_reduce`` (#1) for a forward without a gradient; on a CUDA tensor
they launch or raise. Any other sigma takes the pure route, the JAX
package's ``use_pallas=False`` program in PyTorch on the same plans.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from ..graph import GraphBatch
from ..ops.cuda import ell_act_reduce, ell_act_reduce2, ell_src_bwd
from ..ops.ell import (
    ReducePlan,
    _cast,
    _SlotSum,
    build_reduce_plan,
    harmonize_reduce_plans,
    resolve_activation,
    static_edge_scale,
    uniform_stage2,
)
from .collectives import (
    all_gather_rows,
    gather_rows,
    rank_of,
    reduce_scatter_rows,
)


def _stack(per_shard: list, dtype) -> torch.Tensor:
    return torch.from_numpy(np.stack(per_shard).astype(dtype))


def take_shard(obj, r: int, device) -> SimpleNamespace:
    """Shard ``r`` of a stacked dataclass (``ShardedFastGraph``,
    ``HaloFastGraph``) on ``device``: each tuple of plans gives plan r,
    each tensor with a leading shard axis its row r, and every other field
    is kept."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, tuple) and v and isinstance(v[0], ReducePlan):
            v = v[r].to(device)
        elif isinstance(v, torch.Tensor) and f.metadata.get("per_shard",
                                                            True):
            v = v[r].to(device)
        out[f.name] = v
    return SimpleNamespace(**out)


@dataclasses.dataclass(frozen=True)
class ShardedFastGraph:
    """Every shard's plans for the all-gather aggregate, on the host. The
    tuples hold one plan a shard; the tensors have a leading shard axis S.
    :func:`take_shard` gives one rank's view on its device."""

    dst_plan: tuple               # S plans over local dst keys
    src_plan: tuple               # S plans over global src keys
    slot_srcnode: torch.Tensor    # [S, S1] global src id per dst slot
    src_from_dst_slot: torch.Tensor  # [S, S1s] dst slot per src slot
    slot_scale: torch.Tensor      # [S, S1] static scale (validity folded)
    src_slot_dstnode: torch.Tensor  # [S, S1s] local dst id per src slot
    src_slot_scale: torch.Tensor  # [S, S1s] static scale per src slot
    n_shards: int
    n_local: int


def _regather(plans, bounds, per_edge):
    """Each shard's per-edge values laid into its plan's slot order."""
    out = []
    for s, p in enumerate(plans):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        se = p.host["slot_edge"]
        sv = p.host["slot_valid"] > 0
        res = np.zeros(p.num_slots, per_edge[s].dtype)
        if hi > lo:
            res[sv] = per_edge[s][se[sv]]
        out.append(res)
    return out


def build_sharded_fast_graph(graph: GraphBatch, n_shards: int,
                             agg_type: str = "sum",
                             max_budget: int = 256) -> ShardedFastGraph:
    """Host side: every shard's harmonized plans for a dst-sorted
    ``GraphBatch``, with the static scale of ``agg_type`` ('sym' degree
    norms, 'mean' 1/in-degree, 'sum' validity) folded into the slots."""
    if graph.n_pad % n_shards:
        raise ValueError(f"n_pad {graph.n_pad} is not a multiple of "
                         f"{n_shards} shards")
    n_local = graph.n_pad // n_shards
    h = graph.host
    src = np.asarray(h["src"], np.int64)
    dst = np.asarray(h["dst"], np.int64)
    valid = np.asarray(h["edge_mask"], bool)
    escale = static_edge_scale(agg_type, src, dst, valid, h["in_deg"],
                               h["out_deg"]).astype(np.float32)
    # dst-sorted: shard s owns the edge slice with dst in its node range
    bounds = np.searchsorted(dst, np.arange(n_shards + 1) * n_local)

    dplans, splans, dargs, sargs = [], [], [], []
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        d_l, s_g, v_l = dst[lo:hi] - s * n_local, src[lo:hi], valid[lo:hi]
        dargs.append((d_l, v_l, n_local, max_budget))
        sargs.append((s_g, v_l, graph.n_pad, max_budget))
        dplans.append(build_reduce_plan(*dargs[-1]))
        splans.append(build_reduce_plan(*sargs[-1]))
    dplans = harmonize_reduce_plans(uniform_stage2(dplans, dargs))
    splans = harmonize_reduce_plans(uniform_stage2(splans, sargs))

    sl = lambda a: [a[int(bounds[s]):int(bounds[s + 1])]
                    for s in range(n_shards)]
    dst_l = [d - s * n_local for s, d in enumerate(sl(dst))]
    d2s = []
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        dp, sp = dplans[s].host, splans[s].host
        e2d = np.zeros(max(hi - lo, 1), np.int64)
        dvalid = dp["slot_valid"] > 0
        e2d[dp["slot_edge"][dvalid]] = np.nonzero(dvalid)[0]
        svalid = sp["slot_valid"] > 0
        res = np.zeros(splans[s].num_slots, np.int64)
        if hi > lo:
            res[svalid] = e2d[sp["slot_edge"][svalid]]
        d2s.append(res)

    return ShardedFastGraph(
        dst_plan=tuple(dplans), src_plan=tuple(splans),
        slot_srcnode=_stack(_regather(dplans, bounds, sl(src)), np.int32),
        src_from_dst_slot=_stack(d2s, np.int32),
        slot_scale=_stack(_regather(dplans, bounds, sl(escale)), np.float32),
        src_slot_dstnode=_stack(_regather(splans, bounds, dst_l), np.int32),
        src_slot_scale=_stack(_regather(splans, bounds, sl(escale)),
                              np.float32),
        n_shards=n_shards, n_local=n_local)


# ----------------------------------------------------------------------
# The pure route's pieces (shared with the halo aggregate)
# ----------------------------------------------------------------------

class StageInputs(torch.autograd.Function):
    """z [S, H] = eq[slot key] + table[slot_src] (+ e[slot edge]) on the
    dst plan ``dplan``, with the JAX package's scatter-free transpose:
    g_z is masked to valid slots; g_eq reduces it by dst key; g_table takes
    it into the key-plan slot order (``src_from_dst``) and reduces it by
    ``kplan``'s keys (the table's rows); g_e reads each edge's slot
    (``edge2dst``) weighted by ``edge_w`` (both None without ``e``)."""

    @staticmethod
    def forward(ctx, eq, table, e, dplan: ReducePlan, slot_src,
                kplan: ReducePlan, src_from_dst, edge2dst, edge_w):
        z = dplan.spread(eq) + table.index_select(0, slot_src).to(eq.dtype)
        if e is not None:
            z = z + dplan.gather_edges(e)
        ctx.dplan, ctx.kplan = dplan, kplan
        ctx.save_for_backward(src_from_dst, edge2dst, edge_w)
        return z

    @staticmethod
    def backward(ctx, g_z):
        src_from_dst, edge2dst, edge_w = ctx.saved_tensors
        dplan, kplan = ctx.dplan, ctx.kplan
        g_z = g_z * dplan.slot_valid[:, None]
        g_eq = g_t = g_e = None
        if ctx.needs_input_grad[0]:
            g_eq = dplan.reduce_slots_sum(g_z)
        if ctx.needs_input_grad[1]:
            g_t = kplan.reduce_slots_sum(
                g_z.index_select(0, src_from_dst)
                * kplan.slot_valid[:, None])
        if ctx.needs_input_grad[2]:
            g_e = g_z.index_select(0, edge2dst) * edge_w[:, None]
        return g_eq, g_t, g_e, None, None, None, None, None, None


# ----------------------------------------------------------------------
# The all-gather aggregate
# ----------------------------------------------------------------------

def sharded_local_forward(loc, eq_l, ek_full, act, derivative: bool):
    """One rank's forward on its dst plan: (out, sbar) from
    ``ell_act_reduce2`` (#2), or out alone from ``ell_act_reduce`` (#1)
    without ``derivative``. ``ek_full`` [N_pad, H] is the gathered table
    in the edge dtype."""
    plan = loc.dst_plan
    args = (eq_l.contiguous(), ek_full.contiguous(), loc.slot_srcnode,
            loc.slot_scale, plan.row_key, plan.row_ptr, act)
    if not derivative:
        return plan.finalize_rows_sum(ell_act_reduce(*args))
    rows, srows = ell_act_reduce2(*args)
    return plan.finalize_rows_sum(rows), plan.finalize_rows_sum(srows)


def sharded_local_backward(loc, g_l, eq_l, ek_full, act, edge_dtype):
    """One rank's src-keyed partial of g_ek [N_pad, H] f32 from
    ``ell_src_bwd`` (#4) over its src plan, reading the gathered table
    ``ek_full`` in f32 (as the single-card backward reads ek); the
    reduce-scatter sums the partials into their owners' rows."""
    plan = loc.src_plan
    rows = ell_src_bwd(_cast(eq_l, edge_dtype), _cast(g_l, edge_dtype),
                       ek_full.contiguous(), loc.src_slot_dstnode,
                       loc.src_slot_scale, plan.row_key, plan.row_ptr, act)
    return plan.finalize_rows_sum(rows)


class _ShardedAggregate(torch.autograd.Function):
    """Forward: the all-gather in the edge dtype, then #2. Backward: g_eq =
    g * sbar; #4 on the gathered table in f32 (gathered again in f32 with
    a bf16 edge dtype), the partials reduce-scattered in f32."""

    @staticmethod
    def forward(ctx, eq, ek, loc, act, edge_dtype, group):
        ek_full = all_gather_rows(_cast(ek, edge_dtype), group)
        out, sbar = sharded_local_forward(loc, eq, ek_full, act, True)
        if ek_full.dtype != torch.float32:
            ek_full = all_gather_rows(ek.contiguous(), group)
        ctx.save_for_backward(eq, ek_full, sbar)
        ctx.loc, ctx.act, ctx.edge_dtype, ctx.group = (loc, act, edge_dtype,
                                                       group)
        return out

    @staticmethod
    def backward(ctx, g):
        eq, ek_full, sbar = ctx.saved_tensors
        g = g.contiguous()
        g_eq = g * sbar if ctx.needs_input_grad[0] else None
        g_ek = None
        if ctx.needs_input_grad[1]:
            g_ek = reduce_scatter_rows(sharded_local_backward(
                ctx.loc, g, eq, ek_full, ctx.act, ctx.edge_dtype), ctx.group)
        return g_eq, g_ek, None, None, None, None


def make_sharded_sir_aggregate(sfg: ShardedFastGraph, activation: Callable,
                               device, group=None,
                               edge_dtype: Optional[torch.dtype] = None):
    """``f(eq_l, ek_l) -> out_l`` over this rank's rows ([n_local, H] each)
    of the all-gather aggregate, with its scatter-free backward. Every
    rank of ``group`` calls it (the collectives pair up). A registry sigma
    that is elementwise runs the kernels (#2 and #4, #1 without a
    gradient); any other the pure route. ``edge_dtype`` carries the
    gathered table (bf16 halves the bytes; sums stay f32); the pure route
    stays f32, as JAX's."""
    loc = take_shard(sfg, rank_of(group), device)
    act = resolve_activation(activation, torch.device(device))

    def f(eq, ek):
        if act is not None and act.elementwise:
            grad = torch.is_grad_enabled() and (eq.requires_grad
                                                or ek.requires_grad)
            if grad:
                return _ShardedAggregate.apply(eq, ek, loc, act, edge_dtype,
                                               group)
            ek_full = all_gather_rows(_cast(ek, edge_dtype), group)
            return sharded_local_forward(loc, eq, ek_full, act, False)
        ek_full = gather_rows(ek, group)
        dplan = loc.dst_plan
        z = StageInputs.apply(eq, ek_full, None, dplan, loc.slot_srcnode,
                              loc.src_plan, loc.src_from_dst_slot, None,
                              None)
        return _SlotSum.apply(activation(z) * loc.slot_scale[:, None], dplan)

    return f
