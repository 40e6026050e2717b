"""Degree-bucketed ELL fast path for SIR message passing (PyTorch port of
``sir_gcn_tpu/ops/ell.py``).

The host planner lays each key's (dst's, or src's) incoming edges out as a
contiguous run of ``budget`` slots; rows of equal budget form buckets, hub
keys with more than ``max_budget`` edges split into chunk rows that a small
second stage combines. The plans are built with NumPy and are array-equal
to the JAX package's.

On top of the plans, :func:`ell_sir_aggregate` computes

    out[u] = sum_{e in in(u)} scale_e * sigma(eq[u] + ek[src_e] [+ e_e])

with the three CUDA kernels of ``ops/cuda``: ``ell_act_reduce2`` for the
forward when a gradient is taken (it also returns the derivative mass
``sbar``), ``ell_src_bwd`` for the key-side gradient, and
``ell_act_reduce`` for the forward without a gradient; with an edge table
``e`` their edge-term forms ``ell_act_reduce2_edge``, ``ell_src_bwd_edge``
(which also gives the per-edge cotangent) and ``ell_act_reduce_edge``.
:func:`ell_sir_aggregate_fused_edge` computes the same with e = e_basis @
w_e formed inside the kernels ``ell_edge_act_reduce2`` and
``ell_edge_src_bwd`` from the narrow edge basis, SIREConv's fused route.
:func:`ell_sir_aggregate_max` computes the max aggregation

    out[u] = max_{e in in(u)} sigma(eq[u] + ek[src_e]) @ W_R + b

(0 for a node with no incoming edge) with four more: ``ell_max_fwd``,
then in the backward ``ell_max_wincount``, ``ell_max_bwd`` and
``ell_scaled_reduce``. Each kernel walks all buckets of a plan in one
launch through the plan's per-row slot pointer ``row_ptr``. sigma must be
in the activation registry below, whose entries carry a written
derivative.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..graph import GraphBatch
from .cuda import (
    ell_act_reduce,
    ell_act_reduce2,
    ell_act_reduce2_edge,
    ell_act_reduce_edge,
    ell_edge_act_reduce2,
    ell_edge_src_bwd,
    ell_max_bwd,
    ell_max_fwd,
    ell_max_wincount,
    ell_scaled_reduce,
    ell_src_bwd,
    ell_src_bwd_edge,
)
from .cuda.kernels import NEG
from .cuda.kernels import bucket_offsets as _bucket_offsets

MAX_BUDGET = 256


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ======================================================================
# Reduce plan: bucketed slots + optional hub stage + key lookup
# ======================================================================

def bucket_reduce(values: torch.Tensor, buckets) -> torch.Tensor:
    """[S, H] slot values -> [R, H] row sums, one ``reshape(nr, b, H)
    .sum(1)`` per (budget, num_rows) bucket."""
    outs = [values[so:so + b * nr].reshape(nr, b, -1).sum(1)
            for b, nr, so, _ in _bucket_offsets(buckets)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


@dataclasses.dataclass(frozen=True)
class ReducePlan:
    """Reduce per-edge values by a key (dst or src) without a scatter.

    Slot arrays (length S1, grouped into ``buckets1`` of (budget,
    num_rows) runs): ``slot_edge`` is the sorted-edge id feeding the slot,
    ``slot_valid`` its 0/1 validity, ``slot_key`` its key node.
    ``row_key`` [R1] is each stage-1 row's key (0 for pad rows), and
    ``row_ptr`` [R1 + 1] the first slot of each row, so row r owns slots
    ``row_ptr[r]:row_ptr[r + 1]``. ``s2_*`` combine hub chunk rows.
    ``key2row`` maps every key to its final row; keys with no edges map to
    an appended all-zero row. ``host`` holds NumPy copies of the arrays.
    """

    slot_edge: torch.Tensor
    slot_valid: torch.Tensor
    slot_key: torch.Tensor
    row_key: torch.Tensor
    row_ptr: torch.Tensor
    s2_gather: Optional[torch.Tensor]
    s2_valid: Optional[torch.Tensor]
    key2row: torch.Tensor
    buckets1: tuple
    buckets2: Optional[tuple]
    num_keys: int
    host: dict = dataclasses.field(repr=False, compare=False)

    def finalize_rows_sum(self, rows1: torch.Tensor) -> torch.Tensor:
        """Stage-1 rows [R1, H] -> [num_keys, H]: the hub second stage,
        then the key lookup with the zero row for empty keys."""
        if self.s2_gather is not None:
            vals = (rows1.index_select(0, self.s2_gather)
                    * self.s2_valid[:, None])
            rows = bucket_reduce(vals, self.buckets2)
        else:
            rows = rows1
        rows = torch.cat([rows, rows.new_zeros((1, rows.shape[-1]))])
        return rows.index_select(0, self.key2row)

    def finalize_rows_max(self, rows1: torch.Tensor) -> torch.Tensor:
        """Stage-1 row maxes [R1, O] f32 -> [num_keys, O]: the hub second
        stage takes the max over a key's chunk rows (invalid stage-2
        entries read the f32 min), and empty keys read an appended row of
        the f32 min (``ReducePlan._finalize(rows, "max", NEG)``)."""
        neg = torch.finfo(rows1.dtype).min
        if self.s2_gather is not None:
            vals = torch.where(self.s2_valid[:, None] > 0,
                               rows1.index_select(0, self.s2_gather),
                               torch.full_like(rows1[:1], neg))
            outs = [vals[so:so + b * nr].reshape(nr, b, -1).amax(1)
                    for b, nr, so, _ in _bucket_offsets(self.buckets2)]
            rows = outs[0] if len(outs) == 1 else torch.cat(outs)
        else:
            rows = rows1
        rows = torch.cat([rows, torch.full_like(rows[:1], neg)])
        return rows.index_select(0, self.key2row)

    def spread(self, node_values: torch.Tensor) -> torch.Tensor:
        """[num_keys, H] -> [S1, H]: each slot gets its key's value."""
        return node_values.index_select(0, self.slot_key)

    def gather_edges(self, edge_values: torch.Tensor) -> torch.Tensor:
        """[E_pad, ...] sorted-edge-order values -> [S1, ...] slot order."""
        return edge_values.index_select(0, self.slot_edge)

    @property
    def num_slots(self) -> int:
        return self.slot_edge.shape[0]

    @property
    def num_rows(self) -> int:
        return self.row_key.shape[0]


def _chunk_budgets(chunk_cnt: np.ndarray) -> np.ndarray:
    """Budget per chunk: power of two up to 8, multiples of 2 to 16,
    multiples of 4 to 32, then multiples of 8."""
    c = np.maximum(chunk_cnt, 1)
    pow2 = 2 ** np.ceil(np.log2(c)).astype(np.int64)
    return np.where(
        c <= 8, pow2,
        np.where(c <= 16, ((c + 1) // 2) * 2,
                 np.where(c <= 32, ((c + 3) // 4) * 4,
                          ((c + 7) // 8) * 8))).astype(np.int64)


def _bucketize(item_keys: np.ndarray, item_ids: np.ndarray, num_keys: int,
               max_budget: int):
    """Group items by key, chunk runs at ``max_budget``, pad chunks to
    bucketed budgets (see :func:`_chunk_budgets`).

    Returns (slot_item [S], slot_valid [S], slot_key [S], buckets,
    row_keys [R]). A vectorised form of the JAX package's
    ``_bucketize_numpy``, with the same output: chunks in key order, then
    grouped by ascending budget, stable within a budget."""
    del num_keys  # kept for the JAX signature
    order = np.argsort(item_keys, kind="stable")
    gkeys = np.asarray(item_keys, np.int64)[order]
    gids = np.asarray(item_ids, np.int64)[order]
    uniq, starts, counts = np.unique(gkeys, return_index=True,
                                     return_counts=True)

    def run_offsets(lengths):
        # position of each element inside its run, for runs of `lengths`
        total = int(lengths.sum())
        firsts = np.repeat(np.cumsum(lengths) - lengths, lengths)
        return np.arange(total, dtype=np.int64) - firsts

    n_chunks = -(-counts // max_budget)
    chunk_off = run_offsets(n_chunks) * max_budget
    chunk_key = np.repeat(uniq, n_chunks)
    chunk_start = np.repeat(starts, n_chunks) + chunk_off
    chunk_cnt = np.minimum(np.repeat(counts, n_chunks) - chunk_off,
                           max_budget)
    budgets = _chunk_budgets(chunk_cnt)

    corder = np.argsort(budgets, kind="stable")
    sorted_b = budgets[corder]
    cnt = chunk_cnt[corder]
    slot_base = np.cumsum(sorted_b) - sorted_b
    total = int(sorted_b.sum())

    slot_item = np.zeros(total, np.int64)
    slot_valid = np.zeros(total, np.float32)
    slot_key = np.repeat(chunk_key[corder], sorted_b)
    within = run_offsets(cnt)
    pos = np.repeat(slot_base, cnt) + within
    slot_item[pos] = gids[np.repeat(chunk_start[corder], cnt) + within]
    slot_valid[pos] = 1.0

    uniq_b, counts_b = np.unique(sorted_b, return_counts=True)
    buckets = [(int(b), int(c)) for b, c in zip(uniq_b, counts_b)]
    return slot_item, slot_valid, slot_key, buckets, chunk_key[corder]


def _row_ptr(buckets) -> np.ndarray:
    """[R + 1] first slot of each row for a (budget, num_rows) list."""
    budgets = np.repeat([b for b, _ in buckets], [nr for _, nr in buckets])
    return np.concatenate([[0], np.cumsum(budgets, dtype=np.int64)])


def build_reduce_plan(keys: np.ndarray, valid: np.ndarray, num_keys: int,
                      max_budget: int = MAX_BUDGET,
                      device: torch.device | str = "cpu") -> ReducePlan:
    """Host-side construction of a :class:`ReducePlan` over the graph's
    sorted-edge arrays, with its tensors placed on ``device``. The hub
    second stage is built when some key has more than one chunk row."""
    keys = np.asarray(keys, np.int64)
    valid = np.asarray(valid, bool)
    eids = np.nonzero(valid)[0]

    slot_edge, slot_valid, slot_key, buckets1, row_keys = _bucketize(
        keys[eids], eids, num_keys, max_budget)

    # pad slots to a multiple of 8 with an extra budget-1 bucket; the
    # bucket list may then repeat budget 1
    s_pad = max(_round_up(len(slot_edge), 8), 8)
    extra = s_pad - len(slot_edge)
    if extra:
        slot_edge = np.concatenate([slot_edge, np.zeros(extra, np.int64)])
        slot_valid = np.concatenate([slot_valid,
                                     np.zeros(extra, np.float32)])
        slot_key = np.concatenate([slot_key, np.zeros(extra, np.int64)])
        buckets1 = buckets1 + [(1, extra)]
        row_keys = np.concatenate(
            [row_keys, np.full(extra, num_keys, np.int64)])
    # pad rows read key 0; zero slot_valid masks them and key2row never
    # selects them
    row_key = np.where(row_keys < num_keys, row_keys, 0)

    n_rows1 = len(row_keys)
    real = row_keys < num_keys
    multi = (np.bincount(row_keys[real], minlength=num_keys).max(initial=0)
             > 1)

    s2_gather = s2_valid = buckets2 = None
    final_keys, n_final = row_keys, n_rows1
    if multi:
        rids = np.nonzero(real)[0]
        # stage 2 is small (<= E / max_budget rows), so no chunk cap:
        # every key collapses to exactly one row
        s2_gather, s2_valid, _, buckets2, row_keys2 = _bucketize(
            row_keys[rids], rids, num_keys, max_budget=1 << 30)
        final_keys, n_final = row_keys2, len(row_keys2)
        buckets2 = tuple(buckets2)

    key2row = np.full(num_keys, n_final, np.int64)
    realf = final_keys < num_keys
    key2row[final_keys[realf]] = np.nonzero(realf)[0]
    if len(slot_edge) >= 2**31:
        raise ValueError(f"{len(slot_edge)} slots overflow the int32 row_ptr")

    host = dict(slot_edge=slot_edge.astype(np.int32),
                slot_valid=slot_valid,
                slot_key=slot_key.astype(np.int32),
                row_key=row_key.astype(np.int32),
                row_ptr=_row_ptr(buckets1).astype(np.int32),
                key2row=key2row.astype(np.int32))
    if s2_gather is not None:
        host.update(s2_gather=s2_gather.astype(np.int32), s2_valid=s2_valid)
    dev = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    return ReducePlan(
        s2_gather=dev.pop("s2_gather", None),
        s2_valid=dev.pop("s2_valid", None), buckets1=tuple(buckets1),
        buckets2=buckets2, num_keys=num_keys, host=host, **dev)


# ======================================================================
# FastGraph: GraphBatch + forward/backward plans
# ======================================================================

@dataclasses.dataclass(frozen=True)
class FastGraph:
    """A :class:`GraphBatch` with ELL plans for the fast path.

    ``dst_plan`` reduces messages to dst nodes (forward), ``src_plan``
    reduces cotangents to src nodes (backward of the ek gather).
    ``dst_slot_srcnode`` [S_dst] is the src node of each dst slot and
    ``src_slot_dstnode`` [S_src] the dst node of each src slot;
    ``src_slot_from_dst_slot`` [S_src] is the dst slot holding each src
    slot's edge (0 on padding slots); ``edge2dst_slot`` and
    ``edge2src_slot`` [E_pad] are each sorted edge's dst and src slot (0 for
    padding edges), which recover per-edge values. The static
    per-slot scales (agg_type "sum"/"mean"/"sym" -> [S] f32, slot validity
    folded in) are precomputed on the host."""

    graph: GraphBatch
    dst_plan: ReducePlan
    src_plan: ReducePlan
    dst_slot_srcnode: torch.Tensor
    src_slot_dstnode: torch.Tensor
    src_slot_from_dst_slot: torch.Tensor
    edge2dst_slot: torch.Tensor
    edge2src_slot: torch.Tensor
    dst_slot_scales: dict
    src_slot_scales: dict

    @property
    def n_pad(self):
        return self.graph.n_pad

    @property
    def e_pad(self):
        return self.graph.e_pad

    @property
    def node_mask(self):
        return self.graph.node_mask

    @property
    def edge_mask(self):
        return self.graph.edge_mask

    @property
    def edge_perm(self):
        return self.graph.edge_perm


def static_edge_scale(agg: str, src, dst, valid, in_deg, out_deg
                      ) -> np.ndarray:
    """Host-side per-edge scale for one aggregation type, in f64:
    sum -> edge validity; mean -> validity / clamp(in_deg[dst], 1);
    sym -> validity * clamp(out_deg[src], 1)^-1/2
    * clamp(in_deg[dst], 1)^-1/2."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    vf = np.asarray(valid, np.float64)
    in_deg = np.asarray(in_deg, np.float64)
    out_deg = np.asarray(out_deg, np.float64)
    if agg == "sum":
        return vf
    if agg == "mean":
        return vf / np.maximum(in_deg, 1.0)[dst]
    if agg == "sym":
        return vf * (np.maximum(out_deg, 1.0) ** -0.5)[src] * (
            np.maximum(in_deg, 1.0) ** -0.5)[dst]
    raise ValueError(f"unknown static scale agg {agg}")


def build_fast_graph(graph: GraphBatch,
                     max_budget: int = MAX_BUDGET) -> FastGraph:
    """Host-side: attach ELL plans and the static sum/mean/sym scales to a
    GraphBatch, on the graph's device."""
    h = graph.host
    src = np.asarray(h["src"], np.int64)
    dst = np.asarray(h["dst"], np.int64)
    valid = np.asarray(h["edge_mask"], bool)
    n = graph.n_pad
    device = graph.device

    dst_plan = build_reduce_plan(dst, valid, n, max_budget, device=device)
    src_plan = build_reduce_plan(src, valid, n, max_budget, device=device)

    dst_slot_edge = dst_plan.host["slot_edge"]
    src_slot_edge = src_plan.host["slot_edge"]
    dvalid = dst_plan.host["slot_valid"] > 0
    svalid = src_plan.host["slot_valid"] > 0
    edge2dst_slot = np.zeros(graph.e_pad, np.int64)
    edge2dst_slot[dst_slot_edge[dvalid]] = np.nonzero(dvalid)[0]
    edge2src_slot = np.zeros(graph.e_pad, np.int64)
    edge2src_slot[src_slot_edge[svalid]] = np.nonzero(svalid)[0]
    host = dict(dst_slot_srcnode=src[dst_slot_edge],
                src_slot_dstnode=dst[src_slot_edge],
                src_slot_from_dst_slot=edge2dst_slot[src_slot_edge],
                edge2dst_slot=edge2dst_slot, edge2src_slot=edge2src_slot)

    dst_scales, src_scales = {}, {}
    for agg in ("sum", "mean", "sym"):
        base = static_edge_scale(agg, src, dst, valid, h["in_deg"],
                                 h["out_deg"])
        dst_scales[agg] = torch.from_numpy(
            (base[dst_slot_edge] * dvalid).astype(np.float32)).to(device)
        src_scales[agg] = torch.from_numpy(
            (base[src_slot_edge] * svalid).astype(np.float32)).to(device)

    return FastGraph(
        graph=graph, dst_plan=dst_plan, src_plan=src_plan,
        dst_slot_scales=dst_scales, src_slot_scales=src_scales,
        **{k: torch.from_numpy(v.astype(np.int32)).to(device)
           for k, v in host.items()})


# ======================================================================
# Activation registry: sigma with a written derivative and a kernel id
# ======================================================================

@dataclasses.dataclass(frozen=True)
class _ActivationKind:
    kernel_id: int    # the ACT_* constant of csrc/ell_kernels.cu
    fn: Callable[[torch.Tensor, float], torch.Tensor]
    grad: Callable[[torch.Tensor, float], torch.Tensor]


def _leaky_relu_grad(z, slope):
    # sigma'(0) = 1, as jax.nn.leaky_relu is where(x >= 0, x, slope * x)
    return torch.where(z >= 0, torch.ones_like(z), torch.full_like(z, slope))


def _tanh_grad(z, _):
    t = torch.tanh(z)
    return (1.0 + t) * (1.0 - t)


_ACTIVATIONS = {
    "leaky_relu": _ActivationKind(0, lambda z, s: F.leaky_relu(z, s),
                                  _leaky_relu_grad),
    "tanh": _ActivationKind(1, lambda z, _: torch.tanh(z), _tanh_grad),
}


@dataclasses.dataclass(frozen=True)
class Activation:
    """An elementwise sigma from the registry, with its parameter (the
    negative slope of leaky_relu). Callable on tensors."""

    name: str
    param: float = 0.0

    def __post_init__(self):
        if self.name not in _ACTIVATIONS:
            raise NotImplementedError(
                f"activation {self.name!r} is not in the kernel registry")

    @property
    def kernel_id(self) -> int:
        return _ACTIVATIONS[self.name].kernel_id

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        return _ACTIVATIONS[self.name].fn(z, self.param)

    def grad(self, z: torch.Tensor) -> torch.Tensor:
        """sigma'(z), elementwise."""
        return _ACTIVATIONS[self.name].grad(z, self.param)


def leaky_relu(slope: float) -> Activation:
    return Activation("leaky_relu", float(slope))


tanh = Activation("tanh")


def resolve_activation(act) -> Activation:
    """The registry entry for ``act``; any other sigma raises (the pure
    ELL route that would take it is not yet ported)."""
    if isinstance(act, Activation):
        return act
    name = getattr(act, "__name__", None) or repr(act)
    raise NotImplementedError(
        f"sigma {name} is not in the activation registry; the pure ELL "
        f"route for other sigma is not yet ported")


# ======================================================================
# The SIR aggregation on the kernels, with a scatter-free backward
# ======================================================================

def _cast(x: torch.Tensor, edge_dtype) -> torch.Tensor:
    return (x if edge_dtype is None else x.to(edge_dtype)).contiguous()


def edge_cotangent(g_z: torch.Tensor, edge2slot: torch.Tensor,
                   edge_mask: torch.Tensor) -> torch.Tensor:
    """[E_pad, H] f32 per-edge cotangent in sorted-edge order from a
    per-slot table g_z [S, H]: ``g_z[edge2slot] * edge_mask`` (the JAX
    route's ``_edge_cotangent``). It is the contract of the g_e output of
    ``ell_src_bwd_edge``, and that output's plain version."""
    return (g_z.index_select(0, edge2slot).float()
            * edge_mask.to(torch.float32)[:, None])


class _EllSirAggregate(torch.autograd.Function):
    """Forward with ``ell_act_reduce2`` (row sums and derivative mass
    ``sbar``); backward ``g_eq = g * sbar`` and ``g_ek`` from the
    src-major ``ell_src_bwd``. With an edge table ``e`` [E_pad, H] (sorted
    edge order) the edge-term forms run instead, and the backward's
    ``ell_src_bwd_edge`` also gives g_e [E_pad, H] f32. Only node-sized
    tensors and e in the edge dtype are saved."""

    @staticmethod
    def forward(ctx, eq, ek, e, fg: FastGraph, act: Activation,
                agg_type: str, edge_dtype):
        plan = fg.dst_plan
        args = (eq.contiguous(), _cast(ek, edge_dtype), fg.dst_slot_srcnode,
                fg.dst_slot_scales[agg_type], plan.row_key, plan.row_ptr, act)
        if e is None:
            rows, srows = ell_act_reduce2(*args)
        else:
            e = _cast(e, edge_dtype)
            rows, srows = ell_act_reduce2_edge(*args, e, plan.slot_edge)
        sbar = plan.finalize_rows_sum(srows)
        ctx.save_for_backward(eq, ek, e, sbar)
        ctx.fg, ctx.act, ctx.agg_type, ctx.edge_dtype = (
            fg, act, agg_type, edge_dtype)
        return plan.finalize_rows_sum(rows)

    @staticmethod
    def backward(ctx, g):
        eq, ek, e, sbar = ctx.saved_tensors
        fg = ctx.fg
        g_eq = g * sbar if ctx.needs_input_grad[0] else None
        g_ek = g_e = None
        if any(ctx.needs_input_grad[1:3]):
            splan = fg.src_plan
            args = (_cast(eq, ctx.edge_dtype), _cast(g, ctx.edge_dtype),
                    ek.contiguous(), fg.src_slot_dstnode,
                    fg.src_slot_scales[ctx.agg_type], splan.row_key,
                    splan.row_ptr, ctx.act)
            if e is None:
                rows = ell_src_bwd(*args)
            else:
                rows, g_e = ell_src_bwd_edge(*args, e, splan.slot_edge,
                                             fg.edge2src_slot, fg.edge_mask)
            if ctx.needs_input_grad[1]:
                g_ek = splan.finalize_rows_sum(rows)
        if not ctx.needs_input_grad[2]:
            g_e = None
        return g_eq, g_ek, g_e, None, None, None, None


def ell_sir_aggregate(fg: FastGraph, eq: torch.Tensor, ek: torch.Tensor,
                      activation, agg_type: str, *,
                      e: Optional[torch.Tensor] = None,
                      edge_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """out[u] = sum_e scale_e * sigma(eq[u] + ek[src_e] [+ e_e]) over u's
    incoming edges, with the FastGraph's static per-slot scales for
    ``agg_type``. ``e`` [E_pad, H] f32 is an optional edge term in sorted
    edge order (the JAX route's ``with_edge``), and gets a gradient.

    ``edge_dtype`` (None or torch.bfloat16) is the type the gathered
    operands are carried in; the edge term is added to a gathered row in
    f32 and rounded to it; all sums are f32. Without a gradient
    (``torch.is_grad_enabled()`` False, or no input needs one) the forward
    runs ``ell_act_reduce`` (``ell_act_reduce_edge``) alone."""
    if agg_type not in fg.dst_slot_scales:
        raise ValueError(f"agg_type {agg_type!r} is not a linear aggregation")
    act = resolve_activation(activation)
    inputs = (eq, ek) if e is None else (eq, ek, e)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _EllSirAggregate.apply(eq, ek, e, fg, act, agg_type,
                                      edge_dtype)
    plan = fg.dst_plan
    args = (eq.contiguous(), _cast(ek, edge_dtype), fg.dst_slot_srcnode,
            fg.dst_slot_scales[agg_type], plan.row_key, plan.row_ptr, act)
    if e is None:
        rows = ell_act_reduce(*args)
    else:
        rows = ell_act_reduce_edge(*args, _cast(e, edge_dtype),
                                   plan.slot_edge)
    return plan.finalize_rows_sum(rows)


# ======================================================================
# The fused-edge route: SIREConv's W_E inside the kernels
# ======================================================================

class _EllSirAggregateFusedEdge(torch.autograd.Function):
    """Forward: ``ell_edge_act_reduce2`` gives the row sums and ``sbar``
    (also without a gradient: the JAX route has no single-output form).
    Backward: ``g_eq = g * sbar``; ``ell_edge_src_bwd`` gives the g_ek rows
    and g_WE. e_basis gets no gradient. Only ek and, in the backward, eq
    and g are carried in the edge dtype; e_basis, w_e and the projection
    stay f32. Only node-sized tensors, e_basis and w_e are saved."""

    @staticmethod
    def forward(ctx, eq, ek, e_basis, w_e, fg: FastGraph, act: Activation,
                agg_type: str, edge_dtype):
        plan = fg.dst_plan
        rows, srows = ell_edge_act_reduce2(
            eq.contiguous(), _cast(ek, edge_dtype), e_basis.contiguous(),
            w_e.contiguous(), fg.dst_slot_srcnode, plan.slot_edge,
            fg.dst_slot_scales[agg_type], plan.row_key, plan.row_ptr, act)
        sbar = plan.finalize_rows_sum(srows)
        ctx.save_for_backward(eq, ek, e_basis, w_e, sbar)
        ctx.fg, ctx.act, ctx.agg_type, ctx.edge_dtype = (
            fg, act, agg_type, edge_dtype)
        return plan.finalize_rows_sum(rows)

    @staticmethod
    def backward(ctx, g):
        eq, ek, e_basis, w_e, sbar = ctx.saved_tensors
        fg = ctx.fg
        g_eq = g * sbar if ctx.needs_input_grad[0] else None
        g_ek = g_we = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[3]:
            splan = fg.src_plan
            rows, g_we = ell_edge_src_bwd(
                _cast(eq, ctx.edge_dtype), _cast(g, ctx.edge_dtype),
                ek.contiguous(), e_basis.contiguous(), w_e.contiguous(),
                fg.src_slot_dstnode, splan.slot_edge,
                fg.src_slot_scales[ctx.agg_type], splan.row_key,
                splan.row_ptr, ctx.act)
            if ctx.needs_input_grad[1]:
                g_ek = splan.finalize_rows_sum(rows)
        if not ctx.needs_input_grad[3]:
            g_we = None
        return g_eq, g_ek, None, g_we, None, None, None, None


def ell_sir_aggregate_fused_edge(fg: FastGraph, eq: torch.Tensor,
                                 ek: torch.Tensor, e_basis: torch.Tensor,
                                 w_e: torch.Tensor, activation,
                                 agg_type: str, *,
                                 edge_dtype: Optional[torch.dtype] = None
                                 ) -> torch.Tensor:
    """out[u] = sum_e scale_e * sigma(eq[u] + ek[src_e] + e_basis_e @ w_e)
    with the FastGraph's static per-slot scales for ``agg_type``: the
    ``ell_sir_aggregate`` of ``e = e_basis @ w_e``, with the projection
    formed inside the kernels, so no [E_pad, H] edge table or cotangent
    exists. e_basis [E_pad, De] f32 in sorted edge order (no gradient),
    w_e [De, H] f32 in the JAX layout. The port of
    ``make_ell_sir_aggregate_pallas_fused_edge`` with static scales,
    without its TPU padding (``pad_basis``, the 128-lane wrapper)."""
    if agg_type not in fg.dst_slot_scales:
        raise ValueError(f"agg_type {agg_type!r} is not a linear aggregation")
    act = resolve_activation(activation)
    return _EllSirAggregateFusedEdge.apply(eq, ek, e_basis, w_e, fg, act,
                                           agg_type, edge_dtype)


# ======================================================================
# The max aggregation: W_R per slot inside the kernels, ties split
# ======================================================================

class _EllSirAggregateMax(torch.autograd.Function):
    """Forward: ``ell_max_fwd`` and the max finalize give the key-level max
    ``out1`` (the f32 min for a node with no valid slot); ``out =
    where(out1 > NEG/2, out1 + b, 0)``. Backward: ``ell_max_wincount``
    counts tied winners, ``ell_max_bwd`` routes ``gsc = g / count`` to them
    (g_eq, per-slot g_z, g_W), ``ell_scaled_reduce`` sums g_z in src order
    for g_ek. Only node-sized tensors and W are saved."""

    @staticmethod
    def forward(ctx, eq, ek, w, b, fg: FastGraph, act: Activation,
                edge_dtype):
        out1 = _max_rows(fg, eq, ek, w, act, edge_dtype)
        ctx.save_for_backward(eq, ek, w, out1)
        ctx.fg, ctx.act, ctx.edge_dtype = fg, act, edge_dtype
        return torch.where(out1 > NEG / 2, out1 + b, 0.0)

    @staticmethod
    def backward(ctx, g):
        eq, ek, w, out1 = ctx.saved_tensors
        fg, act = ctx.fg, ctx.act
        plan, splan = fg.dst_plan, fg.src_plan
        args = (eq.contiguous(), _cast(ek, ctx.edge_dtype),
                fg.dst_slot_srcnode, fg.dst_slot_scales["sum"], plan.row_key,
                plan.row_ptr, w.contiguous())
        counts = plan.finalize_rows_sum(ell_max_wincount(*args, out1, act))
        g_act = torch.where(out1 > NEG / 2, g, 0.0)
        gsc = (g_act / counts.clamp_min(1.0)).contiguous()
        geq_rows, g_z, g_w = ell_max_bwd(*args, out1, gsc, act)
        g_eq = plan.finalize_rows_sum(geq_rows)
        g_ek = splan.finalize_rows_sum(ell_scaled_reduce(
            g_z, fg.src_slot_from_dst_slot, splan.slot_valid, splan.row_ptr))
        return g_eq, g_ek, g_w, g_act.sum(0), None, None, None


def _max_rows(fg: FastGraph, eq, ek, w, act, edge_dtype) -> torch.Tensor:
    """[N, O] key-level max before the bias (the f32 min for empty keys)."""
    plan = fg.dst_plan
    rows = ell_max_fwd(eq.contiguous(), _cast(ek, edge_dtype),
                       fg.dst_slot_srcnode, fg.dst_slot_scales["sum"],
                       plan.row_key, plan.row_ptr, w.contiguous(), act)
    return plan.finalize_rows_max(rows)


def ell_sir_aggregate_max(fg: FastGraph, eq: torch.Tensor, ek: torch.Tensor,
                          w: torch.Tensor, b: Optional[torch.Tensor],
                          activation, *,
                          edge_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """out[u] = max_e sigma(eq[u] + ek[src_e]) @ w + b over u's valid
    incoming edges, and 0 for a node with none (DGL's zero fill). eq, ek
    [N, H] f32, w [H, O] f32 (the JAX layout), b [O] or None; returns
    [N, O] f32. A cotangent is split equally among tied winners.

    ``edge_dtype`` (None or torch.bfloat16) is the type ek is gathered in
    and the per-slot g_z stored in; m, the max and all sums are f32.
    Without a gradient the forward runs ``ell_max_fwd`` alone. The port of
    ``make_ell_sir_aggregate_max_pallas`` without edge features."""
    act = resolve_activation(activation)
    if b is None:
        b = w.new_zeros(w.shape[1])
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (eq, ek, w, b)):
        return _EllSirAggregateMax.apply(eq, ek, w, b, fg, act, edge_dtype)
    out1 = _max_rows(fg, eq, ek, w, act, edge_dtype)
    return torch.where(out1 > NEG / 2, out1 + b, 0.0)
