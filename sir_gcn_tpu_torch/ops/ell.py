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
With ``fuse_bwd_take`` the key-side gradient reads eq and g from one
[N, 2H] table (``ell_src_bwd_fused``). A sigma that is not elementwise
takes the general route: ``ell_act_reduce_rowwise`` forward,
``ell_geq_reduce`` and ``ell_src_bwd_rowwise`` (or ``ell_src_bwd_fused``)
backward; with ``e`` their edge-term forms ``ell_act_reduce_rowwise_edge``,
``ell_geq_reduce_edge`` and ``ell_src_bwd_rowwise_edge``.
:func:`ell_sir_aggregate_fused_edge` computes the same with e = e_basis @
w_e formed inside the kernels ``ell_edge_act_reduce2`` and
``ell_edge_src_bwd`` from the narrow edge basis, SIREConv's fused route.
:func:`ell_sir_aggregate_max` computes the max aggregation

    out[u] = max_{e in in(u)} sigma(eq[u] + ek[src_e] [+ e_e]) @ W_R + b

(0 for a node with no incoming edge) with four more: ``ell_max_fwd``,
then in the backward ``ell_max_wincount``, ``ell_max_bwd`` and
``ell_scaled_reduce``; with ``e`` the edge forms ``ell_max_fwd_edge``,
``ell_max_wincount_edge`` and ``ell_max_bwd_edge``, for any sigma of the
registry, a row-wise one included. Each kernel walks all buckets of a
plan in one launch through the plan's per-row slot pointer ``row_ptr``.
The kernels take a sigma from the activation registry below, whose
entries carry a written derivative and vector-Jacobian product. Each
kernel reads one per-slot scale array: the FastGraph's static scales, or
under a DropEdge ``edge_mask`` those scales of the kept edges
(:func:`slot_scale`).

A sigma outside the registry that holds tensors (an ``nn.Module`` with
parameters, a closure over a tensor) takes the pure ELL route
(:func:`pure_ell_sir_aggregate`, :func:`pure_ell_sir_aggregate_max`): the
JAX package's pure-XLA routes (``make_ell_sir_aggregate``,
``make_ell_sir_aggregate_max``) in plain PyTorch on the same plans, with
their scatter-free backward. JAX sends such a sigma there because a Pallas
kernel cannot hold a captured array; it is a route of its own, not a
kernel's plain version. A parameter-free sigma outside the registry runs
on Pallas kernels in JAX, so on a CUDA tensor it raises until the registry
holds it; on the CPU it takes the pure route too.
"""

from __future__ import annotations

import contextlib
import functools
import dataclasses
import hashlib
import logging
import math
import time
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
    ell_act_reduce_rowwise,
    ell_act_reduce_rowwise_edge,
    ell_edge_act_reduce2,
    ell_edge_src_bwd,
    ell_geq_reduce,
    ell_geq_reduce_edge,
    ell_max_bwd,
    ell_max_bwd_edge,
    ell_max_fwd,
    ell_max_fwd_edge,
    ell_max_wincount,
    ell_max_wincount_edge,
    ell_scaled_reduce,
    ell_src_bwd,
    ell_src_bwd_edge,
    ell_src_bwd_fused,
    ell_src_bwd_rowwise,
    ell_src_bwd_rowwise_edge,
)
from .cuda.kernels import NEG, on_cuda
from .cuda.kernels import bucket_offsets as _bucket_offsets

MAX_BUDGET = 256

# Stage timings (seconds) of the latest top-level plan build, read through
# plan_timings(); build_fast_graph resets them on entry, so a standalone
# build_reduce_plan adds to the last build's.
_PLAN_TIMINGS: dict = {}
_LAST_MEMO_HIT: bool = False


def plan_timings() -> dict:
    """{stage: seconds} of the latest plan build: ``fetch_host``,
    ``memo_hash``, then on a memo miss ``bucketize`` and ``plan_upload``
    (both plans together), ``fetch_plans``, ``fg_host``, ``scales_host``
    and ``fg_upload``."""
    return dict(_PLAN_TIMINGS)


def reset_plan_timings() -> None:
    global _LAST_MEMO_HIT
    _PLAN_TIMINGS.clear()
    _LAST_MEMO_HIT = False


def last_build_memo_hit() -> bool:
    """Whether the latest :func:`build_fast_graph` returned memoised plans
    (then plan_timings() holds only ``fetch_host`` and ``memo_hash``)."""
    return _LAST_MEMO_HIT


@contextlib.contextmanager
def _timed_stage(stage: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _PLAN_TIMINGS[stage] = (_PLAN_TIMINGS.get(stage, 0.0)
                                + time.perf_counter() - t0)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ======================================================================
# Reduce plan: bucketed slots + optional hub stage + key lookup
# ======================================================================

def bucket_reduce(values: torch.Tensor, buckets, op: str = "sum"
                  ) -> torch.Tensor:
    """[S, H] slot values -> [R, H] row sums (``op="max"``: row maxes), one
    ``reshape(nr, b, H).sum(1)`` (``.amax(1)``) per (budget, num_rows)
    bucket."""
    outs = [values[so:so + b * nr].reshape(nr, b, -1)
            for b, nr, so, _ in _bucket_offsets(buckets)]
    outs = [o.sum(1) if op == "sum" else o.amax(1) for o in outs]
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
            rows = bucket_reduce(vals, self.buckets2, "max")
        else:
            rows = rows1
        rows = torch.cat([rows, torch.full_like(rows[:1], neg)])
        return rows.index_select(0, self.key2row)

    def reduce_slots_sum(self, slot_values: torch.Tensor) -> torch.Tensor:
        """[S1, H] slot values (zero on padding slots) -> [num_keys, H]
        sums."""
        return self.finalize_rows_sum(bucket_reduce(slot_values,
                                                    self.buckets1))

    def reduce_slots_max(self, slot_values: torch.Tensor) -> torch.Tensor:
        """[S1, H] slot values (the f32 min on invalid slots) ->
        [num_keys, H] maxes; empty keys read the f32 min, and the caller
        zero-fills them."""
        return self.finalize_rows_max(bucket_reduce(slot_values,
                                                    self.buckets1, "max"))

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

    def to(self, device) -> "ReducePlan":
        """The same plan with its tensors on ``device``."""
        return _plan_from_host(self.host, self.buckets1, self.buckets2,
                               self.num_keys, device)


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
               max_budget: int, native: Optional[bool] = None):
    """Group items by key, chunk runs at ``max_budget``, pad chunks to
    bucketed budgets (see :func:`_chunk_budgets`).

    Returns (slot_item [S], slot_valid [S], slot_key [S], buckets,
    row_keys [R]): chunks in key order, then grouped by ascending budget,
    stable within a budget, as the JAX package's ``_bucketize``. The
    chunking and the slot fill run in the native planner
    (``sir_gcn_tpu_torch/native.py``) where it loads, as in JAX, or with
    ``native=False`` in vectorised NumPy; the two give the same arrays."""
    del num_keys  # kept for the JAX signature
    from .. import native as _native

    if native is None:
        native = _native.available()
    order = np.argsort(item_keys, kind="stable")
    gkeys = np.ascontiguousarray(np.asarray(item_keys, np.int64)[order])
    gids = np.ascontiguousarray(np.asarray(item_ids, np.int64)[order])

    def run_offsets(lengths):
        # position of each element inside its run, for runs of `lengths`
        total = int(lengths.sum())
        firsts = np.repeat(np.cumsum(lengths) - lengths, lengths)
        return np.arange(total, dtype=np.int64) - firsts

    if native:
        chunk_key, chunk_cnt, chunk_start = _native.ell_chunks(gkeys,
                                                               max_budget)
    else:
        uniq, starts, counts = np.unique(gkeys, return_index=True,
                                         return_counts=True)
        n_chunks = -(-counts // max_budget)
        chunk_off = run_offsets(n_chunks) * max_budget
        chunk_key = np.repeat(uniq, n_chunks)
        chunk_start = np.repeat(starts, n_chunks) + chunk_off
        chunk_cnt = np.minimum(np.repeat(counts, n_chunks) - chunk_off,
                               max_budget)
    budgets = _chunk_budgets(chunk_cnt)

    corder = np.argsort(budgets, kind="stable")
    sorted_b = budgets[corder]
    slot_base = np.cumsum(sorted_b) - sorted_b
    total = int(sorted_b.sum())

    if native:
        slot_item, slot_valid, slot_key = _native.ell_fill_slots(
            gids, chunk_key, chunk_cnt, chunk_start, budgets,
            corder.astype(np.int64), slot_base.astype(np.int64), total)
    else:
        slot_item = np.zeros(total, np.int64)
        slot_valid = np.zeros(total, np.float32)
        slot_key = np.repeat(chunk_key[corder], sorted_b)
        cnt = chunk_cnt[corder]
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
                      device: torch.device | str = "cpu",
                      force_stage2: bool = False,
                      native: Optional[bool] = None) -> ReducePlan:
    """Host-side construction of a :class:`ReducePlan` over the graph's
    sorted-edge arrays, with its tensors placed on ``device``. The hub
    second stage is built when some key has more than one chunk row, or
    always with ``force_stage2`` (plans that must share one structure, see
    :func:`harmonize_reduce_plans`). ``native`` picks the planner of
    :func:`_bucketize` (None: the native one where it loads)."""
    keys = np.asarray(keys, np.int64)
    valid = np.asarray(valid, bool)
    eids = np.nonzero(valid)[0]

    with _timed_stage("bucketize"):
        slot_edge, slot_valid, slot_key, buckets1, row_keys = _bucketize(
            keys[eids], eids, num_keys, max_budget, native)

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
    if multi or force_stage2:
        rids = np.nonzero(real)[0]
        if len(rids) == 0:
            # no real row: one all-padding stage-2 row
            s2_gather = np.zeros(1, np.int64)
            s2_valid = np.zeros(1, np.float32)
            buckets2 = [(1, 1)]
            row_keys2 = np.full(1, num_keys, np.int64)
        else:
            # stage 2 is small (<= E / max_budget rows), so no chunk cap:
            # every key collapses to exactly one row
            s2_gather, s2_valid, _, buckets2, row_keys2 = _bucketize(
                row_keys[rids], rids, num_keys, 1 << 30, native)
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
                key2row=key2row.astype(np.int32))
    if s2_gather is not None:
        host.update(s2_gather=s2_gather.astype(np.int32), s2_valid=s2_valid)
    with _timed_stage("plan_upload"):
        return _plan_from_host(host, tuple(buckets1), buckets2, num_keys,
                               device)


def _plan_from_host(host: dict, buckets1: tuple, buckets2, num_keys: int,
                    device) -> ReducePlan:
    """A :class:`ReducePlan` of the NumPy arrays ``host`` (``row_ptr`` is
    derived from ``buckets1``) with their tensors on ``device``."""
    host = dict(host, row_ptr=_row_ptr(buckets1).astype(np.int32))
    dev = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    return ReducePlan(
        s2_gather=dev.pop("s2_gather", None),
        s2_valid=dev.pop("s2_valid", None), buckets1=buckets1,
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

    @property
    def src(self):
        return self.graph.src

    @property
    def dst(self):
        return self.graph.dst

    @property
    def in_deg(self):
        return self.graph.in_deg

    @property
    def out_deg(self):
        return self.graph.out_deg

    @property
    def device(self):
        return self.graph.device

    @property
    def dst_segments(self):
        return self.graph.dst_segments

    @property
    def src_segments(self):
        return self.graph.src_segments


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


# The latest builds' plans, keyed by content: a harness rebuilds the same
# graph once per run. Entries hold device tensors, so keep few.
_FAST_GRAPH_MEMO: dict = {}
_FAST_GRAPH_MEMO_MAX = 2
_STATIC_SCALES = ("sum", "mean", "sym")


def build_fast_graph(graph: GraphBatch,
                     max_budget: int = MAX_BUDGET) -> FastGraph:
    """Host-side: attach ELL plans and the static sum/mean/sym scales to a
    GraphBatch, on the graph's device.

    The plans are memoised by a blake2b hash of src, dst, the edge mask
    and both degree arrays (the scales bake the degrees in), with n_pad,
    e_pad, ``max_budget`` and the device: a hit returns the cached plans
    with ``graph`` attached (:func:`last_build_memo_hit`)."""
    global _LAST_MEMO_HIT
    reset_plan_timings()
    with _timed_stage("fetch_host"):
        h = graph.host
        src32, dst32 = h["src"], h["dst"]
        valid = np.asarray(h["edge_mask"], bool)
        in_deg, out_deg = h["in_deg"], h["out_deg"]
    n = graph.n_pad
    device = graph.device

    with _timed_stage("memo_hash"):
        digest = hashlib.blake2b(digest_size=16)
        for a in (src32, dst32, valid, in_deg, out_deg):
            digest.update(np.ascontiguousarray(a).tobytes())
        key = (digest.hexdigest(), n, graph.e_pad, max_budget,
               _STATIC_SCALES, str(device))
    hit = _FAST_GRAPH_MEMO.get(key)
    if hit is not None:
        _LAST_MEMO_HIT = True
        return dataclasses.replace(hit, graph=graph)

    src = np.asarray(src32, np.int64)
    dst = np.asarray(dst32, np.int64)
    dst_plan = build_reduce_plan(dst, valid, n, max_budget, device=device)
    src_plan = build_reduce_plan(src, valid, n, max_budget, device=device)

    with _timed_stage("fetch_plans"):
        dst_slot_edge = dst_plan.host["slot_edge"]
        src_slot_edge = src_plan.host["slot_edge"]
        dvalid = dst_plan.host["slot_valid"] > 0
        svalid = src_plan.host["slot_valid"] > 0
    with _timed_stage("fg_host"):
        edge2dst_slot = np.zeros(graph.e_pad, np.int64)
        edge2dst_slot[dst_slot_edge[dvalid]] = np.nonzero(dvalid)[0]
        edge2src_slot = np.zeros(graph.e_pad, np.int64)
        edge2src_slot[src_slot_edge[svalid]] = np.nonzero(svalid)[0]
        host = dict(dst_slot_srcnode=src[dst_slot_edge],
                    src_slot_dstnode=dst[src_slot_edge],
                    src_slot_from_dst_slot=edge2dst_slot[src_slot_edge],
                    edge2dst_slot=edge2dst_slot, edge2src_slot=edge2src_slot)
    with _timed_stage("scales_host"):
        dst_scales_np, src_scales_np = {}, {}
        for agg in _STATIC_SCALES:
            base = static_edge_scale(agg, src, dst, valid, in_deg, out_deg)
            dst_scales_np[agg] = (base[dst_slot_edge] * dvalid).astype(
                np.float32)
            src_scales_np[agg] = (base[src_slot_edge] * svalid).astype(
                np.float32)

    with _timed_stage("fg_upload"):
        up = lambda a: torch.from_numpy(a).to(device)
        fg = FastGraph(
            graph=graph, dst_plan=dst_plan, src_plan=src_plan,
            dst_slot_scales={a: up(v) for a, v in dst_scales_np.items()},
            src_slot_scales={a: up(v) for a, v in src_scales_np.items()},
            **{k: up(v.astype(np.int32)) for k, v in host.items()})
    while len(_FAST_GRAPH_MEMO) >= _FAST_GRAPH_MEMO_MAX:
        _FAST_GRAPH_MEMO.pop(next(iter(_FAST_GRAPH_MEMO)))
    _FAST_GRAPH_MEMO[key] = fg
    return fg


# ======================================================================
# Activation registry: sigma with a written derivative and a kernel id
# ======================================================================

@dataclasses.dataclass(frozen=True)
class _ActivationKind:
    """``fn(z, param)`` over the last dim and its vector-Jacobian product
    ``vjp(z, g, param)``; ``grad(z, param)``, sigma' elementwise, only for
    an entry whose Jacobian is diagonal (None for a row-wise one). Every
    entry has kernels: an elementwise one on the elementwise, edge, max
    and general route's kernels, a row-wise one on the general route's and
    the max route's."""

    kernel_id: int    # the ACT_* constant of csrc/ell_*kernels.cu
    fn: Callable[[torch.Tensor, float], torch.Tensor]
    vjp: Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor]
    grad: Optional[Callable[[torch.Tensor, float], torch.Tensor]] = None


def _leaky_relu_grad(z, slope):
    # sigma'(0) = 1, as jax.nn.leaky_relu is where(x >= 0, x, slope * x)
    return torch.where(z >= 0, torch.ones_like(z), torch.full_like(z, slope))


def _tanh_grad(z, _):
    t = torch.tanh(z)
    return (1.0 + t) * (1.0 - t)


_SQRT_HALF = math.sqrt(0.5)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _gelu(z, _):
    # as jax.nn.gelu(approximate=False): 0.5 * z * erfc(-z / sqrt(2))
    return 0.5 * z * torch.erfc(-z * _SQRT_HALF)


def _gelu_grad(z, _):
    # Phi(z) + z * phi(z), the derivative jax.grad takes of the form above
    return (0.5 * torch.erfc(-z * _SQRT_HALF)
            + z * (torch.exp(-0.5 * z * z) * _INV_SQRT_2PI))


def _elementwise(kernel_id, fn, grad) -> _ActivationKind:
    return _ActivationKind(kernel_id, fn, lambda z, g, p: grad(z, p) * g,
                           grad)


def _centered_shift(z, alpha):
    # alpha * mean_H(z), the mean as sum / H (jnp.mean's division)
    return alpha * (z.sum(-1, keepdim=True) / z.shape[-1])


def _centered_relu(z, alpha):
    return F.relu(z - _centered_shift(z, alpha))


def _centered_relu_vjp(z, g, alpha):
    # relu'(0) = 0, as jax.nn.relu; the mean spreads -alpha * sum(d) / H
    d = torch.where(z - _centered_shift(z, alpha) > 0, g, 0.0)
    return d - _centered_shift(d, alpha)


def _softmax(z, _):
    e = torch.exp(z - z.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _softmax_vjp(z, g, _):
    y = _softmax(z, None)
    return y * (g - (g * y).sum(-1, keepdim=True))


_ACTIVATIONS = {
    "leaky_relu": _elementwise(0, lambda z, s: F.leaky_relu(z, s),
                               _leaky_relu_grad),
    "tanh": _elementwise(1, lambda z, _: torch.tanh(z), _tanh_grad),
    # row-wise: sigma couples the H features of a row
    "centered_relu": _ActivationKind(2, _centered_relu, _centered_relu_vjp),
    "softmax": _ActivationKind(3, _softmax, _softmax_vjp),
    "gelu": _elementwise(4, _gelu, _gelu_grad),
}


@dataclasses.dataclass(frozen=True)
class Activation:
    """A sigma from the registry, with its parameter (the negative slope of
    leaky_relu, the alpha of centered_relu). Callable on tensors, over the
    last dim.

    ``sir_elementwise=False`` sends an elementwise entry down the general
    route of a linear aggregation, as the attribute of that name does for a
    sigma in the JAX package (``sir_gcn_tpu/ops/ell.py``
    ``_activation_info``); max takes the max kernels' form of the entry's
    id either way, as JAX's max route does. A row-wise entry cannot be
    declared elementwise."""

    name: str
    param: float = 0.0
    sir_elementwise: Optional[bool] = None

    def __post_init__(self):
        if self.name not in _ACTIVATIONS:
            raise NotImplementedError(
                f"activation {self.name!r} is not in the kernel registry")
        if self.sir_elementwise and not self.diagonal:
            raise ValueError(f"{self.name} couples a row's features; it "
                             f"cannot be declared elementwise")

    @property
    def kernel_id(self) -> int:
        return _ACTIVATIONS[self.name].kernel_id

    @property
    def diagonal(self) -> bool:
        """Whether the entry's Jacobian is diagonal (sigma elementwise)."""
        return _ACTIVATIONS[self.name].grad is not None

    @property
    def elementwise(self) -> bool:
        """Whether the elementwise route (the derivative mass of #2) takes
        this sigma; otherwise the general route does."""
        return self.diagonal and self.sir_elementwise is not False

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        return _ACTIVATIONS[self.name].fn(z, self.param)

    def grad(self, z: torch.Tensor) -> torch.Tensor:
        """sigma'(z), elementwise; raises for a row-wise sigma."""
        grad = _ACTIVATIONS[self.name].grad
        if grad is None:
            raise ValueError(f"{self.name} couples a row's features: it has "
                             f"no elementwise derivative")
        return grad(z, self.param)

    def vjp(self, z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """The vector-Jacobian product of sigma at z with g, row by row over
        the last dim (for an elementwise sigma, sigma'(z) * g)."""
        return _ACTIVATIONS[self.name].vjp(z, g, self.param)


def leaky_relu(slope: float) -> Activation:
    return Activation("leaky_relu", float(slope))


def gelu() -> Activation:
    """erf-GELU, ``jax.nn.gelu(approximate=False)``: z * Phi(z)."""
    return Activation("gelu")


def centered_relu(alpha: float) -> Activation:
    """relu(z - alpha * mean_H(z)), row-wise."""
    return Activation("centered_relu", float(alpha))


tanh = Activation("tanh")
softmax = Activation("softmax")  # over H, row-wise


_routing_logger = logging.getLogger("sir_gcn_tpu_torch.routing")
_LOGGED: set = set()  # names of the sigma whose pure route was logged


def _holds_tensors(act, depth: int = 3) -> bool:
    """Whether sigma holds tensors: an ``nn.Module`` with parameters or
    buffers, or a callable that closes over (or names as a global) a tensor
    or such a module, through partials and bound methods, ``depth`` levels
    deep. The port of the JAX package's test ``make_jaxpr(act).consts``,
    which sends such a sigma to its XLA route."""
    if isinstance(act, torch.Tensor):
        return True
    if isinstance(act, torch.nn.Module):
        return any(True for _ in act.parameters()) or any(
            True for _ in act.buffers())
    if depth == 0:
        return False
    if isinstance(act, functools.partial):
        inner = (act.func, *act.args, *act.keywords.values())
    elif hasattr(act, "__self__") and hasattr(act, "__func__"):
        inner = (act.__self__, act.__func__)
    else:
        code = getattr(act, "__code__", None)
        names = code.co_names if code is not None else ()
        scope = getattr(act, "__globals__", {})
        inner = [scope[k] for k in names if k in scope]
        for cell in getattr(act, "__closure__", None) or ():
            with contextlib.suppress(ValueError):  # an empty cell
                inner.append(cell.cell_contents)
    return any(_holds_tensors(x, depth - 1) for x in inner
               if isinstance(x, torch.Tensor) or (callable(x) and x is not act))


def resolve_activation(act, device: torch.device) -> Optional[Activation]:
    """The registry entry for ``act``, or None for a sigma outside the
    registry, which takes the pure ELL route (:func:`pure_ell_sir_aggregate`,
    :func:`pure_ell_sir_aggregate_max`), logged once per sigma name at INFO
    on the ``sir_gcn_tpu_torch.routing`` logger, as the JAX package's
    ``_activation_info`` logs its routes. On a CUDA ``device`` only a
    sigma that holds tensors takes it (JAX's XLA route); a parameter-free
    one raises: JAX runs it on its Pallas kernels, and the port's kernels
    take only the registry's sigma."""
    if isinstance(act, Activation):
        return act
    name = getattr(act, "__name__", None) or type(act).__name__
    if on_cuda(device) and not _holds_tensors(act):
        raise NotImplementedError(
            f"sigma {name} is outside the activation registry and holds no "
            f"tensor: the JAX package runs it on its Pallas kernels, and the "
            f"port's kernels take only the registry's sigma (erf-GELU is "
            f"ops.ell.Activation('gelu'), gelu()); on the card only a sigma "
            f"that holds parameters or tensors takes the pure ELL route")
    if name not in _LOGGED:
        _LOGGED.add(name)
        _routing_logger.info("sigma routing: %s -> pure-ell", name)
    return None


# ======================================================================
# Slot scales: static (precomputed) or from a per-edge scale (DropEdge)
# ======================================================================

def slot_scale(fg: FastGraph, side: str, agg_type: str,
               edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-slot scales [S] of ``agg_type`` on the ``side`` ("dst" or
    "src") plan: the FastGraph's static ones, or under a DropEdge
    ``edge_mask`` bool [E_pad] (sorted edge order) those of the kept edges,
    ``gather_edges(edge_mask) * static``. That equals the JAX route's
    ``gather_edges(valid * sym_norm) * slot_valid``: DropEdge keeps the full
    graph's sym norms. mean takes the sum scales there, and its division
    by the kept in-edges is the aggregate's (:func:`_kept_mean`)."""
    scales = getattr(fg, f"{side}_slot_scales")
    if edge_mask is None:
        return scales[agg_type]
    if edge_mask.shape != (fg.e_pad,):
        raise ValueError(f"edge_mask {tuple(edge_mask.shape)} is not "
                         f"[E_pad] = {(fg.e_pad,)}")
    plan = getattr(fg, f"{side}_plan")
    base = "sum" if agg_type == "mean" else agg_type
    return plan.gather_edges(edge_mask.to(torch.float32)) * scales[base]


def _kept_mean(fg: FastGraph, out: torch.Tensor, agg_type: str,
               edge_mask, sd: torch.Tensor) -> torch.Tensor:
    """mean under a DropEdge mask: ``out`` (the sums over the kept edges,
    dst slot scales ``sd``) divided by each node's kept in-edges, at
    least 1; ``out`` unchanged otherwise."""
    if agg_type != "mean" or edge_mask is None:
        return out
    return out / fg.dst_plan.reduce_slots_sum(sd[:, None]).clamp_min(1.0)


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


def _dst_args(fg: FastGraph, eq, ek, sd, act, edge_dtype) -> tuple:
    """The dst-plan arguments of the forward kernels: eq, ek in the edge
    dtype, the slot arrays and the dst slot scales ``sd``."""
    plan = fg.dst_plan
    return (eq.contiguous(), _cast(ek, edge_dtype), fg.dst_slot_srcnode, sd,
            plan.row_key, plan.row_ptr, act)


def _src_rows(fg: FastGraph, eq, ek, g, ss, act, edge_dtype,
              fuse: bool) -> torch.Tensor:
    """Src-plan rows of the key-side gradient without an edge term (the JAX
    route's ``src_pass``) under the src slot scales ``ss``: ``ell_src_bwd``
    (``ell_src_bwd_rowwise`` for a sigma that is not elementwise) from the
    eq and g tables in the edge dtype, or with ``fuse``
    ``ell_src_bwd_fused`` from one [N, 2H] table cat([eq, g], 1) in the
    edge dtype, built here in every backward."""
    splan = fg.src_plan
    rest = (ek.contiguous(), fg.src_slot_dstnode, ss, splan.row_key,
            splan.row_ptr, act)
    if fuse:
        both = torch.cat([_cast(eq, edge_dtype), _cast(g, edge_dtype)], 1)
        return ell_src_bwd_fused(both, *rest)
    kernel = ell_src_bwd if act.elementwise else ell_src_bwd_rowwise
    return kernel(_cast(eq, edge_dtype), _cast(g, edge_dtype), *rest)


class _EllSirAggregate(torch.autograd.Function):
    """Forward with ``ell_act_reduce2`` (row sums and derivative mass
    ``sbar``); backward ``g_eq = g * sbar`` and ``g_ek`` from the
    src-major ``ell_src_bwd`` (``ell_src_bwd_fused`` with ``fuse``). With
    an edge table ``e`` [E_pad, H] (sorted edge order) the edge-term forms
    run instead, and the backward's ``ell_src_bwd_edge`` also gives g_e
    [E_pad, H] f32. ``sd`` and ``ss`` are the dst and src slot scales.
    Only node-sized tensors, e in the edge dtype and ``ss`` are saved."""

    @staticmethod
    def forward(ctx, eq, ek, e, sd, ss, fg: FastGraph, act: Activation,
                edge_dtype, fuse: bool):
        plan = fg.dst_plan
        args = _dst_args(fg, eq, ek, sd, act, edge_dtype)
        if e is None:
            rows, srows = ell_act_reduce2(*args)
        else:
            e = _cast(e, edge_dtype)
            rows, srows = ell_act_reduce2_edge(*args, e, plan.slot_edge)
        sbar = plan.finalize_rows_sum(srows)
        ctx.save_for_backward(eq, ek, e, sbar, ss)
        ctx.fg, ctx.act, ctx.edge_dtype, ctx.fuse = fg, act, edge_dtype, fuse
        return plan.finalize_rows_sum(rows)

    @staticmethod
    def backward(ctx, g):
        eq, ek, e, sbar, ss = ctx.saved_tensors
        fg = ctx.fg
        g_eq = g * sbar if ctx.needs_input_grad[0] else None
        g_ek = g_e = None
        if any(ctx.needs_input_grad[1:3]):
            splan = fg.src_plan
            if e is None:
                rows = _src_rows(fg, eq, ek, g, ss, ctx.act, ctx.edge_dtype,
                                 ctx.fuse)
            else:
                rows, g_e = ell_src_bwd_edge(
                    _cast(eq, ctx.edge_dtype), _cast(g, ctx.edge_dtype),
                    ek.contiguous(), fg.src_slot_dstnode, ss, splan.row_key,
                    splan.row_ptr, ctx.act, e, splan.slot_edge,
                    fg.edge2src_slot, fg.edge_mask)
            if ctx.needs_input_grad[1]:
                g_ek = splan.finalize_rows_sum(rows)
        if not ctx.needs_input_grad[2]:
            g_e = None
        return g_eq, g_ek, g_e, None, None, None, None, None, None


class _EllSirAggregateGeneral(torch.autograd.Function):
    """The general route, for a sigma that is not elementwise (the port of
    the ``act_elementwise=False`` branch of
    ``make_ell_sir_aggregate_pallas``). Forward: ``ell_act_reduce_rowwise``.
    Backward: g_eq from ``ell_geq_reduce``, the dst-major vjp over the
    forward's slots; g_ek from ``ell_src_bwd_rowwise`` (``ell_src_bwd_fused``
    with ``fuse``). With an edge table ``e`` [E_pad, H] (sorted edge order)
    the edge-term forms run instead, and ``ell_src_bwd_rowwise_edge`` also
    gives g_e [E_pad, H] f32 (JAX's ``src_pass(need_gz=True)``); ``fuse``
    is then off. The kernels gather their operands by index, so only eq,
    ek, e in the edge dtype and the slot scales are saved and nothing
    slot-sized and feature-wide is kept or gathered again: the JAX route's
    ``remat`` switch, which trades its saved [S, H] gather for a second
    gather, has no counterpart here."""

    @staticmethod
    def forward(ctx, eq, ek, e, sd, ss, fg: FastGraph, act: Activation,
                edge_dtype, fuse: bool):
        plan = fg.dst_plan
        args = _dst_args(fg, eq, ek, sd, act, edge_dtype)
        if e is None:
            rows = ell_act_reduce_rowwise(*args)
        else:
            e = _cast(e, edge_dtype)
            rows = ell_act_reduce_rowwise_edge(*args, e, plan.slot_edge)
        ctx.save_for_backward(eq, ek, e, sd, ss)
        ctx.fg, ctx.act, ctx.edge_dtype, ctx.fuse = fg, act, edge_dtype, fuse
        return plan.finalize_rows_sum(rows)

    @staticmethod
    def backward(ctx, g):
        eq, ek, e, sd, ss = ctx.saved_tensors
        fg, act, edge_dtype = ctx.fg, ctx.act, ctx.edge_dtype
        plan, splan = fg.dst_plan, fg.src_plan
        g = g.contiguous()
        g_eq = g_ek = g_e = None
        if ctx.needs_input_grad[0]:
            args = _dst_args(fg, eq, ek, sd, act, edge_dtype)
            rows = (ell_geq_reduce(*args, g) if e is None else
                    ell_geq_reduce_edge(*args, g, e, plan.slot_edge))
            g_eq = plan.finalize_rows_sum(rows)
        if e is None:
            if ctx.needs_input_grad[1]:
                g_ek = splan.finalize_rows_sum(_src_rows(
                    fg, eq, ek, g, ss, act, edge_dtype, ctx.fuse))
        elif any(ctx.needs_input_grad[1:3]):
            rows, g_e = ell_src_bwd_rowwise_edge(
                _cast(eq, edge_dtype), _cast(g, edge_dtype), ek.contiguous(),
                fg.src_slot_dstnode, ss, splan.row_key, splan.row_ptr, act,
                e, splan.slot_edge, fg.edge2src_slot, fg.edge_mask)
            if ctx.needs_input_grad[1]:
                g_ek = splan.finalize_rows_sum(rows)
            if not ctx.needs_input_grad[2]:
                g_e = None
        return g_eq, g_ek, g_e, None, None, None, None, None, None


def ell_sir_aggregate(fg: FastGraph, eq: torch.Tensor, ek: torch.Tensor,
                      activation, agg_type: str, *,
                      e: Optional[torch.Tensor] = None,
                      edge_mask: Optional[torch.Tensor] = None,
                      edge_dtype: Optional[torch.dtype] = None,
                      fuse_bwd_take: bool = False) -> torch.Tensor:
    """out[u] = sum_e scale_e * sigma(eq[u] + ek[src_e] [+ e_e]) over u's
    incoming edges. ``e`` [E_pad, H] f32 is an optional edge term in sorted
    edge order (the JAX route's ``with_edge``), and gets a gradient.

    The scales are the FastGraph's static per-slot scales for ``agg_type``
    or, under a DropEdge ``edge_mask`` bool [E_pad] (sorted edge order),
    those of the kept edges (:func:`slot_scale`, once per call); mean then
    divides by each node's kept in-edges after the aggregate, as the JAX
    package's ``sir_aggregate`` does.

    ``edge_dtype`` (None or torch.bfloat16) is the type the gathered
    operands are carried in; the edge term is added to a gathered row in
    f32 and rounded to it; all sums are f32. Without a gradient
    (``torch.is_grad_enabled()`` False, or no input needs one) the forward
    runs ``ell_act_reduce`` (``ell_act_reduce_edge``) alone.

    A sigma that is not elementwise (a row-wise registry entry, or one with
    ``sir_elementwise=False``) takes the general route, with or without
    ``e``, at any width, as ``sir_gcn_tpu/ops/ell.py`` ``ell_sir_aggregate``
    sends it to ``act_elementwise=False``. A
    sigma outside the registry takes the pure ELL route
    (:func:`pure_ell_sir_aggregate`) where :func:`resolve_activation`
    allows it, and there ``edge_dtype`` and ``fuse_bwd_take`` do not
    apply. ``fuse_bwd_take`` (default off, as in JAX) makes the key-side
    backward read eq and g from one [N, 2H] table; it is ignored with an
    edge term, as in JAX."""
    if agg_type not in fg.dst_slot_scales:
        raise ValueError(f"agg_type {agg_type!r} is not a linear aggregation")
    act = resolve_activation(activation, eq.device)
    if act is None:
        return pure_ell_sir_aggregate(fg, eq, ek, activation, agg_type, e=e,
                                      edge_mask=edge_mask)
    inputs = (eq, ek) if e is None else (eq, ek, e)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    sd = slot_scale(fg, "dst", agg_type, edge_mask)
    if grad:
        fn = _EllSirAggregate if act.elementwise else _EllSirAggregateGeneral
        out = fn.apply(eq, ek, e, sd,
                       slot_scale(fg, "src", agg_type, edge_mask), fg, act,
                       edge_dtype, fuse_bwd_take and e is None)
    else:
        plan = fg.dst_plan
        args = _dst_args(fg, eq, ek, sd, act, edge_dtype)
        if e is None:
            kernel = ell_act_reduce if act.elementwise else \
                ell_act_reduce_rowwise
            rows = kernel(*args)
        else:
            kernel = ell_act_reduce_edge if act.elementwise else \
                ell_act_reduce_rowwise_edge
            rows = kernel(*args, _cast(e, edge_dtype), plan.slot_edge)
        out = plan.finalize_rows_sum(rows)
    return _kept_mean(fg, out, agg_type, edge_mask, sd)


# ======================================================================
# The fused-edge route: SIREConv's W_E inside the kernels
# ======================================================================

class _EllSirAggregateFusedEdge(torch.autograd.Function):
    """Forward: ``ell_edge_act_reduce2`` gives the row sums and ``sbar``
    (also without a gradient: the JAX route has no single-output form).
    Backward: ``g_eq = g * sbar``; ``ell_edge_src_bwd`` gives the g_ek rows
    and g_WE. e_basis gets no gradient. Only ek and, in the backward, eq
    and g are carried in the edge dtype; e_basis, w_e and the projection
    stay f32. ``sd`` and ``ss`` are the dst and src slot scales. Only
    node-sized tensors, e_basis, w_e and ``ss`` are saved."""

    @staticmethod
    def forward(ctx, eq, ek, e_basis, w_e, sd, ss, fg: FastGraph,
                act: Activation, edge_dtype):
        plan = fg.dst_plan
        rows, srows = ell_edge_act_reduce2(
            eq.contiguous(), _cast(ek, edge_dtype), e_basis.contiguous(),
            w_e.contiguous(), fg.dst_slot_srcnode, plan.slot_edge, sd,
            plan.row_key, plan.row_ptr, act)
        sbar = plan.finalize_rows_sum(srows)
        ctx.save_for_backward(eq, ek, e_basis, w_e, sbar, ss)
        ctx.fg, ctx.act, ctx.edge_dtype = fg, act, edge_dtype
        return plan.finalize_rows_sum(rows)

    @staticmethod
    def backward(ctx, g):
        eq, ek, e_basis, w_e, sbar, ss = ctx.saved_tensors
        fg = ctx.fg
        g_eq = g * sbar if ctx.needs_input_grad[0] else None
        g_ek = g_we = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[3]:
            splan = fg.src_plan
            rows, g_we = ell_edge_src_bwd(
                _cast(eq, ctx.edge_dtype), _cast(g, ctx.edge_dtype),
                ek.contiguous(), e_basis.contiguous(), w_e.contiguous(),
                fg.src_slot_dstnode, splan.slot_edge, ss, splan.row_key,
                splan.row_ptr, ctx.act)
            if ctx.needs_input_grad[1]:
                g_ek = splan.finalize_rows_sum(rows)
        if not ctx.needs_input_grad[3]:
            g_we = None
        return g_eq, g_ek, None, g_we, None, None, None, None, None


def ell_sir_aggregate_fused_edge(fg: FastGraph, eq: torch.Tensor,
                                 ek: torch.Tensor, e_basis: torch.Tensor,
                                 w_e: torch.Tensor, activation,
                                 agg_type: str, *,
                                 edge_mask: Optional[torch.Tensor] = None,
                                 edge_dtype: Optional[torch.dtype] = None
                                 ) -> torch.Tensor:
    """out[u] = sum_e scale_e * sigma(eq[u] + ek[src_e] + e_basis_e @ w_e)
    with the FastGraph's static per-slot scales for ``agg_type``, or those
    of the edges a DropEdge ``edge_mask`` keeps (as in
    :func:`ell_sir_aggregate`): the ``ell_sir_aggregate`` of ``e = e_basis
    @ w_e``, with the projection formed inside the kernels, so no [E_pad,
    H] edge table or cotangent exists. e_basis [E_pad, De] f32 in sorted
    edge order (no gradient), w_e [De, H] f32 in the JAX layout. The port
    of ``make_ell_sir_aggregate_pallas_fused_edge``, without its TPU
    padding (``pad_basis``, the 128-lane wrapper). The fused kernels take
    an elementwise sigma of the registry; for any other ``sir_aggregate``
    forms e itself and takes :func:`ell_sir_aggregate` (or the pure route),
    as JAX's does, and this raises."""
    if agg_type not in fg.dst_slot_scales:
        raise ValueError(f"agg_type {agg_type!r} is not a linear aggregation")
    act = resolve_activation(activation, eq.device)
    if act is None or not act.elementwise:
        raise ValueError(
            f"the fused-edge kernels take an elementwise sigma of the "
            f"registry, not {getattr(act, 'name', activation)}: sir_aggregate "
            f"forms e = e_basis @ w_edge for it and takes the e route")
    sd = slot_scale(fg, "dst", agg_type, edge_mask)
    out = _EllSirAggregateFusedEdge.apply(
        eq, ek, e_basis, w_e, sd, slot_scale(fg, "src", agg_type, edge_mask),
        fg, act, edge_dtype)
    return _kept_mean(fg, out, agg_type, edge_mask, sd)


# ======================================================================
# The max aggregation: W_R per slot inside the kernels, ties split
# ======================================================================

class _EllSirAggregateMax(torch.autograd.Function):
    """Forward: ``ell_max_fwd`` and the max finalize give the key-level max
    ``out1`` (the f32 min for a node with no valid slot); ``out =
    where(out1 > NEG/2, out1 + b, 0)``. Backward: ``ell_max_wincount``
    counts tied winners, ``ell_max_bwd`` routes ``gsc = g / count`` to them
    (g_eq, per-slot g_z, g_W), ``ell_scaled_reduce`` sums g_z in src order
    for g_ek. With an edge table ``e`` [E_pad, H] the three are their edge
    forms, and g_e is each edge's dst slot of g_z (in the edge dtype, as
    JAX rounds it) widened to f32 (:func:`edge_cotangent`). A slot is valid
    where its dst scale ``sd`` is positive. Only node- and edge-sized
    tensors, W and ``sd`` are saved."""

    @staticmethod
    def forward(ctx, eq, ek, w, b, e, sd, fg: FastGraph, act: Activation,
                edge_dtype):
        out1 = _max_rows(fg, eq, ek, w, sd, act, edge_dtype, e)
        ctx.save_for_backward(eq, ek, w, out1, sd, e)
        ctx.fg, ctx.act, ctx.edge_dtype = fg, act, edge_dtype
        return torch.where(out1 > NEG / 2, out1 + b, 0.0)

    @staticmethod
    def backward(ctx, g):
        eq, ek, w, out1, sd, e = ctx.saved_tensors
        fg, act = ctx.fg, ctx.act
        plan, splan = fg.dst_plan, fg.src_plan
        args = (eq.contiguous(), _cast(ek, ctx.edge_dtype),
                fg.dst_slot_srcnode, sd, plan.row_key, plan.row_ptr,
                w.contiguous())
        edge = () if e is None else (_cast(e, ctx.edge_dtype),
                                     plan.slot_edge)
        wincount = ell_max_wincount if e is None else ell_max_wincount_edge
        bwd = ell_max_bwd if e is None else ell_max_bwd_edge
        counts = plan.finalize_rows_sum(wincount(*args, out1, act, *edge))
        g_act = torch.where(out1 > NEG / 2, g, 0.0)
        gsc = (g_act / counts.clamp_min(1.0)).contiguous()
        geq_rows, g_z, g_w = bwd(*args, out1, gsc, act, *edge)
        g_eq = plan.finalize_rows_sum(geq_rows)
        g_ek = splan.finalize_rows_sum(ell_scaled_reduce(
            g_z, fg.src_slot_from_dst_slot, splan.slot_valid, splan.row_ptr))
        g_e = None
        if e is not None and ctx.needs_input_grad[4]:
            g_e = edge_cotangent(g_z, fg.edge2dst_slot, fg.edge_mask)
        return g_eq, g_ek, g_w, g_act.sum(0), g_e, None, None, None, None


def _max_rows(fg: FastGraph, eq, ek, w, sd, act, edge_dtype,
              e=None) -> torch.Tensor:
    """[N, O] key-level max before the bias (the f32 min for empty keys)."""
    plan = fg.dst_plan
    args = (eq.contiguous(), _cast(ek, edge_dtype), fg.dst_slot_srcnode, sd,
            plan.row_key, plan.row_ptr, w.contiguous(), act)
    rows = (ell_max_fwd(*args) if e is None else ell_max_fwd_edge(
        *args, _cast(e, edge_dtype), plan.slot_edge))
    return plan.finalize_rows_max(rows)


def ell_sir_aggregate_max(fg: FastGraph, eq: torch.Tensor, ek: torch.Tensor,
                          w: torch.Tensor, b: Optional[torch.Tensor],
                          activation, *, e: Optional[torch.Tensor] = None,
                          edge_mask: Optional[torch.Tensor] = None,
                          edge_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """out[u] = max_e sigma(eq[u] + ek[src_e] [+ e_e]) @ w + b over u's
    valid incoming edges, and 0 for a node with none (DGL's zero fill). eq,
    ek [N, H] f32, e [E_pad, H] f32 in sorted edge order or None, w [H, O]
    f32 (the JAX layout), b [O] or None; returns [N, O] f32. A cotangent is
    split equally among tied winners.

    An edge is valid where the graph's edge mask holds and, with a DropEdge
    ``edge_mask`` bool [E_pad], where that holds too: the dst slot scales
    are the sum scales of the kept edges (:func:`slot_scale`), positive on
    a valid slot. ``edge_dtype`` (None or torch.bfloat16) is the type ek
    and e are gathered in (their sum rounded to it, as JAX's ``cast``) and
    the per-slot g_z stored in; m, the max and all sums are f32. Without a
    gradient the forward runs ``ell_max_fwd`` (``ell_max_fwd_edge``) alone.
    The port of ``make_ell_sir_aggregate_max_pallas``, with or without its
    edge term, for any sigma of the registry: an elementwise one (declared
    ``sir_elementwise=False`` or not: the kernels take sigma by its id), or
    a row-wise one over each slot's H features. (JAX's builder pads H to a
    multiple of 128 first, exact for an elementwise sigma; a row-wise
    sigma here takes its statistic over the H features, as JAX's XLA
    builder ``make_ell_sir_aggregate_max`` does.) A sigma outside the
    registry takes the pure ELL route (:func:`pure_ell_sir_aggregate_max`),
    with or without ``e``, where :func:`resolve_activation` allows it."""
    act = resolve_activation(activation, eq.device)
    if act is None:
        return pure_ell_sir_aggregate_max(fg, eq, ek, w, b, activation, e=e,
                                          edge_mask=edge_mask)
    if b is None:
        b = w.new_zeros(w.shape[1])
    sd = slot_scale(fg, "dst", "sum", edge_mask)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (eq, ek, w, b, e)):
        return _EllSirAggregateMax.apply(eq, ek, w, b, e, sd, fg, act,
                                         edge_dtype)
    out1 = _max_rows(fg, eq, ek, w, sd, act, edge_dtype, e)
    return torch.where(out1 > NEG / 2, out1 + b, 0.0)


# ======================================================================
# The pure ELL route: any sigma, in plain PyTorch (JAX's XLA route)
# ======================================================================

class _SlotInputs(torch.autograd.Function):
    """z [S, H] = eq[slot key] + ek[dst_slot_srcnode] (+ e[slot_edge]) on
    the dst plan, with JAX's scatter-free transpose: g_eq reduces g_z by
    dst, g_ek takes g_z into src-slot order (``src_slot_from_dst_slot``)
    and reduces it by src, and g_e reads each edge's slot
    (:func:`edge_cotangent`)."""

    @staticmethod
    def forward(ctx, eq, ek, e, fg: FastGraph):
        plan = fg.dst_plan
        z = plan.spread(eq) + ek.index_select(0, fg.dst_slot_srcnode)
        if e is not None:
            z = z + plan.gather_edges(e)
        ctx.fg = fg
        return z

    @staticmethod
    def backward(ctx, g_z):
        fg = ctx.fg
        plan, splan = fg.dst_plan, fg.src_plan
        g_eq = g_ek = g_e = None
        if ctx.needs_input_grad[0]:
            g_eq = plan.reduce_slots_sum(g_z * plan.slot_valid[:, None])
        if ctx.needs_input_grad[1]:
            g_ek = splan.reduce_slots_sum(
                g_z.index_select(0, fg.src_slot_from_dst_slot)
                * splan.slot_valid[:, None])
        if ctx.needs_input_grad[2]:
            g_e = edge_cotangent(g_z, fg.edge2dst_slot, fg.edge_mask)
        return g_eq, g_ek, g_e, None


class _SlotSum(torch.autograd.Function):
    """[S, H] -> [N, H] ``reduce_slots_sum`` on a plan; backward
    ``spread(g)``, its transpose for values that vanish on padding slots
    (the caller's scale is 0 there)."""

    @staticmethod
    def forward(ctx, values, plan: ReducePlan):
        ctx.plan = plan
        return plan.reduce_slots_sum(values)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.spread(g), None


class _SlotMax(torch.autograd.Function):
    """[S, O] per-slot products -> [N, O] max over each key's valid slots,
    0 for a key with none (DGL's zero fill). Backward: the cotangent is
    split equally among the valid slots that equal the max."""

    @staticmethod
    def forward(ctx, m, valid, plan: ReducePlan):
        neg = torch.finfo(m.dtype).min
        out = plan.reduce_slots_max(torch.where(valid[:, None], m, neg))
        has_any = plan.reduce_slots_sum(valid.to(m.dtype)[:, None]) > 0
        out = torch.where(has_any & (out > neg / 2), out, 0.0)
        ctx.save_for_backward(m, valid, out)
        ctx.plan = plan
        return out

    @staticmethod
    def backward(ctx, g):
        m, valid, out = ctx.saved_tensors
        plan = ctx.plan
        win = ((m == plan.spread(out)) & valid[:, None]).to(m.dtype)
        counts = plan.reduce_slots_sum(win)
        return plan.spread(g / counts.clamp_min(1.0)) * win, None, None


def pure_ell_sir_aggregate(fg: FastGraph, eq: torch.Tensor,
                           ek: torch.Tensor, activation: Callable,
                           agg_type: str, *,
                           e: Optional[torch.Tensor] = None,
                           edge_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The linear aggregate of :func:`ell_sir_aggregate` for any torch
    callable sigma (elementwise, row-wise, an ``nn.Module``), in plain
    PyTorch on the plans: the port of the JAX package's pure-XLA factory
    ``make_ell_sir_aggregate``, the route JAX takes for a sigma that closes
    over arrays, which a Pallas kernel cannot hold. It is that route, not a
    kernel's plain version: no kernel computes it. ``sir_aggregate`` sends
    a sigma here as :func:`resolve_activation` says; a direct call runs on
    any device, as JAX's factory does.

    z = eq[u] + ek[src_e] (+ e_e) per dst slot, out = the slot sums of
    sigma(z) * scale, with the static scales of ``agg_type`` or those of
    the edges a DropEdge ``edge_mask`` keeps (mean then divides by the
    kept in-edges). The gathers and reduces have JAX's scatter-free
    backward (src-plan takes and reduces), and sigma is differentiated by
    autograd between them, so a sigma with parameters gets their
    gradients. f32, as the JAX route; the edge dtype does not apply. Keeps
    z and sigma's own residuals, [S, H] each."""
    if agg_type not in fg.dst_slot_scales:
        raise ValueError(f"agg_type {agg_type!r} is not a linear aggregation")
    s = slot_scale(fg, "dst", agg_type, edge_mask)
    z = _SlotInputs.apply(eq, ek, e, fg)
    out = _SlotSum.apply(activation(z) * s[:, None], fg.dst_plan)
    return _kept_mean(fg, out, agg_type, edge_mask, s)


def pure_ell_sir_aggregate_max(fg: FastGraph, eq: torch.Tensor,
                               ek: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor],
                               activation: Callable, *,
                               e: Optional[torch.Tensor] = None,
                               edge_mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The max aggregate of :func:`ell_sir_aggregate_max` for any torch
    callable sigma, in plain PyTorch on the plans: the port of the JAX
    package's ``make_ell_sir_aggregate_max`` (its XLA route, not a kernel's
    plain version). m = sigma(z) @ w + b per dst slot, the max over a
    node's valid slots (the graph's edge mask, and ``edge_mask`` when
    given), 0 for a node with none; the cotangent is split equally among
    tied winners, and the gathers have JAX's scatter-free backward. f32."""
    valid = slot_scale(fg, "dst", "sum", edge_mask) > 0
    m = activation(_SlotInputs.apply(eq, ek, e, fg)) @ w
    if b is not None:
        m = m + b
    return _SlotMax.apply(m, valid, fg.dst_plan)


# ======================================================================
# Plan harmonization (for the distributed aggregates)
# ======================================================================

def uniform_stage2(plans: list, rebuild_args: list) -> list:
    """Make a plan list stage-2-uniform: if any plan has a hub second
    stage, rebuild the ones without (``rebuild_args[i]`` are the
    positional arguments of ``build_reduce_plan`` for plan i) with
    ``force_stage2``; if none has, leave all stage-1-only."""
    if any(p.s2_gather is not None for p in plans):
        plans = [p if p.s2_gather is not None
                 else build_reduce_plan(*a, force_stage2=True)
                 for p, a in zip(plans, rebuild_args)]
    return plans


def _common_buckets(bucket_lists) -> tuple:
    """Each budget's largest row count over the plans, duplicate budgets
    within a plan merged, budgets ascending."""
    per = []
    for buckets in bucket_lists:
        d = {}
        for b, nr in buckets:
            d[b] = d.get(b, 0) + nr
        per.append(d)
    budgets = sorted(set(b for d in per for b in d))
    return tuple((b, max(d.get(b, 0) for d in per)) for b in budgets)


def _relayout_stage(plan_buckets, cbuckets, arrays, pad_values):
    """Re-lay per-slot ``arrays`` of a plan's (possibly duplicate-budget)
    bucket sequence into the common bucket structure ``cbuckets``, padding
    rows with ``pad_values``. Returns the arrays, the old-row -> new-row
    map (its last entry maps the appended zero row) and the new row
    count."""
    seg_slots, row_spans = {}, {}
    s = r = 0
    for b, nr in plan_buckets:
        seg_slots.setdefault(b, []).append((s, nr))
        row_spans.setdefault(b, []).append((r, nr))
        s += b * nr
        r += nr
    outs = [[] for _ in arrays]
    rowmap = np.zeros(r + 1, np.int64)
    new_r = 0
    for b, nrc in cbuckets:
        taken = 0
        for (so, nrp), (ro, _) in zip(seg_slots.get(b, []),
                                      row_spans.get(b, [])):
            for out, arr in zip(outs, arrays):
                out.append(arr[so:so + b * nrp])
            rowmap[ro:ro + nrp] = new_r + taken + np.arange(nrp)
            taken += nrp
        for out, arr, padv in zip(outs, arrays, pad_values):
            out.append(np.full((b * (nrc - taken),) + arr.shape[1:], padv,
                               arr.dtype))
        new_r += nrc
    rowmap[r] = new_r
    return [np.concatenate(o) for o in outs], rowmap, new_r


def harmonize_reduce_plans(plans: list, device=None) -> list:
    """Re-lay :class:`ReducePlan` objects into one common structure (the same
    ``buckets1``, ``buckets2`` and row counts), as the JAX package does so
    that one program runs every shard; here it gives every rank the same
    bucket list. All plans share ``num_keys`` and are stage-2-uniform
    (:func:`uniform_stage2`). Padding rows and slots are zero-valid and no
    key maps to them, so the reductions keep their values. The new plans'
    tensors go to ``device`` (default: the first plan's)."""
    no_s2 = all(p.s2_gather is None for p in plans)
    if not (no_s2 or all(p.s2_gather is not None for p in plans)):
        raise ValueError("mixed stage-2 plans; pass them through "
                         "uniform_stage2 first")
    num_keys = plans[0].num_keys
    if any(p.num_keys != num_keys for p in plans):
        raise ValueError("the plans differ in num_keys")
    device = plans[0].slot_edge.device if device is None else device
    cb1 = _common_buckets(p.buckets1 for p in plans)
    cb2 = None if no_s2 else _common_buckets(p.buckets2 for p in plans)

    out = []
    for p in plans:
        h = p.host
        (se, sv, sk), rowmap1, n_rows1 = _relayout_stage(
            p.buckets1, cb1, [h["slot_edge"], h["slot_valid"],
                              h["slot_key"]], [0, 0.0, 0])
        rk = np.zeros(n_rows1, np.int32)
        rk[rowmap1[:len(h["row_key"])]] = h["row_key"]
        host = dict(slot_edge=se, slot_valid=sv, slot_key=sk, row_key=rk)
        if no_s2:
            # key2row points at stage-1 rows; the sentinel at the zero row
            host["key2row"] = rowmap1[h["key2row"]].astype(np.int32)
        else:
            (g2, v2), rowmap2, _ = _relayout_stage(
                p.buckets2, cb2, [rowmap1[h["s2_gather"]], h["s2_valid"]],
                [0, 0.0])
            host.update(s2_gather=g2.astype(np.int32), s2_valid=v2,
                        key2row=rowmap2[h["key2row"]].astype(np.int32))
        out.append(_plan_from_host(host, cb1, cb2, num_keys, device))
    return out
