"""Boundary-only halo exchange for the node-partitioned full-graph SIR
aggregate (port of ``sir_gcn_tpu/parallel/halo.py``).

The all-gather aggregate (``ell_distributed``) gathers the whole [N_pad, H]
``ek`` on every rank. On a real graph a shard's incoming edges read only a
boundary subset of the other shards' nodes, so this module sends exactly
those rows, with one ``all_to_all``:

* host side, per (receiver r, sender s): the unique remote src nodes
  u(r, s) that r needs from s, padded to a common ``h_max``, so one
  ``all_to_all`` of S blocks of ``h_max`` rows carries every pair;
* each shard's edges split into interior ones (src owned by the shard)
  and boundary ones (src remote), with their own
  :class:`~sir_gcn_tpu_torch.ops.ell.ReducePlan` objects; the interior stage
  reads no received row;
* the backward returns the boundary cotangents with the same
  ``all_to_all``: reduced per (sender, row) into the halo table, sent
  back, then reduced by the sent row (the ``ret_plan``). No collective of
  node-table size anywhere.

One rank a shard (``multihost``): each rank holds its own node rows of eq,
ek and the output, the whole ``GraphBatch`` (its masks, degrees and edge
arrays) and its shard's plans. Edge-indexed inputs (an edge term ``e``,
DropEdge's mask) are global, [E_pad] in sorted edge order, as the
single-device path takes them; each rank slices its edges. A gradient with
respect to a replicated input (``e``, W_R, b_R of max) is this rank's
part; the trainer sums the parameter gradients over the ranks.

The aggregate with a registry sigma that is elementwise, no edge term and
sum, mean or sym runs the port's kernels on both stages:
``ell_act_reduce2`` (#2) forward, ``ell_src_bwd`` (#4) backward,
``ell_act_reduce`` (#1) without a gradient; the exchange carries the edge
dtype, the cotangent return f32. The edge-term form, max, and a sigma
outside the registry take the pure route, the JAX package's XLA variants
in PyTorch on the same plans.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ..graph import GraphBatch
from ..ops.cuda import ell_act_reduce, ell_act_reduce2, ell_src_bwd
from ..ops.ell import (
    _cast,
    _SlotSum,
    build_reduce_plan,
    harmonize_reduce_plans,
    reset_plan_timings,
    resolve_activation,
    static_edge_scale,
    uniform_stage2,
)
from .collectives import all_to_all, rank_of
from .ell_distributed import StageInputs, _stack, take_shard
from .full_graph import NodeShard


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad8(x: int) -> int:
    return max(_round_up(x, 8), 8)


_GLOBAL = dict(per_shard=False)


@dataclasses.dataclass(frozen=True)
class HaloFastGraph:
    """Every shard's plans for the halo aggregate, on the host. The tuples
    hold one plan a shard; the tensors have a leading shard axis S (but
    ``edge_unslice``, which is global). ``*_i`` cover interior edges (src
    owned by the shard), ``*_b`` boundary ones. A shard's halo table holds
    ``n_shards * h_max`` rows: block s the rows received from shard s.
    ``take_shard(hfg, r, device)`` gives rank r's view on its device."""

    dst_plan_i: tuple             # local dst keys over interior edges
    dst_plan_b: tuple             # local dst keys over boundary edges
    src_plan_i: tuple             # local src keys over interior edges
    halo_plan: tuple              # halo-table keys over boundary edges
    ret_plan: tuple               # local node keys over sent halo rows
    slot_src_local: torch.Tensor  # [S, S1i] local src per interior slot
    slot_src_halo: torch.Tensor   # [S, S1b] halo row per boundary slot
    scale_i: torch.Tensor         # [S, S1i] static per-slot scale
    scale_b: torch.Tensor         # [S, S1b]
    src_from_dst_i: torch.Tensor  # [S, Ssi] interior dst slot per src slot
    src_from_dst_b: torch.Tensor  # [S, Shb] boundary dst slot per halo slot
    src_dstnode_i: torch.Tensor   # [S, Ssi] local dst per interior src slot
    src_scale_i: torch.Tensor     # [S, Ssi]
    halo_dstnode: torch.Tensor    # [S, Shb] local dst per halo slot
    halo_scale: torch.Tensor      # [S, Shb]
    send_idx: torch.Tensor        # [S, S*Hmax] local rows to send
    edge_slice_idx: torch.Tensor  # [S, Emax] global edge id per local edge
    edge_slice_valid: torch.Tensor  # [S, Emax] 0/1
    edge2dst_i: torch.Tensor      # [S, Emax] interior dst slot per edge
    edge2dst_b: torch.Tensor      # [S, Emax] boundary dst slot per edge
    edge_interior: torch.Tensor   # [S, Emax] 1.0 = valid interior edge
    edge_valid: torch.Tensor      # [S, Emax] 1.0 = valid (non-pad) edge
    # [E_pad] global edge -> flat shard slot (r * e_max + local position)
    edge_unslice: torch.Tensor = dataclasses.field(metadata=_GLOBAL)
    e_pad: int
    n_shards: int
    n_local: int
    h_max: int
    e_max: int
    agg_type: str

    @property
    def halo_rows(self) -> int:
        return self.n_shards * self.h_max


def _slot_values(plan, per_item: np.ndarray) -> np.ndarray:
    """A per-item array laid into a plan's slot order (0 on padding)."""
    se = plan.host["slot_edge"]
    sv = plan.host["slot_valid"] > 0
    out = np.zeros(plan.num_slots, per_item.dtype)
    if per_item.size:
        out[sv] = per_item[se[sv]]
    return out


def _dst_slot_of_edge(plan, n_items: int) -> np.ndarray:
    """Item id -> its slot in ``plan`` (each item appears once)."""
    se = plan.host["slot_edge"]
    sv = plan.host["slot_valid"] > 0
    out = np.zeros(max(n_items, 1), np.int64)
    out[se[sv]] = np.nonzero(sv)[0]
    return out


_HALO_MEMO: dict = {}
_HALO_MEMO_MAX = 2


def build_halo_fast_graph(graph: GraphBatch, n_shards: int,
                          agg_type: str = "sum",
                          max_budget: int = 256) -> HaloFastGraph:
    """Host side: every shard's interior and boundary plans and the halo
    exchange schedule for a dst-sorted ``GraphBatch`` over ``n_shards``
    contiguous node ranges. ``agg_type`` folds the static per-edge scale
    ('sym' degree norms, 'mean' 1/in-degree, 'sum' and 'max' validity);
    a dynamic scale (DropEdge) replaces it at call time. Memoised by the
    graph's content, as ``build_fast_graph`` is."""
    if agg_type not in ("sum", "mean", "sym", "max"):
        raise ValueError(f"agg_type {agg_type!r}")
    if graph.n_pad % n_shards:
        raise ValueError(f"n_pad {graph.n_pad} is not a multiple of "
                         f"{n_shards} shards")
    n_local = graph.n_pad // n_shards
    S = n_shards
    hst = graph.host
    src = np.asarray(hst["src"], np.int64)
    dst = np.asarray(hst["dst"], np.int64)
    valid = np.asarray(hst["edge_mask"], bool)
    in_deg, out_deg = hst["in_deg"], hst["out_deg"]

    reset_plan_timings()
    digest = hashlib.blake2b(digest_size=16)
    for a in (src, dst, valid, in_deg, out_deg):
        digest.update(np.ascontiguousarray(a).tobytes())
    key = (digest.hexdigest(), graph.n_pad, graph.e_pad, n_shards, agg_type,
           max_budget)
    hit = _HALO_MEMO.get(key)
    if hit is not None:
        return hit

    # max has no degree scale: its static per-slot array is validity
    escale = static_edge_scale("sum" if agg_type == "max" else agg_type,
                               src, dst, valid, in_deg, out_deg
                               ).astype(np.float32)
    bounds = np.searchsorted(dst, np.arange(S + 1) * n_local)
    e_max = _pad8(int((bounds[1:] - bounds[:-1]).max(initial=1)))

    # pass 1: per (receiver, sender) the unique remote src rows -> h_max
    uniq, per_shard = {}, []
    for r in range(S):
        lo, hi = int(bounds[r]), int(bounds[r + 1])
        src_g = src[lo:hi]
        dst_l = dst[lo:hi] - r * n_local
        v_l = valid[lo:hi]
        owner = src_g // n_local
        interior = v_l & (owner == r)
        boundary = v_l & (owner != r)
        for s in range(S):
            if s != r:
                u = np.unique(src_g[boundary & (owner == s)])
                if u.size:
                    uniq[(r, s)] = u
        per_shard.append((lo, hi, src_g, dst_l, v_l, interior, boundary,
                          owner))
    h_max = _pad8(max((u.size for u in uniq.values()), default=1))

    # pass 2: per-shard plans and the send schedule
    families = {k: ([], []) for k in ("di", "db", "si", "hp", "rp")}
    send_all, halo_keys = [], []

    def plan(fam, keys, valid_, nk):
        args = (keys, valid_, nk, max_budget)
        families[fam][0].append(build_reduce_plan(*args))
        families[fam][1].append(args)

    for r in range(S):
        lo, hi, src_g, dst_l, v_l, interior, boundary, owner = per_shard[r]
        # halo key per boundary edge: sender block * h_max + position
        halo_key = np.zeros(max(hi - lo, 1), np.int64)
        for s in range(S):
            if (r, s) in uniq:
                sel = boundary & (owner == s)
                pos = np.searchsorted(uniq[(r, s)], src_g[sel])
                halo_key[np.nonzero(sel)[0]] = s * h_max + pos
        halo_keys.append(halo_key)
        plan("di", dst_l, interior, n_local)
        plan("db", dst_l, boundary, n_local)
        plan("si", src_g - r * n_local, interior, n_local)
        plan("hp", halo_key, boundary, S * h_max)
        # send schedule: block d = the rows this shard sends to receiver d
        sidx = np.zeros(S * h_max, np.int64)
        skey = np.full(S * h_max, -1, np.int64)
        for d in range(S):
            if (d, r) in uniq:
                u = uniq[(d, r)]
                sidx[d * h_max: d * h_max + u.size] = u - r * n_local
                skey[d * h_max: d * h_max + u.size] = u - r * n_local
        send_all.append(sidx)
        plan("rp", np.maximum(skey, 0), skey >= 0, n_local)

    di, db, si, hp, rp = (harmonize_reduce_plans(uniform_stage2(*families[k]))
                          for k in ("di", "db", "si", "hp", "rp"))

    cols = {k: [] for k in ("ssl", "ssh", "sc_i", "sc_b", "sfd_i", "sfd_b",
                            "sdn_i", "ssc_i", "hdn", "hsc", "eidx",
                            "evalid", "e2d_i", "e2d_b", "eint", "evld")}
    for r in range(S):
        lo, hi, src_g, dst_l, v_l, interior, boundary, owner = per_shard[r]
        n_e = hi - lo
        esc_l = escale[lo:hi]
        cols["ssl"].append(_slot_values(di[r], src_g - r * n_local))
        cols["sc_i"].append(_slot_values(di[r], esc_l))
        cols["sc_b"].append(_slot_values(db[r], esc_l))
        cols["ssh"].append(_slot_values(db[r], halo_keys[r]))
        e2d_i = _dst_slot_of_edge(di[r], n_e)
        e2d_b = _dst_slot_of_edge(db[r], n_e)
        cols["sfd_i"].append(_slot_values(si[r], e2d_i))
        cols["sfd_b"].append(_slot_values(hp[r], e2d_b))
        cols["sdn_i"].append(_slot_values(si[r], dst_l))
        cols["ssc_i"].append(_slot_values(si[r], esc_l))
        cols["hdn"].append(_slot_values(hp[r], dst_l))
        cols["hsc"].append(_slot_values(hp[r], esc_l))
        cols["eidx"].append(np.minimum(lo + np.arange(e_max),
                                       graph.e_pad - 1))
        cols["evalid"].append((np.arange(e_max) < n_e).astype(np.float32))

        def pad(a):
            return np.concatenate(
                [a[:n_e], np.zeros(e_max - min(n_e, e_max), a.dtype)])

        cols["e2d_i"].append(pad(e2d_i))
        cols["e2d_b"].append(pad(e2d_b))
        cols["eint"].append(pad(interior.astype(np.float32)))
        cols["evld"].append(pad(v_l.astype(np.float32)))

    # inverse of the edge slicing: global edge -> r * e_max + local pos
    owner_e = np.clip(np.searchsorted(bounds, np.arange(graph.e_pad),
                                      side="right") - 1, 0, S - 1)
    unslice = owner_e * e_max + np.minimum(
        np.arange(graph.e_pad) - bounds[owner_e], e_max - 1)

    i32, f32 = np.int32, np.float32
    out = HaloFastGraph(
        dst_plan_i=tuple(di), dst_plan_b=tuple(db), src_plan_i=tuple(si),
        halo_plan=tuple(hp), ret_plan=tuple(rp),
        slot_src_local=_stack(cols["ssl"], i32),
        slot_src_halo=_stack(cols["ssh"], i32),
        scale_i=_stack(cols["sc_i"], f32), scale_b=_stack(cols["sc_b"], f32),
        src_from_dst_i=_stack(cols["sfd_i"], i32),
        src_from_dst_b=_stack(cols["sfd_b"], i32),
        src_dstnode_i=_stack(cols["sdn_i"], i32),
        src_scale_i=_stack(cols["ssc_i"], f32),
        halo_dstnode=_stack(cols["hdn"], i32),
        halo_scale=_stack(cols["hsc"], f32),
        send_idx=_stack(send_all, i32),
        edge_slice_idx=_stack(cols["eidx"], i32),
        edge_slice_valid=_stack(cols["evalid"], f32),
        edge2dst_i=_stack(cols["e2d_i"], i32),
        edge2dst_b=_stack(cols["e2d_b"], i32),
        edge_interior=_stack(cols["eint"], f32),
        edge_valid=_stack(cols["evld"], f32),
        edge_unslice=torch.from_numpy(unslice.astype(i32)),
        e_pad=graph.e_pad, n_shards=S, n_local=n_local, h_max=h_max,
        e_max=e_max, agg_type=agg_type)
    while len(_HALO_MEMO) >= _HALO_MEMO_MAX:
        _HALO_MEMO.pop(next(iter(_HALO_MEMO)))
    _HALO_MEMO[key] = out
    return out


def local_view(hfg: HaloFastGraph, rank: int, device):
    """Rank ``rank``'s plans and slot arrays on ``device``, with the edge
    weights of each stage's edge cotangent (interior, boundary)."""
    loc = take_shard(hfg, rank, device)
    loc.edge_w_i = loc.edge_interior * loc.edge_valid
    loc.edge_w_b = (1.0 - loc.edge_interior) * loc.edge_valid
    return loc


@dataclasses.dataclass(frozen=True)
class HaloGraph(NodeShard):
    """One rank's handle of a node-partitioned graph, for the models:
    ``sir_aggregate`` dispatches on it, so SIRConv-based models run
    unchanged on node-sharded features (the rank's rows).

    ``graph`` is the whole ``GraphBatch`` on the rank's device, ``hfg``
    every shard's plans on the host and ``local`` this rank's on the
    device. Node-indexed properties (``n_pad``, ``node_mask``, the
    degrees) are this rank's rows, ``rows`` their slice of the whole;
    edge-indexed ones (``e_pad``, ``edge_mask``, ``src``, ``dst``) are the
    whole graph's, so a DropEdge mask is drawn at its global shape.
    :meth:`rank_sum` sums over the ranks with a gradient, for statistics
    (BatchNorm) that span every node."""

    graph: GraphBatch
    hfg: HaloFastGraph
    local: object
    rank: int
    group: object = None

    @property
    def n_pad(self) -> int:
        return self.hfg.n_local

    @property
    def n_global(self) -> int:
        return self.graph.n_pad

    @property
    def e_pad(self) -> int:
        return self.graph.e_pad

    @property
    def device(self) -> torch.device:
        return self.graph.device

    @property
    def node_mask(self):
        return self.graph.node_mask[self.rows]

    @property
    def in_deg(self):
        return self.graph.in_deg[self.rows]

    @property
    def out_deg(self):
        return self.graph.out_deg[self.rows]

    @property
    def edge_mask(self):
        return self.graph.edge_mask

    @property
    def src(self):
        return self.graph.src

    @property
    def dst(self):
        return self.graph.dst

    @property
    def edge_perm(self):
        return self.graph.edge_perm


def build_halo_graph(graph: GraphBatch, n_shards: int, group=None,
                     agg_type: str = "sym", max_budget: int = 256
                     ) -> HaloGraph:
    """Wrap a ``GraphBatch`` (on this rank's device) for the halo
    aggregate over the ``n_shards`` ranks of ``group``."""
    hfg = build_halo_fast_graph(graph, n_shards, agg_type, max_budget)
    rank = rank_of(group)
    return HaloGraph(graph=graph, hfg=hfg,
                     local=local_view(hfg, rank, graph.device), rank=rank,
                     group=group)


# ----------------------------------------------------------------------
# The exchange and the local stages of the kernel variant
# ----------------------------------------------------------------------

def halo_send(loc, ek_l: torch.Tensor, edge_dtype=None) -> torch.Tensor:
    """[S * h_max, H]: block d the rows of ``ek_l`` this rank sends to rank
    d, in the edge dtype."""
    return _cast(ek_l, edge_dtype).index_select(0, loc.send_idx)


def halo_return(loc, ret: torch.Tensor) -> torch.Tensor:
    """[n_local, H]: the returned cotangents of the sent rows (block d
    from rank d) reduced into the rows they were sent from."""
    rp = loc.ret_plan
    return rp.reduce_slots_sum(rp.gather_edges(ret) * rp.slot_valid[:, None])


def halo_local_forward(loc, eq_l, ek_l, halo, s_i, s_b, act, edge_dtype,
                       derivative: bool = True):
    """One rank's forward: the interior stage (``ek_l`` in the edge dtype)
    and the boundary stage (the received ``halo`` table), each
    ``ell_act_reduce2`` (#2) returning (out, sbar), or ``ell_act_reduce``
    (#1) returning out without ``derivative``. ``s_i``, ``s_b`` are the
    dst slot scales. The interior stage reads nothing of the exchange."""
    kernel = ell_act_reduce2 if derivative else ell_act_reduce
    eq_l = eq_l.contiguous()
    res = []
    for plan, table, slot_src, scale in (
            (loc.dst_plan_i, _cast(ek_l, edge_dtype), loc.slot_src_local,
             s_i),
            (loc.dst_plan_b, halo.contiguous(), loc.slot_src_halo, s_b)):
        rows = kernel(eq_l, table, slot_src, scale, plan.row_key,
                      plan.row_ptr, act)
        if derivative:
            res.append(tuple(plan.finalize_rows_sum(r) for r in rows))
        else:
            res.append(plan.finalize_rows_sum(rows))
    if derivative:
        return res[0][0] + res[1][0], res[0][1] + res[1][1]
    return res[0] + res[1]


def halo_local_backward(loc, g_l, eq_l, ek_l, halo, s_si, s_hp, act,
                        edge_dtype):
    """One rank's key-side backward, ``ell_src_bwd`` (#4) on the interior
    src plan and on the halo plan: (g_ek of the interior edges
    [n_local, H], g_halo [S * h_max, H] f32, the cotangent to return).
    ``halo`` is the received table in f32: the kernel reads its key rows
    in f32, as the single-card backward reads ek. ``s_si``, ``s_hp`` are
    the two plans' slot scales; eq and g are carried in the edge dtype."""
    eqc, gc = _cast(eq_l, edge_dtype), _cast(g_l, edge_dtype)
    spi, hp = loc.src_plan_i, loc.halo_plan
    rows_i = ell_src_bwd(eqc, gc, ek_l.contiguous(), loc.src_dstnode_i,
                         s_si, spi.row_key, spi.row_ptr, act)
    rows_b = ell_src_bwd(eqc, gc, halo.contiguous(), loc.halo_dstnode, s_hp,
                         hp.row_key, hp.row_ptr, act)
    return spi.finalize_rows_sum(rows_i), hp.finalize_rows_sum(rows_b)


class _HaloAggregate(torch.autograd.Function):
    """Forward: the exchange in the edge dtype, then both stages on #2.
    Backward: g_eq = g * sbar; both stages on #4, the boundary one on the
    received rows in f32 (with a bf16 edge dtype a second exchange brings
    them, where the JAX package exchanges the bf16 rows again); the
    boundary cotangent goes back with the same ``all_to_all`` in f32 and
    is reduced into the sent rows."""

    @staticmethod
    def forward(ctx, eq, ek, s_i, s_b, s_si, s_hp, loc, act, edge_dtype,
                group):
        halo = all_to_all(halo_send(loc, ek, edge_dtype), group)
        out, sbar = halo_local_forward(loc, eq, ek, halo, s_i, s_b, act,
                                       edge_dtype)
        if halo.dtype != torch.float32:
            halo = None  # exchanged again in f32 by the backward
        ctx.save_for_backward(eq, ek, halo, sbar, s_si, s_hp)
        ctx.loc, ctx.act, ctx.edge_dtype, ctx.group = (loc, act, edge_dtype,
                                                       group)
        return out

    @staticmethod
    def backward(ctx, g):
        eq, ek, halo, sbar, s_si, s_hp = ctx.saved_tensors
        g = g.contiguous()
        g_eq = g * sbar if ctx.needs_input_grad[0] else None
        g_ek = None
        if ctx.needs_input_grad[1]:
            if halo is None:
                halo = all_to_all(halo_send(ctx.loc, ek), ctx.group)
            g_ek, g_halo = halo_local_backward(ctx.loc, g, eq, ek, halo,
                                               s_si, s_hp, ctx.act,
                                               ctx.edge_dtype)
            g_ek = g_ek + halo_return(ctx.loc,
                                      all_to_all(g_halo, ctx.group))
        return (g_eq, g_ek) + (None,) * 8


# ----------------------------------------------------------------------
# The pure variants
# ----------------------------------------------------------------------

class _HaloExchange(torch.autograd.Function):
    """The received halo table [S * h_max, H] of ``ek_l``; the transpose
    returns the cotangent blocks and reduces them into the sent rows."""

    @staticmethod
    def forward(ctx, ek, loc, group):
        ctx.loc, ctx.group = loc, group
        return all_to_all(halo_send(loc, ek), group)

    @staticmethod
    def backward(ctx, g):
        return halo_return(ctx.loc, all_to_all(g.contiguous(),
                                               ctx.group)), None, None


def _stage_inputs(loc, eq, ek, halo, e_l):
    """(z_i, z_b): the interior and boundary slot inputs of the pure
    route, with their scatter-free transposes."""
    z_i = StageInputs.apply(eq, ek, e_l, loc.dst_plan_i, loc.slot_src_local,
                            loc.src_plan_i, loc.src_from_dst_i,
                            loc.edge2dst_i, loc.edge_w_i)
    z_b = StageInputs.apply(eq, halo, e_l, loc.dst_plan_b, loc.slot_src_halo,
                            loc.halo_plan, loc.src_from_dst_b,
                            loc.edge2dst_b, loc.edge_w_b)
    return z_i, z_b


class _HaloSlotMax(torch.autograd.Function):
    """Per dst node the max over the valid slots of both stages, 0 for a
    node with none; the cotangent is split equally among the tied winners
    across both stages."""

    @staticmethod
    def forward(ctx, m_i, v_i, m_b, v_b, dpi, dpb):
        neg = torch.finfo(m_i.dtype).min
        out = torch.maximum(
            dpi.reduce_slots_max(torch.where(v_i[:, None], m_i, neg)),
            dpb.reduce_slots_max(torch.where(v_b[:, None], m_b, neg)))
        has = (dpi.reduce_slots_sum(v_i.to(m_i.dtype)[:, None])
               + dpb.reduce_slots_sum(v_b.to(m_b.dtype)[:, None])) > 0
        out = torch.where(has & (out > neg / 2), out, 0.0)
        ctx.save_for_backward(m_i, v_i, m_b, v_b, out)
        ctx.dpi, ctx.dpb = dpi, dpb
        return out

    @staticmethod
    def backward(ctx, g):
        m_i, v_i, m_b, v_b, out = ctx.saved_tensors
        dpi, dpb = ctx.dpi, ctx.dpb
        win_i = ((m_i == dpi.spread(out)) & v_i[:, None]).to(m_i.dtype)
        win_b = ((m_b == dpb.spread(out)) & v_b[:, None]).to(m_b.dtype)
        gsc = g / (dpi.reduce_slots_sum(win_i)
                   + dpb.reduce_slots_sum(win_b)).clamp_min(1.0)
        return (dpi.spread(gsc) * win_i, None, dpb.spread(gsc) * win_b,
                None, None, None)


def halo_counts(loc, s_i: torch.Tensor, s_b: torch.Tensor) -> torch.Tensor:
    """Per local dst node the sum of its in-edges' dynamic scales (mean's
    divisor under DropEdge); no communication."""
    return (loc.dst_plan_i.reduce_slots_sum(s_i[:, None])
            + loc.dst_plan_b.reduce_slots_sum(s_b[:, None]))[:, 0]


def _shard_edges(loc, values: torch.Tensor) -> torch.Tensor:
    """[E_pad, ...] global sorted-edge values -> [e_max, ...] this
    shard's edges (0 past them)."""
    w = loc.edge_slice_valid.reshape((-1,) + (1,) * (values.dim() - 1))
    return values.index_select(0, loc.edge_slice_idx) * w


def halo_slot_scales(loc, graph: GraphBatch, agg_type: str,
                     edge_mask=None) -> tuple:
    """The slot scales (s_i, s_b, s_si, s_hp) of a rank's interior and
    boundary dst plans, interior src plan and halo plan: the host's static
    ones, or under a DropEdge ``edge_mask`` [E_pad] those of the kept
    edges (times the whole graph's sym norms for sym; mean's sum scales,
    its division left to the caller)."""
    if edge_mask is None:
        return loc.scale_i, loc.scale_b, loc.src_scale_i, loc.halo_scale
    scale = (graph.edge_mask & edge_mask).to(torch.float32)
    if agg_type == "sym":
        in_norm = graph.in_deg.clamp_min(1.0).pow(-0.5)
        out_norm = graph.out_deg.clamp_min(1.0).pow(-0.5)
        scale = scale * (out_norm.index_select(0, graph.src)
                         * in_norm.index_select(0, graph.dst))
    scale_l = _shard_edges(loc, scale)
    return tuple(p.gather_edges(scale_l) * p.slot_valid
                 for p in (loc.dst_plan_i, loc.dst_plan_b, loc.src_plan_i,
                           loc.halo_plan))


def halo_sir_aggregate(hg: HaloGraph, eq, ek, activation, agg_type, e=None,
                       w_relation=None, b_relation=None, edge_mask=None):
    """The ``sir_aggregate`` route of a :class:`HaloGraph`: this rank's
    [n_local, H] output rows from its rows of ``eq`` and ``ek``. Every rank
    of the group calls it (the exchanges pair up).

    Linear aggregations without a DropEdge ``edge_mask`` take the host's
    static slot scales (mean's division folded in); a mask [E_pad] gives
    dynamic ones (the kept edges, times the whole graph's sym norms), and
    mean then divides by the kept in-edges. ``e`` [E_pad, H] is an edge
    term in sorted edge order; max needs ``w_relation`` [H, O] (and takes
    ``b_relation``), the W_R applied per edge before the reduce."""
    if agg_type not in ("sum", "mean", "sym", "max"):
        raise NotImplementedError(f"agg_type = {agg_type} not implemented")
    if agg_type != hg.hfg.agg_type:
        raise ValueError(f"the HaloGraph was built for agg_type "
                         f"{hg.hfg.agg_type!r}, the conv uses {agg_type!r}")
    from ..ops.message_passing import get_edge_dtype

    loc, g = hg.local, hg.graph
    e_l = None if e is None else _shard_edges(loc, e)
    dpi, dpb = loc.dst_plan_i, loc.dst_plan_b
    if agg_type == "max":
        valid = g.edge_mask if edge_mask is None else g.edge_mask & edge_mask
        scale_l = _shard_edges(loc, valid.to(torch.float32))
        v_i = dpi.gather_edges(scale_l) * dpi.slot_valid > 0
        v_b = dpb.gather_edges(scale_l) * dpb.slot_valid > 0
        halo = _HaloExchange.apply(ek, loc, hg.group)
        z_i, z_b = _stage_inputs(loc, eq, ek, halo, e_l)
        b = (b_relation if b_relation is not None
             else w_relation.new_zeros(w_relation.shape[1]))
        return _HaloSlotMax.apply(activation(z_i) @ w_relation + b, v_i,
                                  activation(z_b) @ w_relation + b, v_b,
                                  dpi, dpb)

    s_i, s_b, s_si, s_hp = halo_slot_scales(loc, g, agg_type, edge_mask)
    act = resolve_activation(activation, eq.device)
    if act is not None and act.elementwise and e is None:
        edge_dtype = get_edge_dtype()
        if torch.is_grad_enabled() and (eq.requires_grad or ek.requires_grad):
            out = _HaloAggregate.apply(eq, ek, s_i, s_b, s_si, s_hp, loc,
                                       act, edge_dtype, hg.group)
        else:
            halo = all_to_all(halo_send(loc, ek, edge_dtype), hg.group)
            out = halo_local_forward(loc, eq, ek, halo, s_i, s_b, act,
                                     edge_dtype, derivative=False)
    else:
        halo = _HaloExchange.apply(ek, loc, hg.group)
        z_i, z_b = _stage_inputs(loc, eq, ek, halo, e_l)
        out = (_SlotSum.apply(activation(z_i) * s_i[:, None], dpi)
               + _SlotSum.apply(activation(z_b) * s_b[:, None], dpb))
    if agg_type == "mean" and edge_mask is not None:
        out = out / halo_counts(loc, s_i, s_b).clamp_min(1.0)[:, None]
    return out
