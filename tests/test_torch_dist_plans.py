"""Host side of the port's distribution: every shard's plans of the
all-gather aggregate (``build_sharded_fast_graph``) and of the halo
aggregate (``build_halo_fast_graph``) array for array against the JAX
package's, ``uniform_stage2`` and ``harmonize_reduce_plans`` against JAX's,
the HaloGraph's local view, and the scale guards of ``sir_aggregate``. No
rank is spawned."""

import dataclasses
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sir_gcn_tpu_torch import build_graph
from sir_gcn_tpu_torch.ops import ell as tell
from sir_gcn_tpu_torch.ops import message_passing as tmp
from sir_gcn_tpu_torch.parallel.ell_distributed import (
    build_sharded_fast_graph,
    take_shard,
)
from sir_gcn_tpu_torch.parallel.halo import (
    build_halo_fast_graph,
    build_halo_graph,
)

try:  # pytest puts tests/ on the path; an import as tests.<name> does not
    from torch_dist_workers import skewed_edges
except ModuleNotFoundError:
    from tests.torch_dist_workers import skewed_edges

PLAN_ARRAYS = ("slot_edge", "slot_valid", "slot_key", "row_key", "key2row",
               "s2_gather", "s2_valid")


def graphs(seed: int = 0):
    import sir_gcn_tpu as jsg

    src, dst, n = skewed_edges(seed)
    return (jsg.build_graph(src, dst, n, pad_multiple=128),
            build_graph(src, dst, n, pad_multiple=128))


def assert_plan_equal(jplan, tplan, s=None, where=""):
    """A port plan against a JAX plan (shard ``s`` of stacked leaves)."""
    for k in PLAN_ARRAYS:
        w = getattr(jplan, k)
        if w is None:
            assert tplan.host.get(k) is None, where + k
            continue
        w = np.asarray(w if s is None else w[s])
        np.testing.assert_array_equal(tplan.host[k], w, err_msg=where + k)
    assert tplan.buckets1 == tuple(jplan.buckets1), where
    assert tplan.buckets2 == jplan.buckets2, where
    assert tplan.num_keys == jplan.num_keys, where


def assert_stacked_equal(jobj, tobj, n_shards):
    for f in dataclasses.fields(tobj):
        t, j = getattr(tobj, f.name), getattr(jobj, f.name)
        if isinstance(t, tuple):
            assert len(t) == n_shards
            for s in range(n_shards):
                assert_plan_equal(j, t[s], s, f"{f.name}[{s}].")
        elif isinstance(t, torch.Tensor):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f.name)
        else:
            assert t == j, f.name


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("agg", ["sum", "mean", "sym", "max"])
def test_halo_fast_graph_equals_jax(n_shards, agg):
    from sir_gcn_tpu.parallel.halo import build_halo_fast_graph as jbuild

    jg, tg = graphs(n_shards)
    want = jbuild(jg, n_shards, agg_type=agg, max_budget=16)
    got = build_halo_fast_graph(tg, n_shards, agg, max_budget=16)
    assert got.dst_plan_b[0].s2_gather is not None  # the hub stage
    assert_stacked_equal(want, got, n_shards)
    assert got.halo_rows == want.halo_rows


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("agg", ["sum", "mean", "sym"])
def test_sharded_fast_graph_equals_jax(n_shards, agg):
    from sir_gcn_tpu.parallel.ell_distributed import (
        build_sharded_fast_graph as jbuild,
    )

    jg, tg = graphs(10 + n_shards)
    want = jbuild(jg, n_shards, agg_type=agg, max_budget=16)
    got = build_sharded_fast_graph(tg, n_shards, agg, max_budget=16)
    assert got.src_plan[0].s2_gather is not None
    assert_stacked_equal(want, got, n_shards)


def _plan_family(seed: int, hub: bool):
    """Four plans over 64 keys with differing buckets; with ``hub`` one of
    them has a key above max_budget 8 (a hub stage)."""
    rng = np.random.default_rng(seed)
    args = []
    for i in range(4):
        m = 40 + 30 * i
        keys = rng.integers(0, 64, m)
        if hub and i == 2:
            keys[:20] = 9
        args.append((keys, rng.random(m) < 0.85, 64, 8))
    return args


@pytest.mark.parametrize("hub", [False, True])
def test_uniform_stage2_and_harmonize_equal_jax(hub):
    from sir_gcn_tpu.ops.ell import build_reduce_plan as j_plan
    from sir_gcn_tpu.ops.ell import harmonize_reduce_plans as j_harm
    from sir_gcn_tpu.ops.ell import uniform_stage2 as j_uni

    args = _plan_family(hub, hub)
    jp = j_uni([j_plan(*a) for a in args], args)
    tp = tell.uniform_stage2([tell.build_reduce_plan(*a) for a in args],
                             args)
    assert [p.s2_gather is not None for p in tp] == [hub] * 4
    for j, t in zip(jp, tp):
        assert_plan_equal(j, t)
    for j, t in zip(j_harm(jp), tell.harmonize_reduce_plans(tp)):
        assert_plan_equal(j, t)


@pytest.mark.parametrize("hub", [False, True])
def test_harmonized_plans_reduce_to_the_same_values(hub):
    """Padding rows and slots change no reduction; every harmonized plan
    has one structure and a ``row_ptr`` of it."""
    args = _plan_family(5, hub)
    plans = tell.uniform_stage2([tell.build_reduce_plan(*a) for a in args],
                                args)
    harm = tell.harmonize_reduce_plans(plans)
    assert len({(p.buckets1, p.buckets2, p.num_rows) for p in harm}) == 1
    for (keys, valid, _, _), p, q in zip(args, plans, harm):
        vals = torch.from_numpy(np.random.default_rng(0).normal(
            size=(len(keys), 3)).astype(np.float32))
        np.testing.assert_allclose(
            q.reduce_slots_sum(q.gather_edges(vals) * q.slot_valid[:, None]),
            p.reduce_slots_sum(p.gather_edges(vals) * p.slot_valid[:, None]),
            atol=1e-6)
        assert q.row_ptr[-1] == q.num_slots


def test_harmonize_rejects_mixed_stage2():
    args = _plan_family(1, True)
    plans = [tell.build_reduce_plan(*a) for a in args]
    with pytest.raises(ValueError, match="uniform_stage2"):
        tell.harmonize_reduce_plans(plans)


def test_halo_graph_views_one_ranks_rows():
    _, tg = graphs(3)
    hfg = build_halo_fast_graph(tg, 2, "sym", max_budget=16)
    hg = build_halo_graph(tg, 2, None, "sym", max_budget=16)
    assert hg.hfg is hfg  # memoised by content
    assert hg.rank == 0 and hg.rows == slice(0, 128)
    assert hg.n_pad == 128 and hg.n_global == tg.n_pad == 256
    assert torch.equal(hg.node_mask, tg.node_mask[:128])
    assert hg.e_pad == tg.e_pad and hg.edge_mask is tg.edge_mask
    loc = take_shard(hfg, 1, "cpu")
    assert torch.equal(loc.send_idx, hfg.send_idx[1])
    assert torch.equal(loc.edge_unslice, hfg.edge_unslice)  # global
    assert (loc.dst_plan_i.host["slot_edge"]
            is hfg.dst_plan_i[1].host["slot_edge"])


def test_halo_graph_checks_the_aggregation():
    _, tg = graphs(4)
    hg = build_halo_graph(tg, 1, None, "sym")
    x = torch.zeros(tg.n_pad, 4)
    with pytest.raises(ValueError, match="built for agg_type 'sym'"):
        tmp.sir_aggregate(hg, x, x, tell.leaky_relu(0.2), "mean")


@pytest.fixture
def fresh_guards(monkeypatch):
    monkeypatch.setattr(tmp, "_EDGE_AGG_WARNED", set())
    monkeypatch.setattr(tmp, "_MAX_AGG_WARNED", set())
    monkeypatch.setattr(tmp, "_ALLOW_LARGE_EDGE_AGG", False)


def _warnings(fn) -> list:
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in rec]


def test_scale_guards_warn_once_per_size(fresh_guards):
    big = SimpleNamespace(e_pad=tmp.EDGE_FEATURE_EDGE_LIMIT + 8)
    other = SimpleNamespace(e_pad=tmp.EDGE_FEATURE_EDGE_LIMIT + 16)
    edge = lambda g: tmp._scale_guards(g, "sum", True, kernel_route=False)
    first = _warnings(lambda: edge(big))
    assert len(first) == 1 and "edge term" in first[0]
    assert "TPU" not in first[0] and "XLA" not in first[0]
    assert _warnings(lambda: edge(big)) == []
    assert len(_warnings(lambda: edge(other))) == 1
    mx = lambda: tmp._scale_guards(big, "max", False, kernel_route=False)
    (msg,) = _warnings(mx)
    assert "max aggregation" in msg and "TPU" not in msg
    assert _warnings(mx) == []
    # the kernel routes carry no such cost, and small graphs warn not
    assert _warnings(lambda: tmp._scale_guards(
        SimpleNamespace(e_pad=10 ** 7), "max", True, kernel_route=True)) == []
    assert _warnings(lambda: tmp._scale_guards(
        SimpleNamespace(e_pad=64), "max", True, kernel_route=False)) == []


def test_allow_large_edge_aggregate_silences(fresh_guards):
    big = SimpleNamespace(e_pad=tmp.EDGE_FEATURE_EDGE_LIMIT + 8)
    tmp.allow_large_edge_aggregate(True)
    try:
        assert _warnings(lambda: tmp._scale_guards(
            big, "sum", True, kernel_route=False)) == []
    finally:
        tmp.allow_large_edge_aggregate(False)
    assert len(_warnings(lambda: tmp._scale_guards(
        big, "sum", True, kernel_route=False))) == 1


def test_sir_aggregate_warns_on_the_csr_route(fresh_guards, monkeypatch):
    """Through ``sir_aggregate``: an edge term on the CSR aggregate warns
    (the limit lowered to this small graph), a FastGraph's kernel route
    does not."""
    monkeypatch.setattr(tmp, "EDGE_FEATURE_EDGE_LIMIT", 100)
    _, tg = graphs(6)
    x = torch.ones(tg.n_pad, 4)
    e = torch.ones(tg.e_pad, 4)
    act = tell.leaky_relu(0.2)
    assert len(_warnings(lambda: tmp.sir_aggregate(tg, x, x, act, "sum",
                                                   e=e))) == 1
    fg = tell.build_fast_graph(tg)
    monkeypatch.setattr(tmp, "_EDGE_AGG_WARNED", set())
    assert _warnings(lambda: tmp.sir_aggregate(fg, x, x, act, "sum",
                                               e=e)) == []
