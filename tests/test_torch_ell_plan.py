"""The port's host ELL planner against the JAX package's: slot, key,
scale and stage-2 arrays equal, on the graphs that reach each branch; the
content memo of build_fast_graph and its stage timings."""

import numpy as np
import pytest
import torch

import sir_gcn_tpu.ops.ell as jell
from sir_gcn_tpu import build_graph as j_build_graph
import sir_gcn_tpu_torch.ops.ell as tell
from sir_gcn_tpu_torch import build_graph as t_build_graph


def random_graph(rng):
    n, e = 40, 300
    return rng.integers(0, n, e), rng.integers(0, n, e), n, dict(
        n_pad=64, e_pad=512)


def hub_graph(rng):
    # node 0 takes 600 in-edges and node 1 sends 300: more than MAX_BUDGET
    # = 256 on both sides, so both plans build the hub stage 2
    n = 50
    src = np.concatenate([rng.integers(0, n, 600), np.ones(300, np.int64),
                          rng.integers(0, n, 100)])
    dst = np.concatenate([np.zeros(600, np.int64), rng.integers(0, n, 300),
                          rng.integers(0, n, 100)])
    return src, dst, n, {}


def isolated_graph(rng):
    # nodes 30..59 have no edges: their keys read the appended zero row
    n = 60
    return rng.integers(0, 30, 120), rng.integers(0, 30, 120), n, {}


def odd_budget_graph(rng):
    # in-degrees 9..14 give budgets 10, 12, 14 (not multiples of 8)
    degs = np.array([9, 10, 11, 12, 13, 14, 3, 1])
    dst = np.repeat(np.arange(len(degs)), degs)
    src = rng.integers(0, len(degs), len(dst))
    return src, dst, len(degs), {}


GRAPHS = {"random": random_graph, "hub": hub_graph,
          "isolated": isolated_graph, "odd_budgets": odd_budget_graph}
PLAN_ARRAYS = ("slot_edge", "slot_valid", "slot_key", "row_key", "key2row",
               "s2_gather", "s2_valid")


def _both(name, **kw):
    src, dst, n, pad = GRAPHS[name](np.random.default_rng(7))
    jfg = jell.build_fast_graph(j_build_graph(src, dst, n, **pad), **kw)
    tfg = tell.build_fast_graph(t_build_graph(src, dst, n, **pad), **kw)
    return jfg, tfg


def _check_plan(jp, tp, side):
    assert tp.buckets1 == tuple(jp.buckets1), side
    assert tp.buckets2 == jp.buckets2, side
    assert tp.num_keys == jp.num_keys
    for f in PLAN_ARRAYS:
        want = (None if getattr(jp, f) is None
                else np.asarray(jell.plan_host_array(jp, f)))
        have = getattr(tp, f)
        if want is None:
            assert have is None, (side, f)
            continue
        np.testing.assert_array_equal(have.numpy(), want,
                                      err_msg=f"{side} {f}")
        assert have.dtype.is_floating_point == (want.dtype.kind == "f")


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_fast_graph_matches_jax(graph):
    jfg, tfg = _both(graph)
    _check_plan(jfg.dst_plan, tfg.dst_plan, "dst")
    _check_plan(jfg.src_plan, tfg.src_plan, "src")
    for f in ("dst_slot_srcnode", "src_slot_dstnode"):
        np.testing.assert_array_equal(getattr(tfg, f).numpy(),
                                      np.asarray(getattr(jfg, f)), err_msg=f)
    for agg in ("sum", "mean", "sym"):
        np.testing.assert_array_equal(tfg.dst_slot_scales[agg].numpy(),
                                      np.asarray(jfg.dst_slot_scales[agg]))
        np.testing.assert_array_equal(tfg.src_slot_scales[agg].numpy(),
                                      np.asarray(jfg.src_slot_scales[agg]))


def test_stage2_and_zero_row_are_exercised():
    _, tfg = _both("hub")
    assert tfg.dst_plan.s2_gather is not None
    assert tfg.src_plan.s2_gather is not None
    _, tfg = _both("isolated")
    empty = tfg.dst_plan.key2row.numpy()[30:]
    assert (empty == empty.max()).all()  # all point at the appended row
    _, tfg = _both("odd_budgets")
    assert {10, 12, 14} <= {b for b, _ in tfg.dst_plan.buckets1}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_row_ptr_follows_buckets(graph):
    _, tfg = _both(graph, max_budget=16)
    for plan in (tfg.dst_plan, tfg.src_plan):
        budgets = np.concatenate([np.full(nr, b) for b, nr in plan.buckets1])
        rp = plan.row_ptr.numpy()
        assert rp.dtype == np.int32 and rp[0] == 0
        assert len(rp) == plan.num_rows + 1 == len(budgets) + 1
        np.testing.assert_array_equal(np.diff(rp), budgets)
        assert rp[-1] == plan.num_slots


def test_pad_bucket_repeats_budget_one():
    # 3 edges into 3 distinct nodes: budget-1 rows, then the budget-1 pad
    # bucket that rounds the slots up to 8
    jfg, tfg = _both_edges(np.array([0, 1, 2]), np.array([1, 2, 3]), 4)
    assert tfg.dst_plan.buckets1 == ((1, 3), (1, 5))
    assert tfg.dst_plan.buckets1 == tuple(jfg.dst_plan.buckets1)
    np.testing.assert_array_equal(tfg.dst_plan.row_key.numpy()[3:], 0)
    np.testing.assert_array_equal(tfg.dst_plan.slot_valid.numpy()[3:], 0)


def _both_edges(src, dst, n):
    return (jell.build_fast_graph(j_build_graph(src, dst, n)),
            tell.build_fast_graph(t_build_graph(src, dst, n)))


@pytest.mark.parametrize("max_budget", [4, 16, 256])
def test_bucketize_matches_jax_numpy_form(max_budget):
    rng = np.random.default_rng(max_budget)
    keys = np.concatenate([rng.integers(0, 30, 400), np.full(70, 5)])
    ids = rng.permutation(len(keys))
    want = jell._bucketize_numpy(keys, ids, 30, max_budget)
    got = tell._bucketize(keys, ids, 30, max_budget)
    for a, b in zip(got, want):
        if isinstance(b, list):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_plan_stream_ops_match_jax():
    import jax.numpy as jnp

    jfg, tfg = _both("hub")
    rng = np.random.default_rng(0)
    nodes = rng.normal(size=(tfg.n_pad, 5)).astype(np.float32)
    edges = rng.normal(size=(tfg.e_pad, 5)).astype(np.float32)
    rows = rng.normal(size=(tfg.dst_plan.num_rows, 5)).astype(np.float32)
    jp, tp = jfg.dst_plan, tfg.dst_plan
    np.testing.assert_array_equal(
        tp.spread(torch.from_numpy(nodes)).numpy(),
        np.asarray(jp.spread(jnp.asarray(nodes))))
    np.testing.assert_array_equal(
        tp.gather_edges(torch.from_numpy(edges)).numpy(),
        np.asarray(jp.gather_edges(jnp.asarray(edges))))
    np.testing.assert_allclose(
        tp.finalize_rows_sum(torch.from_numpy(rows)).numpy(),
        np.asarray(jp.finalize_rows_sum(jnp.asarray(rows))),
        atol=2e-4, rtol=1e-4)  # the JAX suite's forward tolerance


STAGES = {"fetch_host", "memo_hash", "bucketize", "plan_upload",
          "fetch_plans", "fg_host", "scales_host", "fg_upload"}


def test_plan_memo_hits_and_misses():
    import dataclasses

    src, dst, n, pad = hub_graph(np.random.default_rng(11))
    g = t_build_graph(src, dst, n, **pad)
    first = tell.build_fast_graph(g)
    assert not tell.last_build_memo_hit()
    again = t_build_graph(src, dst, n, **pad)
    hit = tell.build_fast_graph(again)
    assert tell.last_build_memo_hit()
    assert hit.graph is again and hit.dst_plan is first.dst_plan
    for f in PLAN_ARRAYS:
        a, b = getattr(first.src_plan, f), getattr(hit.src_plan, f)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
    # the static scales bake the degrees in: a changed degree array misses
    deg = g.host["in_deg"].copy()
    deg[0] += 1.0
    other = dataclasses.replace(g, host={**g.host, "in_deg": deg})
    missed = tell.build_fast_graph(other)
    assert not tell.last_build_memo_hit()
    assert not torch.equal(missed.dst_slot_scales["sym"],
                           first.dst_slot_scales["sym"])
    # and so does another max_budget
    tell.build_fast_graph(again, max_budget=64)
    assert not tell.last_build_memo_hit()


def test_plan_stage_names_match_jax():
    src, dst, n, pad = random_graph(np.random.default_rng(12))
    for builds in range(1, 3):  # a miss, then a hit
        jell.build_fast_graph(j_build_graph(src, dst, n, **pad))
        tell.build_fast_graph(t_build_graph(src, dst, n, **pad))
        want = set(jell.plan_timings())
        assert set(tell.plan_timings()) == want
        assert tell.last_build_memo_hit() == jell.last_build_memo_hit() \
            == (builds == 2)
        assert want == (STAGES if builds == 1 else {"fetch_host",
                                                    "memo_hash"})
        assert all(v >= 0.0 for v in tell.plan_timings().values())
    tell.reset_plan_timings()
    assert tell.plan_timings() == {} and not tell.last_build_memo_hit()
