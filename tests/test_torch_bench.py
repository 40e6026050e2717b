"""``bench_torch.py`` against ``bench.py``'s recipe at a small size: the
random, community and powerlaw graphs (with and without RCM reordering)
array-equal to the JAX package's, the inputs equal to ``bench.py``'s
draws, and one training step of each lane (dropout 0, f32 edges) against
the JAX step with the flax weights carried across by
``load_jax_variables``: the loss and parameters at the forward tolerance
(atol 2e-4 / rtol 1e-4), the gradients at the backward one (atol 3e-4 /
rtol 1e-3). Then the record ``run`` returns, and the CLI's refusals. The
``cuda`` test runs the bench on the card at the same small size, each lane's
kernels launched 3 times a step (``pytest -m cuda --noconftest
tests/test_torch_bench.py``).

The JAX side is imported inside the tests, so that the file collects on a
card machine without flax.
"""

import copy

import numpy as np
import pytest
import torch

import bench_torch
from sir_gcn_tpu_torch.ops.message_passing import get_edge_dtype, set_edge_dtype
from sir_gcn_tpu_torch.train import make_adamw
from sir_gcn_tpu_torch.utils import load_jax_variables
from sir_gcn_tpu_torch.utils.convert import _sir_model_slots

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
N, E_RAW = 2000, 13_800  # bench.py's ratio of raw edges to nodes
PLAN_ARRAYS = ("slot_edge", "slot_valid", "slot_key", "row_key", "key2row",
               "s2_gather", "s2_valid")
FG_ARRAYS = ("dst_slot_srcnode", "src_slot_dstnode", "src_slot_from_dst_slot",
             "edge2dst_slot", "edge2src_slot")


@pytest.fixture(autouse=True)
def f32_edges():
    set_edge_dtype(None)
    yield
    set_edge_dtype(None)


def _jax_recipe(kind, reorder, n=N, e_raw=E_RAW):
    """bench.py:64-105 with the JAX package: (rng after the graph's draws,
    src, dst, FastGraph)."""
    import bench
    from sir_gcn_tpu import (
        add_self_loops,
        build_graph,
        permute_nodes,
        rcm_order,
        to_bidirected,
    )
    from sir_gcn_tpu.data.synthetic import powerlaw_edges
    from sir_gcn_tpu.ops.ell import build_fast_graph

    rng = np.random.default_rng(0)
    if kind == "community":
        src, dst = bench.community_graph(rng, n, e_raw)
    elif kind == "powerlaw":
        src, dst = powerlaw_edges(rng, n, e_raw)
    else:
        src = rng.integers(0, n, e_raw)
        dst = rng.integers(0, n, e_raw)
    src, dst = to_bidirected(src, dst)
    src, dst = add_self_loops(src, dst, n)
    if reorder:
        src, dst, _ = permute_nodes(src, dst, rcm_order(src, dst, n))
    return rng, src, dst, build_fast_graph(
        build_graph(src, dst, n, pad_multiple=1024))


def _port_recipe(kind, reorder, n=N, e_raw=E_RAW):
    rng = np.random.default_rng(0)
    src, dst = bench_torch.bench_edges(kind, reorder, rng, n, e_raw)
    fg, _ = bench_torch.build_bench_graph(src, dst, n, "cpu")
    return rng, src, dst, fg


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("kind", ["random", "community", "powerlaw"])
def test_bench_graphs_match_jax(kind, reorder):
    import sir_gcn_tpu.ops.ell as jell

    jrng, jsrc, jdst, jfg = _jax_recipe(kind, reorder)
    trng, tsrc, tdst, tfg = _port_recipe(kind, reorder)
    np.testing.assert_array_equal(tsrc, jsrc)
    np.testing.assert_array_equal(tdst, jdst)
    assert (tfg.n_pad, tfg.e_pad) == (jfg.n_pad, jfg.e_pad)
    for side in ("dst_plan", "src_plan"):
        jp, tp = getattr(jfg, side), getattr(tfg, side)
        assert tp.buckets1 == tuple(jp.buckets1), side
        assert tp.buckets2 == jp.buckets2, side
        for f in PLAN_ARRAYS:
            if getattr(jp, f) is None:
                assert getattr(tp, f) is None, (side, f)
                continue
            np.testing.assert_array_equal(
                getattr(tp, f).numpy(), np.asarray(jell.plan_host_array(jp, f)),
                err_msg=f"{side} {f}")
    for f in FG_ARRAYS:
        np.testing.assert_array_equal(getattr(tfg, f).numpy(),
                                      np.asarray(getattr(jfg, f)), err_msg=f)
    for agg in ("sum", "mean", "sym"):
        np.testing.assert_array_equal(tfg.dst_slot_scales[agg].numpy(),
                                      np.asarray(jfg.dst_slot_scales[agg]))
        np.testing.assert_array_equal(tfg.src_slot_scales[agg].numpy(),
                                      np.asarray(jfg.src_slot_scales[agg]))
    if kind == "powerlaw":  # hubs above MAX_BUDGET: both plans' stage 2
        assert tfg.dst_plan.buckets2 is not None
        assert tfg.src_plan.buckets2 is not None
        assert max(b for b, _ in tfg.dst_plan.buckets1) == 256

    # bench.py's draws after the graph (bench.py:157-168): efeats for the
    # SIREConv lane first, then feats and labels
    for edge in (False, True):
        r = copy.deepcopy(jrng)
        want_e = (r.normal(size=(jfg.e_pad, bench_torch.DE)).astype(np.float32)
                  if edge else None)
        want_f = r.normal(size=(jfg.n_pad, 128)).astype(np.float32)
        want_l = r.integers(0, 40, jfg.n_pad).astype(np.int32)
        feats, labels, efeats = bench_torch.bench_inputs(
            copy.deepcopy(trng), tfg, edge, "cpu")
        np.testing.assert_array_equal(feats.numpy(), want_f)
        np.testing.assert_array_equal(labels.numpy(), want_l)
        assert (efeats is None) == (not edge)
        if edge:
            np.testing.assert_array_equal(efeats.numpy(), want_e)


def _jax_sire_bench_model():
    """bench.py:139-154's SIREBenchModel, with dropout 0."""
    import flax.linen as nn
    from experiments.ogbn_arxiv.model import leaky_relu02
    from sir_gcn_tpu.models import Linear as SLinear
    from sir_gcn_tpu.models import SIREConv, get_norm

    hidden = bench_torch.HIDDEN

    class SIREBenchModel(nn.Module):
        @nn.compact
        def __call__(self, graph, feats, efeats, *, deterministic=True):
            drop = nn.Dropout(0.0, deterministic=deterministic)
            x = SLinear(hidden, name="embedding")(feats)
            for i in range(bench_torch.LAYERS):
                resid = x
                x = SIREConv(hidden, hidden, leaky_relu02, dropout=0.0,
                             agg_type="sym", name=f"conv_{i}")(
                    graph, x, efeats, deterministic=deterministic)
                x = get_norm("bn", True, hidden)(
                    graph, x, deterministic=deterministic)
                x = drop(leaky_relu02(x)) + resid
            return SLinear(bench_torch.NUM_CLASSES, name="readout")(x)

    return SIREBenchModel()


@pytest.mark.parametrize("edge", [False, True], ids=["sym", "sireconv"])
def test_bench_step_matches_jax(edge):
    import jax
    import jax.numpy as jnp
    from experiments.ogbn_arxiv.model import SIRModel as JSIRModel
    from sir_gcn_tpu.train import init_state
    from sir_gcn_tpu.train import make_adamw as j_make_adamw

    # the powerlaw graph: its hubs above MAX_BUDGET take both plans'
    # stage 2, and their sym scales are the smallest
    n, e_raw = 1000, 6900
    jrng, _, _, jfg = _jax_recipe("powerlaw", False, n, e_raw)
    trng, _, _, tfg = _port_recipe("powerlaw", False, n, e_raw)
    assert tfg.dst_plan.buckets2 is not None
    feats, labels, efeats = bench_torch.bench_inputs(trng, tfg, edge, "cpu")
    margs = (jfg, jnp.asarray(feats.numpy()))
    if edge:
        jm = _jax_sire_bench_model()
        margs += (jnp.asarray(efeats.numpy()),)
    else:
        jm = JSIRModel(hidden_dim=bench_torch.HIDDEN,
                       output_dim=bench_torch.NUM_CLASSES,
                       num_layers=bench_torch.LAYERS, dropout=0.0, norm="bn",
                       residual=True, feat_dropout=0.0, agg_type="sym")
    variables = jm.init(jax.random.PRNGKey(0), *margs)
    jlabels = jnp.asarray(labels.numpy(), jnp.int32)

    def loss_fn(params):  # bench.py:172-185
        logits, upd = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *margs, deterministic=False, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        ce = -jnp.take_along_axis(logp, jlabels[:, None], 1)[:, 0]
        return jnp.mean(ce), upd["batch_stats"]

    (loss_j, stats_j), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    tx = j_make_adamw(1e-2, 1e-3)
    state = init_state(variables, tx)
    updates, _ = tx.update(grads_j, state.opt_state, state.params)
    new_params = jax.tree_util.tree_map(lambda p, u: p + u, state.params,
                                        updates)

    tm = bench_torch.make_model(edge, dropout=0.0)
    load_jax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
    opt = make_adamw(tm.parameters(), 1e-2, 1e-3)
    loss = bench_torch.train_step(tm, opt, tfg, feats, labels, efeats)
    np.testing.assert_allclose(float(loss), float(loss_j), **FWD_TOL)

    slots = _sir_model_slots(tm)
    flat = lambda tree, root: {
        (root,) + tuple(k.key for k in path): v
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    grads = flat(grads_j, "params")
    stats = flat(stats_j, "batch_stats")
    assert set(grads) | set(stats) == set(slots)
    for key, g in grads.items():
        tensor, transpose = slots[key]
        have = tensor.grad.numpy()
        np.testing.assert_allclose(have.T if transpose else have,
                                   np.asarray(g), **BWD_TOL,
                                   err_msg="/".join(key))
    for key, v in stats.items():  # BN running mean and var
        np.testing.assert_allclose(slots[key][0].numpy(), np.asarray(v),
                                   **FWD_TOL, err_msg="/".join(key))
    # Adam's first step is about lr * sign(g), so an entry is compared only
    # where the gradient check above fixes g's sign: |g| above its atol
    for key, p in flat(new_params, "params").items():
        tensor, transpose = slots[key]
        have = tensor.detach().numpy()
        have = have.T if transpose else have
        keep = np.abs(np.asarray(grads[key])) > BWD_TOL["atol"]
        np.testing.assert_allclose(have[keep], np.asarray(p)[keep],
                                   **FWD_TOL, err_msg="/".join(key))


@pytest.mark.parametrize("kind,reorder,edge", [
    ("random", False, False), ("powerlaw", True, True)])
def test_run_record_on_cpu(kind, reorder, edge):
    details = {}
    record = bench_torch.run(kind, reorder, edge, windows=1, device="cpu",
                             n=N, e_raw=E_RAW, steps=2, details=details)
    keys = {"metric", "value", "unit", "step_ms", "plan_seconds", "device"}
    if kind == "powerlaw":
        keys.add("powerlaw_step_ms")
        assert record["powerlaw_step_ms"] == record["step_ms"]
    assert set(record) == keys
    assert record["metric"] == ("arxiv_sire_fused_edge_layers_per_s" if edge
                                else "arxiv_sir_fwd_bwd_edge_layers_per_s")
    assert record["unit"] == "edge-layers/s/chip"
    assert record["device"] == "cpu"
    edges = details["fg"].graph.num_edges
    assert record["value"] == pytest.approx(
        edges * bench_torch.LAYERS / (record["step_ms"] / 1e3))
    assert record["plan_seconds"] > 0
    assert len(details["losses"]) == 2 * 2
    assert np.isfinite(details["losses"]).all()
    assert details["launches_per_step"] == {}  # the CPU runs no kernel
    assert get_edge_dtype() is None  # the caller's edge dtype is restored
    if reorder:
        assert details["fg"].dst_plan.buckets2 is not None


def test_main_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main(["--graph", "powerlaw"])
    with pytest.raises(NotImplementedError, match="--remat"):
        bench_torch.main(["--cpu", "--remat"])



@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("edge", [False, True], ids=["sym", "sireconv"])
def test_run_on_card_launches_the_lane_kernels(cuda_device, edge):
    details = {}
    record = bench_torch.run("powerlaw", True, edge, windows=1,
                             device=cuda_device, n=N, e_raw=E_RAW, steps=2,
                             details=details)
    pair = (("ell_edge_act_reduce2", "ell_edge_src_bwd") if edge
            else ("ell_act_reduce2", "ell_src_bwd"))
    assert details["launches_per_step"] == dict.fromkeys(pair, 3.0)
    assert np.isfinite(details["losses"]).all()
    assert details["fg"].dst_plan.buckets2 is not None
    assert record["device"] != "cpu" and record["step_ms"] > 0
