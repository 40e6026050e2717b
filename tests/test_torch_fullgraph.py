"""The full-graph workloads of the port (heterophilous, wiki-cs) against
the JAX package's.

* the masked losses of ``fullgraph_harness`` against JAX's;
* ``sir_aggregate`` with the registry's erf-GELU on a FastGraph (sum,
  mean, sym, max; f32 and bf16 edges) against JAX's with ``gelu_exact``
  on its Pallas routes in interpret mode (its ``pallas_available``
  reports True), forward and every gradient;
* the heterophilous ``SIRModel`` (norms none, bn and ln, residual,
  ``use_bf16``, mean and max), the arxiv ``SIRModel`` with jumping
  knowledge and MLP residuals, ``GATModel`` and wiki-cs's
  ``GraphSIRModel``, each against flax through the weight bridge: logits
  and every parameter gradient in training mode (dropout 0, BatchNorm on
  batch statistics);
* three epochs of ``run_fullgraph_workload`` (an AdamW step and an eval
  each) against JAX's from the same weights;
* the README commands' parameter counts against JAX's;
* the entry points on ``--cpu`` at a tiny size, without a card, and with
  ``--mesh-devices 2``.

Tolerances are the JAX suite's: forward atol 2e-4 / rtol 1e-4, gradients
atol 3e-4 / rtol 1e-3; a weight gradient summed over every slot (W_R of
max) at atol 3e-4 plus 1e-5 of its largest entry. The ``cuda`` test runs
the heterophilous model on the card against the CPU. JAX is imported
inside the tests, so that the card's tests run where JAX is not
installed (``pytest -m cuda --noconftest tests/test_torch_fullgraph.py``).
"""

import copy
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sir_gcn_tpu_torch.experiments.fullgraph_harness as tharness
import sir_gcn_tpu_torch.experiments.heterophilous.model as thmodel
import sir_gcn_tpu_torch.experiments.heterophilous.train as thtrain
import sir_gcn_tpu_torch.experiments.ogbn_arxiv.model as tamodel
import sir_gcn_tpu_torch.experiments.wiki_cs.train as twtrain
import sir_gcn_tpu_torch.ops.ell as tell
import sir_gcn_tpu_torch.ops.message_passing as tmp
import sir_gcn_tpu_torch.parallel.multihost as multihost
from sir_gcn_tpu_torch import build_graph
from sir_gcn_tpu_torch.data import synthetic_node_classification
from sir_gcn_tpu_torch.experiments.common_models import GraphSIRModel
from sir_gcn_tpu_torch.train import param_count
from sir_gcn_tpu_torch.utils import load_jax_variables

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
H, N, E, D, C = 16, 60, 300, 12, 4


def gw_tol(want) -> dict:
    return dict(atol=3e-4 + 1e-5 * float(np.abs(np.asarray(want)).max()),
                rtol=1e-3)


@pytest.fixture(autouse=True)
def f32_edges():
    """The entry points set the process-wide edge dtype: keep each test at
    f32."""
    tmp.set_edge_dtype(None)
    yield
    tmp.set_edge_dtype(None)


@pytest.fixture
def edge_dtype():
    """Set both packages' edge dtype; back to f32 after the test."""
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.message_passing as jmp

    def use(dt):
        tmp.set_edge_dtype(torch.bfloat16 if dt == "bf16" else None)
        jmp.set_edge_dtype(jnp.bfloat16 if dt == "bf16" else None)
    yield use
    tmp.set_edge_dtype(None)
    jmp.set_edge_dtype(None)


@pytest.fixture(scope="module")
def graph():
    """Both packages' FastGraphs of one small graph with self loops (an
    in-degree above the chunk budget, so the plans take stage 2), its
    features, labels and train weights."""
    import sir_gcn_tpu.ops.ell as jell
    from sir_gcn_tpu import build_graph as j_build_graph

    rng = np.random.default_rng(0)
    src = np.concatenate([rng.integers(0, N, E), np.arange(N)])
    dst = np.concatenate([rng.integers(0, N, E), np.arange(N)])
    dst[:40] = 0  # node 0 takes 40+ in-edges
    tfg = tell.build_fast_graph(build_graph(src, dst, N, pad_multiple=128),
                                max_budget=16)
    jfg = jell.build_fast_graph(j_build_graph(src, dst, N, pad_multiple=128),
                                max_budget=16)
    n_pad = tfg.n_pad
    feats = np.zeros((n_pad, D), np.float32)
    feats[:N] = rng.normal(size=(N, D))
    labels = np.zeros(n_pad, np.int32)
    labels[:N] = rng.integers(0, C, N)
    w = np.zeros(n_pad, np.float32)
    w[:N] = rng.random(N) < 0.6
    return SimpleNamespace(tfg=tfg, jfg=jfg, feats=feats, labels=labels,
                           w=w, n_pad=n_pad)


# ----------------------------------------------------------------------
# The masked losses
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ce", "bce", "bce_flat"])
def test_masked_losses_match_jax(kind):
    import jax.numpy as jnp
    from experiments import fullgraph_harness as jharness

    rng = np.random.default_rng(1)
    w = (rng.random(50) < 0.5).astype(np.float32)
    if kind == "ce":
        logits = rng.normal(size=(50, 7)).astype(np.float32) * 3
        labels = rng.integers(0, 7, 50).astype(np.int32)
        got = tharness.masked_ce(*map(torch.from_numpy, (logits, labels, w)))
        want = jharness.masked_ce(*map(jnp.asarray, (logits, labels, w)))
    else:
        shape = (50, 1) if kind == "bce" else (50,)
        logits = rng.normal(size=shape).astype(np.float32) * 8
        labels = (rng.random(50) < 0.3).astype(np.float32)
        got = tharness.masked_bce_logits(
            *map(torch.from_numpy, (logits, labels, w)))
        want = jharness.masked_bce_logits(
            *map(jnp.asarray, (logits, labels, w)))
    np.testing.assert_allclose(float(got), float(want), **FWD_TOL)
    empty = torch.zeros(50)  # no weight: a sum over max(0, 1)
    assert float(tharness.masked_ce(torch.zeros(50, 3),
                                    torch.zeros(50, dtype=torch.int32),
                                    empty)) == 0.0


# ----------------------------------------------------------------------
# sir_aggregate with erf-GELU on the kernels' routes
# ----------------------------------------------------------------------

@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX package's routes as on its accelerator: ``pallas_available``
    True, and the Pallas factories in interpret mode."""
    import sir_gcn_tpu.ops.ell as jell
    import sir_gcn_tpu.ops.pallas as jpallas

    monkeypatch.setattr(jpallas, "pallas_available", lambda: True)
    for name in ("make_ell_sir_aggregate_pallas",
                 "make_ell_sir_aggregate_max_pallas"):
        monkeypatch.setattr(jell, name, functools.partial(
            getattr(jell, name), interpret=True))


@pytest.mark.parametrize("agg,dt", [("sum", "f32"), ("mean", "bf16"),
                                    ("sym", "f32"), ("sym", "bf16"),
                                    ("max", "f32"), ("max", "bf16")])
def test_gelu_aggregate_matches_jax_pallas(graph, agg, dt, jax_pallas,
                                           edge_dtype):
    import jax
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.message_passing as jmp
    from experiments.heterophilous.model import gelu_exact

    edge_dtype(dt)
    rng = np.random.default_rng(2)
    o = 12 if agg == "max" else H
    x = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)
    vals = [x(graph.n_pad, H, k=2.0), x(graph.n_pad, H, k=2.0)]
    if agg == "max":
        vals += [x(H, o, k=H ** -0.5), x(o)]
    gw = x(graph.n_pad, o)

    ts = [torch.from_numpy(v.copy()).requires_grad_() for v in vals]
    kw = dict(w_relation=ts[2], b_relation=ts[3]) if agg == "max" else {}
    out = tmp.sir_aggregate(graph.tfg, ts[0], ts[1], tell.gelu(), agg, **kw)
    (out * torch.from_numpy(gw)).sum().backward()

    def loss(*v):
        jkw = dict(w_relation=v[2], b_relation=v[3]) if agg == "max" else {}
        y = jmp.sir_aggregate(graph.jfg, v[0], v[1], gelu_exact, agg, **jkw)
        return jnp.sum(y * jnp.asarray(gw)), y

    (_, want), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(vals))), has_aux=True))(
        *map(jnp.asarray, vals))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    for i, (t, g) in enumerate(zip(ts, grads)):
        tol = gw_tol(g) if i == 2 else BWD_TOL
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **tol,
                                   err_msg=f"input {i}")


# ----------------------------------------------------------------------
# The models against flax through the bridge
# ----------------------------------------------------------------------

def _train_forward_and_grads(tm, jm, variables, graph, feats, loss="ce"):
    """Port and JAX logits in training mode (dropout 0) and the
    gradients of the masked loss; returns ((logits, grads by flax path),
    (logits, grads)) with the JAX grads flattened to '/'-joined keys."""
    import jax
    import jax.numpy as jnp
    from experiments import fullgraph_harness as jharness
    from sir_gcn_tpu_torch.utils.convert import _flatten, _slots

    labels, w = graph.labels, graph.w
    jloss = (jharness.masked_ce if loss == "ce"
             else jharness.masked_bce_logits)
    tloss = tharness.masked_ce if loss == "ce" else tharness.masked_bce_logits
    if loss != "ce":
        labels = (labels % 2).astype(np.float32)
    load_jax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
    tm.train()
    logits = tm(graph.tfg, torch.from_numpy(feats))
    tloss(logits, torch.from_numpy(labels), torch.from_numpy(w)).backward()
    slots = _slots(tm)
    tgrads = {"/".join(k[1:]): (t.grad.numpy().T if tr else t.grad.numpy())
              for k, (t, tr) in slots.items() if k[0] == "params"}

    stats = {k: v for k, v in variables.items() if k != "params"}

    def lf(p):
        y, _ = jm.apply({"params": p, **stats}, graph.jfg,
                        jnp.asarray(feats), deterministic=False,
                        mutable=["batch_stats"])
        return jloss(y, jnp.asarray(labels), jnp.asarray(w)), y

    (_, jlogits), jgrads = jax.value_and_grad(lf, has_aux=True)(
        variables["params"])
    jgrads = {"/".join(k): np.asarray(v)
              for k, v in _flatten(jgrads).items()}
    return (logits.detach().numpy(), tgrads), (np.asarray(jlogits), jgrads)


def _assert_model_close(got, want, weight_sums=()):
    (logits, tgrads), (jlogits, jgrads) = got, want
    np.testing.assert_allclose(logits, jlogits, **FWD_TOL)
    assert set(tgrads) == set(jgrads)
    for k, g in jgrads.items():
        tol = gw_tol(g) if any(s in k for s in weight_sums) else BWD_TOL
        np.testing.assert_allclose(tgrads[k], g, **tol, err_msg=k)


HETERO = [("none", False, False, "mean"), ("bn", True, False, "mean"),
          ("ln", True, True, "mean"), ("ln", True, True, "max"),
          ("bn", False, True, "sym"), ("none", True, False, "sum")]


@pytest.mark.parametrize("norm,residual,bf16,agg", HETERO)
def test_hetero_model_matches_jax(graph, norm, residual, bf16, agg):
    import jax
    import jax.numpy as jnp
    from experiments.heterophilous.model import SIRModel as JSIRModel

    kw = dict(num_layers=2, norm=norm, residual=residual, agg_type=agg,
              use_bf16=bf16)
    jm = JSIRModel(hidden_dim=H, output_dim=C, **kw)
    variables = jm.init(jax.random.PRNGKey(3), graph.jfg,
                        jnp.asarray(graph.feats))
    tm = thmodel.SIRModel(D, H, C, **kw)
    got, want = _train_forward_and_grads(tm, jm, variables, graph,
                                         graph.feats)
    _assert_model_close(got, want, weight_sums=("relation_kernel",))


@pytest.mark.parametrize("jk,resid_layers", [(True, 1), (True, 0),
                                             (False, 2)])
def test_arxiv_sir_model_jk_resid_matches_jax(graph, jk, resid_layers):
    import jax
    import jax.numpy as jnp
    from experiments.ogbn_arxiv.model import SIRModel as JSIRModel

    kw = dict(num_layers=2, norm="bn", residual=True, agg_type="sym",
              jumping_knowledge=jk, resid_layers=resid_layers,
              readout_layers=2)
    jm = JSIRModel(hidden_dim=H, output_dim=C, **kw)
    variables = jm.init(jax.random.PRNGKey(4), graph.jfg,
                        jnp.asarray(graph.feats))
    tm = tamodel.SIRModel(D, H, C, **kw)
    assert (len(tm.resids) > 0) == (resid_layers > 0)
    got, want = _train_forward_and_grads(tm, jm, variables, graph,
                                         graph.feats)
    _assert_model_close(got, want)


@pytest.mark.parametrize("jk,heads,residual", [(True, 2, True),
                                               (False, 1, False)])
def test_gat_model_matches_jax(graph, jk, heads, residual):
    import jax
    import jax.numpy as jnp
    from experiments.ogbn_arxiv.model import GATModel as JGATModel

    kw = dict(num_layers=2, norm="bn", jumping_knowledge=jk,
              residual=residual)
    jm = JGATModel(hidden_dim=H, output_dim=C, num_heads=heads, **kw)
    variables = jm.init(jax.random.PRNGKey(5), graph.jfg,
                        jnp.asarray(graph.feats))
    tm = tamodel.GATModel(D, H, C, num_heads=heads, **kw)
    got, want = _train_forward_and_grads(tm, jm, variables, graph,
                                         graph.feats)
    _assert_model_close(got, want)


def test_wiki_sir_model_matches_jax(graph):
    """wiki-cs's SIR model: GraphSIRModel on the raw features, JK, MLP
    residuals, unpooled, on a FastGraph."""
    import jax
    import jax.numpy as jnp
    from experiments.common_models import GraphSIRModel as JGraphSIRModel

    kw = dict(num_layers=2, norm="none", jumping_knowledge=True,
              residual=True, resid_layers=1, agg_type="mean",
              pool_after_readout=False)
    jm = JGraphSIRModel(encoder=lambda mdl, f: f, hidden_dim=H,
                        output_dim=C, **kw)
    variables = jm.init(jax.random.PRNGKey(6), graph.jfg,
                        jnp.asarray(graph.feats))
    tm = GraphSIRModel(torch.nn.Identity(), D, H, C, **kw)
    got, want = _train_forward_and_grads(tm, jm, variables, graph,
                                         graph.feats)
    _assert_model_close(got, want)


def test_bridge_rejects_a_wrong_tree(graph):
    import jax
    import jax.numpy as jnp
    from experiments.heterophilous.model import SIRModel as JSIRModel

    jm = JSIRModel(hidden_dim=H, output_dim=C, num_layers=2, norm="ln")
    tree = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), graph.jfg, jnp.asarray(graph.feats)))
    del tree["params"]["output_linear"]["Dense_0"]["bias"]
    with pytest.raises(KeyError, match="output_linear/Dense_0/bias"):
        load_jax_variables(thmodel.SIRModel(D, H, C, num_layers=2,
                                            norm="ln"), tree)


# ----------------------------------------------------------------------
# The harness: three epochs against JAX's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("binary", [False, True])
def test_three_epochs_match_jax(graph, binary):
    """Three epochs of run_fullgraph_workload (each an AdamW step at the
    warmup's rate, then an eval of every split) from the same weights:
    the best-by-val-loss epoch's losses and metrics, with erf-GELU and
    LayerNorm."""
    import jax
    import jax.numpy as jnp
    from experiments import fullgraph_harness as jharness
    from experiments.heterophilous.model import SIRModel as JSIRModel
    from sir_gcn_tpu.train import set_seed as j_set_seed
    from sir_gcn_tpu.train.metrics import accuracy, roc_auc

    args = SimpleNamespace(lr=3e-2, wd=1e-3, epochs=3, factor=0.5,
                           patience=10, log_every=1, l1=0.0, l2=0.0,
                           mesh_devices=0)
    rng = np.random.default_rng(7)
    masks = tuple((rng.random(graph.n_pad) < 0.4).astype(np.float32)
                  * (np.arange(graph.n_pad) < N) for _ in range(3))
    out = 1 if binary else C
    labels = ((graph.labels % 2).astype(np.float32) if binary
              else graph.labels)
    if binary:
        loss = dict(j=jharness.masked_bce_logits,
                    t=tharness.masked_bce_logits)
        metric = lambda lg, lb: roc_auc(lg[:, 0], lb)
    else:
        loss = dict(j=jharness.masked_ce, t=tharness.masked_ce)
        metric = lambda lg, lb: accuracy(lg, lb.astype(np.int64))
    # ln, not bn: under bn a bias that shifts every node alike has no
    # gradient but rounding, and AdamW's first steps move it by +-lr
    # whatever its sign, so the two packages part at their first step
    kw = dict(num_layers=2, norm="ln", residual=True, agg_type="mean")
    jm = JSIRModel(hidden_dim=H, output_dim=out, **kw)
    key = j_set_seed(0)
    _, ik = jax.random.split(key)  # the harness's init key
    variables = jm.init(ik, graph.jfg, jnp.asarray(graph.feats))
    tm = thmodel.SIRModel(D, H, out, **kw)
    load_jax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))

    want = jharness.run_fullgraph_workload(
        model=jm, graph=graph.jfg, feats=graph.feats, labels=labels,
        masks=masks, args=args, seed=0, loss_fn=loss["j"], metric_fn=metric)
    stats = {}
    got = tharness.run_fullgraph_workload(
        model=tm, graph=graph.tfg, feats=graph.feats, labels=labels,
        masks=masks, args=args, seed=0, device=torch.device("cpu"),
        loss_fn=loss["t"], metric_fn=metric, stats=stats, time_steps=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **BWD_TOL, err_msg=k)
    assert stats["epochs"] == 3 and len(stats["step_ms"]) == 3
    assert len(stats["eval_ms"]) == 3 and stats["seconds"] > 0


# ----------------------------------------------------------------------
# The README commands' sizes, and the entry points
# ----------------------------------------------------------------------

def test_readme_param_counts_match_jax(graph):
    """The README commands' models at their defaults: heterophilous
    minesweeper (hidden 512, 5 layers, 128 features, one logit) with and
    without ``--agg-type max``, wiki-cs ``--jumping-knowledge
    --resid-layers 1`` (hidden 64, 4 layers, 300 features, 10 classes) and
    its ``--model GAT``."""
    import jax
    import jax.numpy as jnp
    from experiments.common_models import GraphSIRModel as JGraphSIRModel
    from experiments.heterophilous.model import SIRModel as JSIRModel
    from experiments.ogbn_arxiv.model import GATModel as JGATModel
    from sir_gcn_tpu.train import param_count as j_param_count

    hp = thtrain._parser().parse_args(["--dataset", "minesweeper",
                                       "--use-amp"])
    wp = twtrain._parser().parse_args(["--jumping-knowledge",
                                       "--resid-layers", "1"])
    gp = twtrain._parser().parse_args(["--jumping-knowledge",
                                       "--resid-layers", "1", "--model",
                                       "GAT"])
    cases = []
    for agg in ("mean", "max"):
        hp.agg_type = agg
        cases.append((thtrain.build_model(hp, 128, 1), JSIRModel(
            hidden_dim=512, output_dim=1, num_layers=5, agg_type=agg,
            use_bf16=True), 128))
    cases.append((twtrain.build_model(wp, 300, 10), JGraphSIRModel(
        encoder=lambda mdl, f: f, hidden_dim=64, output_dim=10,
        num_layers=4, jumping_knowledge=True, resid_layers=1,
        agg_type="mean", pool_after_readout=False), 300))
    cases.append((twtrain.build_model(gp, 300, 10), JGATModel(
        hidden_dim=64, output_dim=10, num_layers=4,
        jumping_knowledge=True), 300))
    for tm, jm, d in cases:
        feats = jnp.zeros((graph.n_pad, d), jnp.float32)
        variables = jm.init(jax.random.PRNGKey(0), graph.jfg, feats)
        assert param_count(tm) == j_param_count(variables["params"]), (
            type(tm).__name__)
    assert param_count(cases[0][0]) == 5_317_121  # minesweeper, mean


TINY = ["--synthetic-nodes", "120", "--synthetic-edges", "500", "--epochs",
        "2", "--nsplits", "1", "--nruns", "1", "--log-every", "1"]


@pytest.mark.parametrize("flags", [
    ["--dataset", "minesweeper", "--use-amp", "--nhidden", "16",
     "--nlayers", "2"],
    ["--dataset", "roman-empire", "--agg-type", "max", "--nhidden", "16",
     "--nlayers", "2", "--norm", "ln", "--residual", "--edge-bf16"],
    ["--dataset", "amazon-ratings", "--no-fast-path", "--nhidden", "8",
     "--nlayers", "1", "--add-self-loop"],
])
def test_hetero_entry_point_on_cpu(flags, capsys):
    stats = []
    vals, tests = thtrain.main(["--cpu"] + flags + TINY, stats=stats,
                               time_steps=True)
    assert len(vals) == len(tests) == 1 and np.isfinite(vals + tests).all()
    assert len(stats[0]["step_ms"]) == 2
    out = capsys.readouterr().out
    assert "Epoch 0002" in out and "synthetic stand-in" in out
    assert ("ROC-AUC" in out) == ("minesweeper" in flags)


@pytest.mark.parametrize("flags", [
    ["--jumping-knowledge", "--resid-layers", "1", "--residual",
     "--nhidden", "8", "--nlayers", "2", "--edge-dropout", "0.2",
     "--add-reverse-edge", "--add-self-loop"],
    ["--model", "GAT", "--jumping-knowledge", "--nhidden", "8",
     "--nlayers", "2", "--nheads", "2", "--attn-dropout", "0.1"],
])
def test_wiki_entry_point_on_cpu(flags, capsys):
    vals, tests = twtrain.main(["--cpu"] + flags + TINY)
    assert len(vals) == 1 and 0.0 <= vals[0] <= 1.0
    assert "Runned 1 x 1 times" in capsys.readouterr().out


@pytest.mark.parametrize("main", [thtrain.main, twtrain.main])
def test_fullgraph_gspmd_matches_single_device(main, monkeypatch):
    """``--dist-path gspmd`` on two gloo ranks trains on the row-sharded
    CSR and matches the single-device ``--no-fast-path`` run (a hung
    collective fails in a minute)."""
    monkeypatch.setattr(multihost, "DEFAULT_TIMEOUT_S", 60.0)
    monkeypatch.setattr(multihost, "DEFAULT_DEADLINE_S", 240.0)
    argv = ["--cpu", "--nhidden", "8", "--nlayers", "1", "--dropout",
            "0.2"] + TINY
    val_1, test_1 = main(argv + ["--no-fast-path"])
    val_2, test_2 = main(argv + ["--mesh-devices", "2", "--dist-path",
                                 "gspmd"])
    for a, b in zip(val_2 + test_2, val_1 + test_1):
        assert abs(a - b) < 1e-6, (val_1, test_1, val_2, test_2)


@pytest.mark.parametrize("main", [thtrain.main, twtrain.main])
def test_fullgraph_entry_points_raise(main):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(TINY)


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("agg", ["mean", "max"])
def test_hetero_model_card_against_cpu(cuda_device, agg):
    """The heterophilous SIRModel (2 layers, hidden 64, ln, residual,
    use_bf16) one forward and backward on the card (its GELU aggregates
    on the kernels) against the CPU (the plain versions), from the same
    weights."""
    from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts

    d = synthetic_node_classification(num_nodes=500, num_edges=4000,
                                      feat_dim=32, num_classes=2, seed=0)
    runs = {}
    model = thmodel.SIRModel(32, 64, 1, num_layers=2, norm="ln",
                             residual=True, agg_type=agg, use_bf16=True,
                             generator=torch.Generator().manual_seed(0))
    for dev in (torch.device("cpu"), cuda_device):
        fg = tell.build_fast_graph(build_graph(d.src, d.dst, 500,
                                               device=dev))
        feats = torch.zeros((fg.n_pad, 32), device=dev)
        feats[:500] = torch.from_numpy(d.feat).to(dev)
        m = copy.deepcopy(model).to(dev).train()
        reset_launch_counts()
        out = m(fg, feats)
        out.square().sum().backward()
        launched = {k for k, v in LAUNCHES.items() if v}
        runs[dev.type] = (out.detach().cpu(), {
            k: p.grad.cpu() for k, p in m.named_parameters()}, launched)
    want = ({"ell_max_fwd", "ell_max_wincount", "ell_max_bwd",
             "ell_scaled_reduce"} if agg == "max"
            else {"ell_act_reduce2", "ell_src_bwd"})
    assert runs["cpu"][2] == set() and runs["cuda"][2] == want
    torch.testing.assert_close(runs["cuda"][0], runs["cpu"][0], **FWD_TOL)
    for k, g in runs["cpu"][1].items():
        torch.testing.assert_close(runs["cuda"][1][k], g,
                                   **gw_tol(g.numpy()), msg=k)
