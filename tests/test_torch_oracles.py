"""The DictionaryLookup and HeteroEdgeCount oracles of the port
(``sir_gcn_tpu_torch/experiments/{dictionary_lookup,hetero_edge_count}``,
with ``data/synthetic.py``, ``data/batching.py``, ``ops/pool.py``,
``train/metrics.py`` and the engine's ``EpochDriver``) against the JAX
package's: equal datasets and batches, the twelve models' outputs and
gradients with the flax weights carried across, three AdamW steps of
each SIR model, the parameter counts of the paper's configurations, and
the entry points on the CPU at a tiny size (DictionaryLookup GCN at
exactly chance, SIR at 1.0 with the JAX suite's oracle settings).

Tolerances are the JAX suite's: forward atol 2e-4 / rtol 1e-4, gradients
atol 3e-4 / rtol 1e-3. JAX is imported inside the tests, so the card
tests collect without flax.
"""

import copy
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sir_gcn_tpu_torch.experiments.dictionary_lookup.model as tdl_model
import sir_gcn_tpu_torch.experiments.dictionary_lookup.train as tdl
import sir_gcn_tpu_torch.experiments.hetero_edge_count.model as thec_model
import sir_gcn_tpu_torch.experiments.hetero_edge_count.train as thec
from sir_gcn_tpu_torch import batch_graphs
from sir_gcn_tpu_torch.data import (
    DictionaryLookupDataset,
    GraphCollection,
    HeteroEdgeCountDataset,
)
from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
from sir_gcn_tpu_torch.ops.pool import avg_pool, get_pool, sum_pool
from sir_gcn_tpu_torch.train import (
    EpochDriver,
    make_adamw,
    metrics,
    param_count,
)
from sir_gcn_tpu_torch.utils import load_jax_variables
from sir_gcn_tpu_torch.utils.convert import _slots

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
MODELS = ["SIR", "GCN", "SAGE", "GAT", "GIN", "PNA"]
GRAPH_FIELDS = ("src", "dst", "edge_perm", "row_ptr", "node_mask",
                "edge_mask", "graph_mask", "node2graph", "in_deg", "out_deg")


@pytest.fixture(autouse=True)
def f32_edges():
    """The trainers set the process-wide edge dtype: keep each test at f32."""
    set_edge_dtype(None)
    yield
    set_edge_dtype(None)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these graphs are tiny, and under the suite's
    parallel workers torch's default of one thread a core leaves every
    worker's threads waiting on each other (the 120-epoch oracle run took
    194 s that way, some 6 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_graphs_equal(jg, tg):
    assert (jg.num_nodes, jg.num_edges, jg.num_graphs) == (
        tg.num_nodes, tg.num_edges, tg.num_graphs)
    for name in GRAPH_FIELDS:
        np.testing.assert_array_equal(tg.host[name],
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)


def _flat(tree, prefix=("params",)):
    import jax

    return {prefix + tuple(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_grads_match(model, grads_j):
    slots = {k: v for k, v in _slots(model).items() if k[0] == "params"}
    flat = _flat(grads_j)
    assert set(flat) == set(slots)
    for key, g in flat.items():
        tensor, transpose = slots[key]
        have = tensor.grad.numpy()
        np.testing.assert_allclose(have.T if transpose else have, g,
                                   **BWD_TOL, err_msg="/".join(key))


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("seed", [0, 1])
def test_dictionary_lookup_dataset_equals_jax(seed):
    from sir_gcn_tpu.data import DictionaryLookupDataset as JDL

    j = JDL(6, 20, rng=np.random.default_rng(seed))
    t = DictionaryLookupDataset(6, 20, rng=np.random.default_rng(seed))
    for name in ("src", "dst", "feats", "labels", "key_mask"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
        assert getattr(t, name).dtype == getattr(j, name).dtype
    assert (t.graph_num_nodes, t.empty_id, len(t)) == (
        j.graph_num_nodes, j.empty_id, len(j))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_hetero_edge_count_dataset_equals_jax(seed, normalize):
    from sir_gcn_tpu.data import HeteroEdgeCountDataset as JHEC

    j = JHEC(12, 3, 30, normalize=normalize, rng=np.random.default_rng(seed))
    t = HeteroEdgeCountDataset(12, 3, 30, normalize=normalize,
                               rng=np.random.default_rng(seed))
    assert len(t) == len(j) == 30
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.labels.dtype == j.labels.dtype
    for (ts, td, tn), (js, jd, jn), tf, jf in zip(t.graphs, j.graphs,
                                                  t.feats, j.feats):
        assert tn == jn
        for a, b in ((ts, js), (td, jd), (tf, jf)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def _hec_collections(nodes=7, classes=3, samples=9, seed=0):
    from sir_gcn_tpu.data import HeteroEdgeCountDataset as JHEC
    from sir_gcn_tpu.data.batching import GraphCollection as JColl

    ds = HeteroEdgeCountDataset(nodes, classes, samples,
                                rng=np.random.default_rng(seed))
    jds = JHEC(nodes, classes, samples, rng=np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 1)
    edge_feats = [rng.normal(size=(len(g[0]), 2)).astype(np.float32)
                  for g in ds.graphs]
    node_labels = [rng.integers(0, 2, g[2]) for g in ds.graphs]
    kw = dict(node_feats=ds.feats, edge_feats=edge_feats, labels=ds.labels,
              node_labels=node_labels)
    return ds, GraphCollection(ds.graphs, **kw), JColl(jds.graphs, **kw)


def test_collate_equals_jax_with_a_partial_last_batch():
    _, coll, jcoll = _hec_collections()
    assert coll.bucket_shape(4) == jcoll.bucket_shape(4)
    order = np.random.default_rng(3).permutation(9)
    tb = list(coll.loader(order, 4))
    jb = list(jcoll.loader(order, 4))
    assert len(tb) == len(jb) == 3 and tb[-1]["graph"].num_graphs == 1
    for t, j in zip(tb, jb):
        assert set(t) == set(j)
        assert_graphs_equal(j["graph"], t["graph"])
        for k in set(t) - {"graph"}:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
            assert t[k].dtype == j[k].dtype, k
    np.testing.assert_array_equal(tb[-1]["graph_weights"],
                                  [1, 0, 0, 0, 0])
    assert len(list(coll.loader(order, 4, drop_last=True))) == 2


def test_pools_match_jax():
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu import batch_graphs as j_batch_graphs
    from sir_gcn_tpu.ops.pool import avg_pool as j_avg_pool
    from sir_gcn_tpu.ops.pool import sum_pool as j_sum_pool

    graphs = [(np.array([0, 1]), np.array([1, 0]), 3),
              (np.array([0]), np.array([0]), 1),
              (np.array([0, 2]), np.array([1, 1]), 4)]
    kw = dict(n_pad=16, e_pad=8, g_pad=5)
    jg, tg = j_batch_graphs(graphs, **kw), batch_graphs(graphs, **kw)
    x = np.random.default_rng(0).normal(size=(16, 3, 2)).astype(np.float32)
    gw = np.random.default_rng(1).normal(size=(5, 3, 2)).astype(np.float32)
    for tpool, jpool, name in ((sum_pool, j_sum_pool, "sum"),
                               (avg_pool, j_avg_pool, "mean")):
        assert get_pool(name) is tpool
        out_j, vjp = jax.vjp(lambda v: jpool(jg, v), jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        out = tpool(tg, xt)
        (out * torch.from_numpy(gw)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                                   **FWD_TOL)
        np.testing.assert_allclose(xt.grad.numpy(),
                                   np.asarray(vjp(jnp.asarray(gw))[0]),
                                   **BWD_TOL)
    with pytest.raises(NotImplementedError, match="max"):
        get_pool("max")


def test_metrics_match_jax_on_ties_and_an_empty_class():
    from sir_gcn_tpu.train import metrics as jmetrics

    rng = np.random.default_rng(0)
    logits = np.round(rng.normal(size=(40, 4)), 1)  # ties in argmax too
    labels = rng.integers(0, 3, 40)                 # class 3 never occurs
    scores = np.round(rng.normal(size=40), 1)       # tied scores
    binary = rng.integers(0, 2, 40)
    pred, target = rng.normal(size=40), rng.normal(size=40)
    assert metrics.accuracy(logits, labels) == jmetrics.accuracy(
        logits, labels)
    assert metrics.balanced_accuracy(logits, labels, 4) == \
        jmetrics.balanced_accuracy(logits, labels, 4)
    assert metrics.roc_auc(scores, binary) == jmetrics.roc_auc(scores,
                                                               binary)
    assert math.isnan(metrics.roc_auc(scores, np.ones(40)))
    assert math.isnan(jmetrics.roc_auc(scores, np.ones(40)))
    assert metrics.mae(pred, target) == jmetrics.mae(pred, target)
    assert metrics.mse(pred, target) == jmetrics.mse(pred, target)


def test_epoch_driver_matches_jax_over_warmup_and_plateau():
    from sir_gcn_tpu.train import EpochDriver as JDriver

    losses = [5.0, 4.0, 4.0, 4.0, 4.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
              2.9999, 3.0, 3.0, 3.0]
    kw = dict(epochs=len(losses), warmup=4, factor=0.5, patience=2,
              log_every=5)
    t, j = EpochDriver(**kw), JDriver(**kw)
    seen = []
    for epoch, loss in enumerate(losses, start=1):
        seen.append(t.lr_scale(epoch))
        assert t.lr_scale(epoch) == j.lr_scale(epoch)
        assert t.should_log(epoch) == j.should_log(epoch)
        t.plateau_step(epoch, loss)
        j.plateau_step(epoch, loss)
        assert t.consider(loss, epoch) == j.consider(loss, epoch)
    assert seen[:4] == [0.25, 0.5, 0.75, 1.0]
    assert min(seen) < 0.5  # the plateau cut twice after the warmup
    assert (t.best_metric, t.best_payload) == (j.best_metric, j.best_payload)


# ---------------------------------------------------------- the models

def _dl_batch(n=4, samples=6, batch=4, seed=0):
    """The port's template and first padded batch, and JAX's."""
    from experiments.dictionary_lookup import train as jtrain

    ds = DictionaryLookupDataset(n, samples, rng=np.random.default_rng(seed))
    template = tdl.make_batcher(ds, batch)
    jtemplate = jtrain.make_batcher(ds, batch)[0]
    sel = np.arange(3)  # a partial batch
    f, lab, w = tdl.pad_batch(ds.feats[sel], ds.labels[sel], batch, n,
                              template.n_pad)
    return SimpleNamespace(ds=ds, template=template, jtemplate=jtemplate,
                           feats=f, labels=lab, weights=w,
                           jbatch=jtrain.pad_batch(ds.feats[sel],
                                                   ds.labels[sel], batch, n,
                                                   template.n_pad))


def test_dl_batcher_equals_jax():
    b = _dl_batch()
    assert_graphs_equal(b.jtemplate, b.template)
    for have, want in zip((b.feats, b.labels, b.weights), b.jbatch):
        np.testing.assert_array_equal(have, want)
        assert have.dtype == want.dtype


def _models(harness, name, dims, **kw):
    """(flax model, port model) of one harness."""
    from experiments.dictionary_lookup import model as jdl_model
    from experiments.hetero_edge_count import model as jhec_model

    jmods = jdl_model if harness == "dl" else jhec_model
    tmods = tdl_model if harness == "dl" else thec_model
    jcls = getattr(jmods, f"{name}Model")
    inp, hid, out = dims
    if name != "SIR":
        kw = dict(kw, num_heads=2)
    return (jcls(input_dim=inp, hidden_dim=hid, output_dim=out, **kw),
            tmods.MODELS[name](inp, hid, out,
                               generator=torch.Generator().manual_seed(0),
                               **kw))


def _dl_loss_j(jm, jg, feats, labels, weights):
    import jax
    import jax.numpy as jnp

    def loss(p):
        logits = jm.apply({"params": p}, jg, jnp.asarray(feats))
        logp = jax.nn.log_softmax(logits)
        ce = -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], 1)[:, 0]
        w = jnp.asarray(weights)
        return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0), logits

    return loss


def _hec_loss_j(jm, jg, feats, labels, weights):
    import jax.numpy as jnp

    def loss(p):
        pred = jm.apply({"params": p}, jg, jnp.asarray(feats))
        se = jnp.square(jnp.asarray(labels) - pred[:, 0])
        w = jnp.asarray(weights)
        return jnp.sum(se * w) / jnp.maximum(jnp.sum(w), 1.0), pred

    return loss


def _setup(harness, name, layers=2):
    """The flax and port models of one harness with the same weights, on
    one batch: (jm, tm, variables, (jax graph, port graph), numpy feats,
    labels, weights, jax loss_fn, port loss_fn)."""
    import jax
    import jax.numpy as jnp

    if harness == "dl":
        b = _dl_batch()
        graphs = (b.jtemplate, b.template)
        arrays = (b.feats, b.labels, b.weights)
        jm, tm = _models("dl", name, (4, 8, 4), num_layers=layers)
        loss_j = _dl_loss_j(jm, b.jtemplate, *arrays)
    else:
        ds, coll, jcoll = _hec_collections(nodes=6, classes=3, samples=7)
        idx = np.array([4, 1, 6])
        tb, jb = coll.collate(idx, 4), jcoll.collate(idx, 4)
        graphs = (jb["graph"], tb["graph"])
        arrays = (tb["node_feats"], tb["labels"], tb["graph_weights"])
        jm, tm = _models("hec", name, (3, 8, 1), num_layers=layers)
        loss_j = _hec_loss_j(jm, jb["graph"], *arrays)
    variables = jm.init(jax.random.PRNGKey(1), graphs[0],
                        jnp.asarray(arrays[0]))
    load_jax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
    return SimpleNamespace(jm=jm, tm=tm, variables=variables, graphs=graphs,
                           arrays=arrays, loss_j=loss_j)


def _port_loss(harness, tm, graph, feats, labels, weights):
    out = tm(graph, torch.from_numpy(feats))
    if harness == "dl":
        return tdl.weighted_ce(out, torch.from_numpy(labels).long(),
                               torch.from_numpy(weights)), out
    return thec.weighted_mse(out[:, 0], torch.from_numpy(labels),
                             torch.from_numpy(weights)), out


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("harness", ["dl", "hec"])
def test_model_matches_flax(harness, name):
    """Two layers (GAT with two heads), on a batch with a padding graph:
    the output on every row, the loss and every weight gradient."""
    import jax

    s = _setup(harness, name)
    (loss_j, out_j), grads = jax.jit(jax.value_and_grad(
        s.loss_j, has_aux=True))(s.variables["params"])
    s.tm.train()
    loss, out = _port_loss(harness, s.tm, s.graphs[1], *s.arrays)
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **FWD_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               **FWD_TOL)
    assert_grads_match(s.tm, grads)


@pytest.mark.parametrize("harness", ["dl", "hec"])
def test_three_adamw_steps_match_jax(harness):
    """Three AdamW steps of the SIR model (two layers, so DL's shared σ
    serves both) on three batches, from the same weights: each step's
    loss and the final weights. Adam's first step is about lr * sign(g),
    so entries whose gradient at some step is under 1e-6 are left out."""
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.train import init_state
    from sir_gcn_tpu.train import make_adamw as j_make_adamw

    lr = 1e-2
    if harness == "dl":
        ds = DictionaryLookupDataset(5, 12, rng=np.random.default_rng(2))
        template = tdl.make_batcher(ds, 4)
        batches = [tdl.pad_batch(ds.feats[s:s + 4], ds.labels[s:s + 4], 4,
                                 5, template.n_pad) for s in (0, 4, 8)]
        graphs = [template] * 3
        from experiments.dictionary_lookup import train as jtrain
        jgraphs = [jtrain.make_batcher(ds, 4)[0]] * 3
        jm, tm = _models("dl", "SIR", (5, 8, 5), num_layers=2)
        make_loss = _dl_loss_j
    else:
        _, coll, jcoll = _hec_collections(nodes=6, classes=2, samples=12)
        sels = [np.arange(s, s + 4) for s in (0, 4, 8)]
        tbs = [coll.collate(sel, 4) for sel in sels]
        jgraphs = [jcoll.collate(sel, 4)["graph"] for sel in sels]
        graphs = [b["graph"] for b in tbs]
        batches = [(b["node_feats"], b["labels"], b["graph_weights"])
                   for b in tbs]
        jm, tm = _models("hec", "SIR", (2, 8, 1), num_layers=2)
        make_loss = _hec_loss_j
    variables = jm.init(jax.random.PRNGKey(3), jgraphs[0],
                        jnp.asarray(batches[0][0]))
    load_jax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
    assert param_count(tm) == sum(
        v.size for v in jax.tree_util.tree_leaves(variables["params"]))

    tx = j_make_adamw(lr, 0.0)
    state = init_state(variables, tx)
    params, opt_state = state.params, state.opt_state
    opt = make_adamw(tm.parameters(), lr, 0.0)
    step = (tdl.make_harness(tm, graphs[0], opt)[0] if harness == "dl"
            else thec.make_harness(tm, opt)[0])
    small = {}
    for graph, jgraph, (f, lab, w) in zip(graphs, jgraphs, batches):
        (loss_j, _), grads = jax.jit(jax.value_and_grad(
            make_loss(jm, jgraph, f, lab, w), has_aux=True))(params)
        for k, g in _flat(grads).items():
            small[k] = small.get(k, False) | (np.abs(g) < 1e-6)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        if harness == "dl":
            loss = step(torch.from_numpy(f), torch.from_numpy(lab).long(),
                        torch.from_numpy(w), None)
        else:
            loss = step(graph, torch.from_numpy(f),
                            torch.from_numpy(lab), torch.from_numpy(w), None)
        np.testing.assert_allclose(float(loss), float(loss_j), **FWD_TOL)

    slots = _slots(tm)
    for key, p in _flat(params).items():
        tensor, transpose = slots[key]
        have = tensor.detach().numpy()
        have = have.T if transpose else have
        keep = ~small[key]
        np.testing.assert_allclose(have[keep], p[keep], **FWD_TOL,
                                   err_msg="/".join(key))


def test_dl_sir_shares_one_sigma_mlp():
    """One Linear serves every layer's σ: counted once, filled once by the
    bridge and stepped once by AdamW."""
    tm = tdl_model.SIRModel(10, 40, 10, num_layers=3)
    assert all(conv.activation is tm.activation for conv in tm.convs)
    assert len(list(tm.parameters())) == 2 + 2 + 3 * 5 + 1
    assert param_count(tm) == 880 + 1640 + 3 * (1640 + 1600 + 1640) + 400


@pytest.mark.parametrize("harness,name,argv,want", [
    ("dl", "SIR", (10, 40), 7_800),
    ("dl", "SIR", (10, 64), 18_624),
    ("hec", "SIR", (2, 20), 1_300),
    ("hec", "GCN", (2, 20), 480),
])
def test_param_counts_of_the_paper_configurations(harness, name, argv, want):
    """The JAX package's counts (PARITY.md): DL SIR n=10 at h=40 and
    h=64, HEC SIR and GCN at c=2, h=20."""
    inp, hid = argv
    tmods = tdl_model if harness == "dl" else thec_model
    model = tmods.MODELS[name](inp, hid, inp if harness == "dl" else 1)
    assert param_count(model) == want


# ------------------------------------------------------ the entry points

@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("harness", ["dl", "hec"])
def test_entry_point_on_cpu(harness, name, capsys):
    if harness == "dl":
        train, test = tdl.main([
            "--cpu", "--model", name, "--nodes", "4", "--samples", "20",
            "--nhidden", "8", "--epochs", "2", "--batch-size", "8",
            "--nruns", "1", "--nheads", "2", "--log-every", "1"])
    else:
        train, test = thec.main([
            "--cpu", "--model", name, "--nodes", "6", "--classes", "2",
            "--samples", "20", "--nhidden", "8", "--epochs", "2",
            "--batch-size", "8", "--nruns", "1", "--nheads", "2",
            "--log-every", "1", "--edge-bf16"])
    assert len(train) == len(test) == 1
    assert np.isfinite(train + test).all()
    out = capsys.readouterr()
    assert "Epoch 0002" in out.out and "Runned 1 times" in out.out
    assert "[run 0 seed 0]" in out.err


def test_dl_gcn_reads_exactly_chance():
    """GraphConv has no self term: every key of a graph gets the same
    logits and exactly one key in n is right, so the accuracy is 1/n."""
    train, test = tdl.main([
        "--cpu", "--model", "GCN", "--nodes", "10", "--samples", "40",
        "--nhidden", "8", "--epochs", "3", "--batch-size", "16",
        "--nruns", "1", "--log-every", "100"])
    assert train == [0.1] and test == [0.1]


def test_dl_sir_reaches_the_oracle():
    """The JAX suite's oracle settings (tests/test_e2e_synthetic.py): SIR
    reaches test accuracy exactly 1.0."""
    stats = []
    _, test = tdl.main([
        "--cpu", "--nodes", "5", "--samples", "240", "--nhidden", "32",
        "--epochs", "120", "--batch-size", "64", "--nruns", "1",
        "--log-every", "1000"], stats=stats, time_steps=True)
    assert test == [1.0]
    assert stats[0]["epochs"] <= 120 and len(stats[0]["step_ms"]) > 0


def test_hec_records_its_stats():
    stats = []
    argv = ["--cpu", "--nodes", "6", "--classes", "2", "--samples", "20",
            "--nhidden", "8", "--epochs", "2", "--batch-size", "8",
            "--nruns", "1"]
    thec.main(argv, stats=stats)
    thec.main(argv, stats=stats, time_steps=True)
    for s in stats:
        assert s["epochs"] == 2 and s["seconds"] > 0
        # 2 train batches an epoch, then 2 + 1 to evaluate
        assert len(s["collate_ms"]) == 2 * 5
    assert "step_ms" not in stats[0] and len(stats[1]["step_ms"]) == 4


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (tdl.main, thec.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--nruns", "1", "--epochs", "1"])


# ----------------------------------------------------- card against CPU

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("harness", ["dl", "hec"])
def test_model_card_matches_cpu(cuda_device, harness, name):
    """Each of the twelve models on the card against the same weights on
    the CPU: the output, the loss and every gradient, on a full-width
    batch of its harness (DL n=10, h=40; HEC c=2, h=20, 50 nodes)."""
    if harness == "dl":
        ds = DictionaryLookupDataset(10, 64, rng=np.random.default_rng(0))
        arrays = tdl.pad_batch(ds.feats[:60], ds.labels[:60], 64, 10,
                               tdl.make_batcher(ds, 64).n_pad)
        make = lambda dev: tdl.make_batcher(ds, 64, dev)  # noqa: E731
        dims = (10, 40, 10)
    else:
        _, coll, _ = _hec_collections(nodes=50, classes=2, samples=64)
        b = coll.collate(np.arange(60), 64)
        arrays = (b["node_feats"], b["labels"], b["graph_weights"])
        make = lambda dev: coll.collate(np.arange(60), 64,  # noqa: E731
                                        dev)["graph"]
        dims = (2, 20, 1)
    torch.manual_seed(0)
    tmods = tdl_model if harness == "dl" else thec_model
    kw = {} if name == "SIR" else {"num_heads": 2}
    model = tmods.MODELS[name](*dims, num_layers=2, **kw)
    runs = {}
    for dev in ("cpu", cuda_device):
        m = copy.deepcopy(model).to(dev).train()
        f, lab, w = (torch.from_numpy(a).to(dev) for a in arrays)
        out = m(make(dev), f)
        loss = (tdl.weighted_ce(out, lab.long(), w) if harness == "dl"
                else thec.weighted_mse(out[:, 0], lab, w))
        loss.backward()
        runs[str(dev)] = (out.detach().cpu(), loss.detach().cpu(),
                          {k: p.grad.cpu() for k, p in m.named_parameters()})
    (o_c, l_c, g_c), (o_g, l_g, g_g) = runs["cpu"], runs[str(cuda_device)]
    torch.testing.assert_close(o_g, o_c, **FWD_TOL)
    torch.testing.assert_close(l_g, l_c, **FWD_TOL)
    for k in g_c:
        torch.testing.assert_close(g_g[k], g_c[k], **BWD_TOL, msg=k)


def test_protocol_reads_the_runs_a_lane_finished(tmp_path):
    """The protocol tool counts a lane's runs by its per-run stderr lines,
    as the two trainers print them."""
    from sir_gcn_tpu_torch.tools import oracle_protocol

    log = tmp_path / "lane.log"
    log.write_text(
        "Params: 1300\nEpoch 0020 | loss: 1.0 | test_loss: 1.0\n"
        "[run 0 seed 5] train MSE 0.00081234 test MSE 0.00090000 "
        "(181 epochs, 212.5 s)\n"
        "[run 0 seed 0] train acc 1.000000 test acc 1.000000 "
        "(57 epochs, 9.0 s)\n"
        "[run 1 seed 6] train MSE 0.1 test MSE 0.2 (3")
    assert oracle_protocol.finished_runs(str(log)) == [
        (5, 0.00081234, 0.0009, 181, 212.5), (0, 1.0, 1.0, 57, 9.0)]
    assert set(oracle_protocol.LANES) >= {"dl_sir_n10", "hec_gcn_c2_s5"}
