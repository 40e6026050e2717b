"""The port's distributed training through its entry points, on gloo
ranks spawned on the CPU: ``--mesh-devices 2`` (the halo aggregate under
the models, rank-summed BatchNorm statistics, losses and gradients) on the
arxiv, wiki-cs and heterophilous trainers against the port's own
single-device ``--no-fast-path`` runs, as ``tests/test_parallel.py``
holds the JAX package's; the same for the row-sharded CSR (``--dist-path
gspmd``, and JAX's automatic choice of it for a GAT model or max
aggregation); one ``make_dp_train_step_stateful`` step on two ranks
against JAX's on a 2-device mesh; ``--dp-devices 2`` through the batched
trainers; and what raises without a card."""

import numpy as np
import pytest
import torch

import sir_gcn_tpu_torch.experiments.heterophilous.train as thtrain
import sir_gcn_tpu_torch.parallel.multihost as multihost
import sir_gcn_tpu_torch.experiments.ogbn_arxiv.train as tatrain
import sir_gcn_tpu_torch.experiments.sbm.train as tsbm
import sir_gcn_tpu_torch.experiments.super_pixel.train as tsp
import sir_gcn_tpu_torch.experiments.wiki_cs.train as twtrain
import sir_gcn_tpu_torch.experiments.zinc.train as tzinc
from sir_gcn_tpu_torch.parallel.multihost import needs_spawn, spawn_ranks

try:  # pytest puts tests/ on the path; an import as tests.<name> does not
    import torch_dist_workers as workers
except ModuleNotFoundError:
    from tests import torch_dist_workers as workers

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
GRAPH = ["--synthetic-nodes", "1000", "--synthetic-edges", "6000",
         "--log-every", "100", "--nruns", "1"]
DROPOUTS = ["--dropout", "0.2", "--input-dropout", "0.1", "--feat-dropout",
            "0.1", "--edge-dropout", "0.2"]


@pytest.fixture(autouse=True)
def bounded_ranks(monkeypatch):
    """A hung collective fails in a minute, a spawned run in four: the
    trainers spawn their ranks with the module's defaults."""
    monkeypatch.setattr(multihost, "DEFAULT_TIMEOUT_S", 60.0)
    monkeypatch.setattr(multihost, "DEFAULT_DEADLINE_S", 240.0)


def _close(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert abs(x - y) < 1e-6, (a, b)


@pytest.mark.parametrize("flags", [
    ["--agg-type", "sym", "--norm", "bn", "--residual"] + DROPOUTS,
    ["--agg-type", "mean", "--norm", "cn", "--use-labels", "--label-iters",
     "1", "--mask-rate", "0.5", "--flag", "--m", "2", "--l2", "1e-4"],
], ids=["bn_dropouts", "bag_of_tricks"])
def test_arxiv_mesh_devices_matches_single_device(flags):
    common = (["--cpu", "--epochs", "3", "--nhidden", "12", "--nlayers",
               "2"] + GRAPH + flags)
    (one,) = tatrain.main(common + ["--no-fast-path"])
    (two,) = tatrain.main(common + ["--mesh-devices", "2"])
    _close([one["val_acc"], one["test_acc"]], [two["val_acc"],
                                               two["test_acc"]])
    np.testing.assert_allclose(two["train_losses"], one["train_losses"],
                               rtol=1e-5)
    assert two["logits"].shape == one["logits"].shape


def test_wikics_mesh_devices_matches_single_device():
    common = ["--cpu", "--epochs", "3", "--nsplits", "1", "--nhidden", "12",
              "--nlayers", "2", "--agg-type", "mean", "--norm", "bn",
              "--jumping-knowledge", "--resid-layers", "1"] + GRAPH + DROPOUTS
    val_1, test_1 = twtrain.main(common + ["--no-fast-path"])
    stats = []
    val_2, test_2 = twtrain.main(common + ["--mesh-devices", "2"],
                                 stats=stats, time_steps=True)
    _close(test_2, test_1)
    _close(val_2, val_1)
    assert len(stats) == 1 and len(stats[0]["step_ms"]) == 3


def test_heterophilous_mesh_devices_matches_single_device():
    common = ["--cpu", "--epochs", "2", "--nsplits", "1", "--nhidden", "8",
              "--nlayers", "2", "--dataset", "roman-empire", "--norm", "bn",
              "--agg-type", "sym", "--dropout", "0.2", "--use-amp"] + GRAPH
    _close(thtrain.main(common + ["--mesh-devices", "2"])[1],
           thtrain.main(common + ["--no-fast-path"])[1])


def _zinc_data():
    from sir_gcn_tpu.data.batching import GraphCollection as JColl

    from sir_gcn_tpu_torch.data import synthetic_molecules

    g, nf, ef, lab = synthetic_molecules(8, seed=0)
    return dict(graphs=g, nf=nf, ef=ef, labels=lab), JColl(
        g, node_feats=nf, edge_feats=ef, labels=lab)


def test_dp_step_matches_jax_make_dp_train_step_stateful(tmp_path):
    """Two ranks, each its own zinc batch (--norm bn), one SGD step at
    rate 1, against JAX's ``make_dp_train_step_stateful`` on a 2-device
    mesh from the same weights: the weights after the step (so the
    averaged gradients), BatchNorm's averaged running statistics, the
    loss."""
    import jax
    import jax.numpy as jnp
    import optax

    from experiments.zinc import model as jzinc
    from sir_gcn_tpu.parallel import make_mesh
    from sir_gcn_tpu.parallel.data_parallel import (
        make_dp_train_step_stateful,
        stack_device_batches,
    )

    hidden = 8
    data, jcoll = _zinc_data()
    sel = [np.array([0, 1, 2]), np.array([3, 4, 5, 6])]
    jm = jzinc.make_sir_model(28, 4, hidden, 1, num_layers=2, norm="bn")
    jbs = [jcoll.collate(s, 4) for s in sel]

    def inputs(b):
        return (b["graph"], jnp.asarray(b["node_feats"]),
                jnp.asarray(b["edge_feats"]))

    variables = jm.init(jax.random.PRNGKey(1), *inputs(jbs[0]))

    def loss_fn(params, batch_stats, batch, rng):
        preds, upd = jm.apply({"params": params, "batch_stats": batch_stats},
                              *inputs(batch), deterministic=False,
                              mutable=["batch_stats"])
        err = jnp.abs(preds[:, 0] - batch["labels"])
        w = batch["graph_weights"]
        return (jnp.sum(err * w) / jnp.maximum(jnp.sum(w), 1.0),
                upd["batch_stats"])

    tx = optax.sgd(1.0)
    mesh = make_mesh((2,), ("data",), devices=jax.devices()[:2])
    step = make_dp_train_step_stateful(loss_fn, tx, mesh)
    keep = ("graph", "node_feats", "edge_feats", "labels", "graph_weights")
    stacked = stack_device_batches([{k: b[k] for k in keep} for b in jbs])
    params, _, stats, loss = step(
        variables["params"], tx.init(variables["params"]),
        variables["batch_stats"], stacked,
        jnp.stack([jax.random.PRNGKey(i) for i in range(2)]))

    host = jax.tree_util.tree_map(np.asarray, variables)
    got = spawn_ranks(2, workers.dp_step_rank,
                      dict(data, variables=host, sel=sel, hidden=hidden),
                      cpu=True, timeout_s=60, deadline_s=120,
                      store_dir=str(tmp_path))
    np.testing.assert_allclose(got["loss"], float(loss), **FWD_TOL)
    flat = {}
    for kind, tree in (("params", params), ("batch_stats", stats)):
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat["/".join((kind,) + tuple(k.key for k in path))] = v
    assert set(flat) == set(got["slots"])
    before = {"/".join(("params",) + tuple(k.key for k in path)): v
              for path, v in jax.tree_util.tree_flatten_with_path(
                  host["params"])[0]}
    for key, want in flat.items():
        have = got["slots"][key]
        if key in before:  # the step is the averaged gradient
            np.testing.assert_allclose(before[key] - have,
                                       before[key] - np.asarray(want),
                                       **BWD_TOL, err_msg=key)
        else:
            np.testing.assert_allclose(have, np.asarray(want), **FWD_TOL,
                                       err_msg=key)


BATCHED = {
    "zinc": (tzinc.main, ["--nhidden", "8", "--nlayers", "2", "--norm", "bn",
                          "--synthetic-samples", "40", "--batch-size", "8"]),
    "sbm": (tsbm.main, ["--nhidden", "8", "--nlayers", "2",
                        "--synthetic-samples", "30", "--batch-size", "8"]),
    "super_pixel": (tsp.main, ["--nhidden", "8", "--nlayers", "2",
                               "--use-feature", "--synthetic-samples", "30",
                               "--batch-size", "8"]),
}


@pytest.mark.parametrize("harness", list(BATCHED))
def test_dp_devices_entry_points_train(harness):
    main, argv = BATCHED[harness]
    stats = []
    val, test = main(["--cpu", "--dp-devices", "2", "--epochs", "2",
                      "--nruns", "1", "--log-every", "100"] + argv,
                     stats=stats, time_steps=True)
    assert np.isfinite(val + test).all() and len(val) == 1
    assert len(stats) == 1 and len(stats[0]["step_ms"]) > 0


# the single-device --no-fast-path flags beside which each trainer's
# --dist-path gspmd run is held
GSPMD_RUNS = {
    tatrain.main: ["--nhidden", "12", "--nlayers", "2", "--agg-type",
                   "mean", "--norm", "bn", "--epochs", "3"] + DROPOUTS,
    twtrain.main: ["--nsplits", "1", "--nhidden", "12", "--nlayers", "2",
                   "--agg-type", "sym", "--norm", "cn", "--epochs", "3",
                   "--jumping-knowledge"] + DROPOUTS,
    thtrain.main: ["--nsplits", "1", "--nhidden", "8", "--nlayers", "2",
                   "--dataset", "roman-empire", "--agg-type", "max",
                   "--norm", "bn", "--dropout", "0.2", "--epochs", "2"],
}


def _val_test(main, argv):
    """(val, test) of a run: the metrics of every split, or the arxiv
    trainer's accuracies."""
    out = main(argv)
    if main is tatrain.main:
        (r,) = out
        return [r["val_acc"]], [r["test_acc"]], r["train_losses"]
    return out[0], out[1], None


@pytest.mark.parametrize("main", [tatrain.main, twtrain.main,
                                  thtrain.main])
def test_gspmd_path_matches_single_device(main):
    """``--dist-path gspmd`` trains on the row-sharded CSR and matches the
    single-device ``--no-fast-path`` run."""
    common = ["--cpu"] + GRAPH + GSPMD_RUNS[main]
    val_1, test_1, loss_1 = _val_test(main, common + ["--no-fast-path"])
    val_2, test_2, loss_2 = _val_test(main, common + [
        "--mesh-devices", "2", "--dist-path", "gspmd"])
    _close(val_2 + test_2, val_1 + test_1)
    if loss_1 is not None:
        np.testing.assert_allclose(loss_2, loss_1, rtol=1e-5)


@pytest.mark.parametrize("flags", [["--model", "GAT"],
                                   ["--agg-type", "max"]])
def test_mesh_outside_the_halo_path_takes_the_row_sharded_csr(flags,
                                                              capfd):
    """JAX sends these to the GSPMD path; the port to the row-sharded CSR,
    with JAX's note. Each trains on two ranks and matches the
    single-device ``--no-fast-path`` run on the wiki-cs and arxiv
    trainers (GAT with two heads and attention dropout)."""
    for main, extra in ((twtrain.main, ["--nsplits", "1"]),
                        (tatrain.main, [])):
        common = (["--cpu", "--epochs", "3", "--nhidden", "8", "--nlayers",
                   "2", "--nheads", "2", "--attn-dropout", "0.1",
                   "--jumping-knowledge", "--norm", "bn"] + GRAPH + extra
                  + flags + DROPOUTS)
        val_1, test_1, loss_1 = _val_test(main, common + ["--no-fast-path"])
        capfd.readouterr()
        val_2, test_2, loss_2 = _val_test(main, common + ["--mesh-devices",
                                                          "2"])
        assert "using the row-sharded CSR" in capfd.readouterr().out
        _close(val_2 + test_2, val_1 + test_1)
        if loss_1 is not None:
            np.testing.assert_allclose(loss_2, loss_1, rtol=1e-5)


@pytest.mark.parametrize("main,flag", [
    (tatrain.main, "--mesh-devices"), (twtrain.main, "--mesh-devices"),
    (thtrain.main, "--mesh-devices"), (tzinc.main, "--dp-devices"),
    (tsbm.main, "--dp-devices"), (tsp.main, "--dp-devices")])
def test_distributed_entry_points_raise_without_a_card(main, flag,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([flag, "2", "--epochs", "1"] + (
            GRAPH if flag == "--mesh-devices" else ["--nruns", "1"]))


def test_one_rank_needs_no_spawn():
    assert not needs_spawn(1, cpu=False) and not needs_spawn(0, cpu=True)
    assert needs_spawn(2, cpu=True)
