"""The port's Correct & Smooth (``experiments/ogbn_arxiv/
correct_and_smooth.py``) against the JAX package's on the same graph:
``label_spreading`` with the symmetric and the row-mean propagation and a
post step, and ``run`` (the correct and the smooth step) on one
prediction array, at the JAX suite's forward tolerance (atol 2e-4 / rtol
1e-4); the new entry points raise without a card unless ``--cpu`` is
given. JAX is imported inside the tests.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sir_gcn_tpu_torch.experiments.ogbn_arxiv.correct_and_smooth as tcs
import sir_gcn_tpu_torch.experiments.ogbn_arxiv.train as ttrain
from sir_gcn_tpu_torch.data import synthetic_node_classification

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
C = 6


@pytest.fixture(scope="module")
def setup():
    from experiments.ogbn_arxiv import train as jtrain

    data = synthetic_node_classification(num_nodes=250, num_edges=1200,
                                         feat_dim=8, num_classes=C, seed=2)
    flags = SimpleNamespace(add_reverse_edge=True, add_self_loop=True)
    jg = jtrain.build_arxiv_graph(data, flags)
    tg = ttrain.build_arxiv_graph(data, flags, "cpu")
    n_pad = tg.n_pad
    rng = np.random.default_rng(0)
    pred = rng.random((n_pad, C)).astype(np.float32)
    pred /= pred.sum(-1, keepdims=True)
    labels = np.zeros(n_pad, np.int32)
    labels[:250] = data.labels
    masks = []
    for idx in (data.train_idx, data.val_idx, data.test_idx):
        w = np.zeros(n_pad, np.float32)
        w[idx] = 1.0
        masks.append(w)
    return SimpleNamespace(jg=jg, tg=tg, pred=pred, labels=labels,
                           masks=tuple(masks))


@pytest.mark.parametrize("use_sym", [True, False], ids=["sym", "mean"])
def test_label_spreading_matches_jax(setup, use_sym):
    import jax.numpy as jnp
    from experiments.ogbn_arxiv import correct_and_smooth as jcs

    s = setup
    got = tcs.label_spreading(s.tg, torch.from_numpy(s.pred), nprop=5,
                              alpha=0.7, use_sym=use_sym,
                              post_step=lambda x: x.clamp(0, 1))
    want = jcs.label_spreading(s.jg, jnp.asarray(s.pred), nprop=5,
                               alpha=0.7, use_sym=use_sym,
                               post_step=lambda x: jnp.clip(x, 0, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("use_sym", [True, False], ids=["sym", "mean"])
def test_correct_and_smooth_run_matches_jax(setup, use_sym, tmp_path,
                                           monkeypatch):
    from experiments.ogbn_arxiv import correct_and_smooth as jcs

    s = setup
    monkeypatch.chdir(tmp_path)  # the saved name is the file's with _cs_
    args = SimpleNamespace(nprop_c=4, alpha_c=0.8, nprop_s=4, alpha_s=0.6,
                           use_sym=use_sym, save_pred=True)
    outs = []
    for mod, graph, side in ((tcs, s.tg, "port"), (jcs, s.jg, "jax")):
        outs.append((mod.run(graph, s.pred, s.labels, s.masks, args,
                             f"{side}_0.npy"),
                     np.load(f"{side}_cs_0.npy")))
    (got, got_arr), (want, want_arr) = outs
    assert got == want
    np.testing.assert_allclose(got_arr, want_arr, **FWD_TOL)


def test_new_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    size = ["--synthetic-nodes", "64", "--synthetic-edges", "128"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcs.main(size)
    for flags in (["--use-labels", "--flag"], ["--no-fast-path"],
                  ["--ckpt-dir", "ck", "--ckpt-every", "1"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(["--epochs", "1", "--nruns", "1"] + size + flags)
    assert not (tmp_path / "ck").exists()
