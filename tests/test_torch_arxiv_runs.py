"""Whole ogbn-arxiv runs through the entry points, the port's ``main``
(``--cpu``) against the JAX package's: the teacher with the label trick,
label reuse and mask-rate saves its predictions, the student learns from
them by knowledge distillation and saves its own, and Correct & Smooth
post-processes each side's files. Both sides start from the same weights:
the JAX run's initial variables are caught as it makes its train state
and carried into the port's model by ``load_jax_variables``. Dropout is
0, the norm LayerNorm (under BatchNorm a bias before the norm has only
rounding for a gradient, and Adam moves it by ±lr on either side).

The accuracies must be equal; the saved softmax arrays and C&S's output
allclose at the JAX suite's forward tolerance, atol 2e-4 / rtol 1e-4. JAX
is imported inside the tests.
"""

import os

import numpy as np
import pytest

import sir_gcn_tpu_torch.experiments.ogbn_arxiv.correct_and_smooth as tcs
import sir_gcn_tpu_torch.experiments.ogbn_arxiv.train as ttrain
from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
from sir_gcn_tpu_torch.utils import load_jax_variables

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
SIZE = ["--synthetic-nodes", "300", "--synthetic-edges", "1500"]
COMMON = ["--nhidden", "16", "--nlayers", "2", "--agg-type", "sym",
          "--norm", "ln", "--residual", "--add-reverse-edge",
          "--add-self-loop", "--epochs", "3", "--nruns", "1",
          "--log-every", "100"] + SIZE
TEACHER = COMMON + ["--use-labels", "--label-iters", "1", "--mask-rate",
                    "0.5", "--save-pred"]
CS = ["--use-sym", "--add-reverse-edge", "--add-self-loop",
      "--save-pred"] + SIZE


@pytest.fixture(autouse=True)
def f32_edges():
    set_edge_dtype(None)
    yield
    set_edge_dtype(None)


def run_both(flags, jax_dir, port_dir, monkeypatch):
    """``flags`` through JAX's trainer in ``jax_dir``, then through the
    port's (``--cpu``) in ``port_dir`` from the JAX run's initial weights;
    returns the JAX (val, test) accuracies and the port's result."""
    import jax
    from experiments.ogbn_arxiv import train as jtrain

    caught = []

    def init_state(variables, tx):
        caught.append(jax.tree_util.tree_map(np.asarray, variables))
        return j_init_state(variables, tx)

    def build_model(*args, **kwargs):
        model = t_build_model(*args, **kwargs)
        load_jax_variables(model, caught.pop(0))
        return model

    j_init_state, t_build_model = jtrain.init_state, ttrain.build_model
    monkeypatch.setattr(jtrain, "init_state", init_state)
    monkeypatch.setattr(ttrain, "build_model", build_model)
    monkeypatch.chdir(jax_dir)
    (val,), (test,) = jtrain.main(["--cpu"] + flags)
    monkeypatch.chdir(port_dir)
    (result,) = ttrain.main(["--cpu"] + flags)
    assert not caught
    return (val, test), result


def assert_same_run(jax_accs, result):
    assert (result["val_acc"], result["test_acc"]) == jax_accs


def assert_same_files(jax_dir, port_dir, names):
    for name in names:
        got = np.load(os.path.join(port_dir, "output", name))
        want = np.load(os.path.join(jax_dir, "output", name))
        np.testing.assert_allclose(got, want, **FWD_TOL, err_msg=name)


def test_teacher_student_correct_and_smooth_match_jax(tmp_path,
                                                      monkeypatch):
    from experiments.ogbn_arxiv import correct_and_smooth as jcs

    jd, pd = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    pd.mkdir()
    for flags in (TEACHER, TEACHER + ["--kd-mode", "student",
                                      "--kd-temp", "2", "--l2", "1e-4"]):
        accs, result = run_both(flags, jd, pd, monkeypatch)
        assert_same_run(accs, result)
    assert_same_files(jd, pd, ["teacher_0.npy", "student_0.npy"])

    monkeypatch.chdir(jd)
    want = jcs.main(["--cpu"] + CS)
    monkeypatch.chdir(pd)
    got = tcs.main(["--cpu"] + CS)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g == w
        assert g["test_acc"] != g["orig_test_acc"]  # C&S moved something
    assert_same_files(jd, pd, ["teacher_cs_0.npy", "student_cs_0.npy"])


@pytest.mark.parametrize("extra", [["--reorder", "--save-pred"],
                                   ["--no-fast-path"],
                                   ["--use-xrt-emb", "--model", "GAT",
                                    "--nheads", "2"]],
                         ids=["reorder", "no_fast_path", "xrt_emb"])
def test_trainer_flags_match_jax(tmp_path, monkeypatch, extra):
    """``--reorder`` (the saved predictions mapped back to the original
    order), ``--no-fast-path`` (the CSR aggregate) and ``--use-xrt-emb``
    (a synthetic embeddings file at the reference's relative path, under
    each side's working directory), each with the label trick."""
    jd, pd = tmp_path / "jax", tmp_path / "port"
    if "--use-xrt-emb" in extra:
        emb = np.random.default_rng(5).normal(size=(300, 24))
        for d in (jd, pd):
            (d / "dataset" / "ogbn_arxiv_xrt").mkdir(parents=True)
            np.save(d / ttrain.XRT_EMB, emb.astype(np.float32))
    jd.mkdir(exist_ok=True)
    pd.mkdir(exist_ok=True)
    flags = COMMON + ["--use-labels", "--label-iters", "1"] + extra
    flags[flags.index("--epochs") + 1] = "2"
    accs, result = run_both(flags, jd, pd, monkeypatch)
    assert_same_run(accs, result)
    if "--save-pred" in extra:
        assert_same_files(jd, pd, ["teacher_0.npy"])
