"""The port's ogbn-arxiv SIRModel and training step against the JAX
package's, with the flax weights carried across by ``load_jax_variables``:
logits in training and eval mode, the soft-CE loss, every parameter
gradient, the BatchNorm running statistics and one AdamW step. Dropout
is 0 (flax ``Dropout`` at rate 0 returns its input), so the JAX side runs
with ``deterministic=False`` and uses the batch statistics. Tolerances are
the JAX suite's: forward atol 2e-4 / rtol 1e-4, gradients atol 3e-4 /
rtol 1e-3.

The JAX side (``jax``, the flax models and the JAX trainer) is imported
inside the tests that use it, so that ``pytest -m cuda --noconftest`` can
collect every ``tests/test_torch_*.py`` on a card machine without flax;
``test_port_test_modules_import_without_flax`` holds all of them to that.
"""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sir_gcn_tpu_torch.experiments.ogbn_arxiv.model as tmodel
import sir_gcn_tpu_torch.experiments.ogbn_arxiv.train as ttrain
from sir_gcn_tpu_torch.data import synthetic_node_classification
from sir_gcn_tpu_torch.ops.message_passing import set_edge_dtype
from sir_gcn_tpu_torch.train import make_adamw, set_lr_scale, warmup_scale
from sir_gcn_tpu_torch.utils import load_jax_variables
from sir_gcn_tpu_torch.utils.convert import _sir_model_slots

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
H, LAYERS, LR, WD = 16, 3, 1e-2, 1e-3


@pytest.fixture(autouse=True)
def f32_edges():
    """The trainer sets the process-wide edge dtype: keep each test at f32."""
    set_edge_dtype(None)
    yield
    set_edge_dtype(None)


@pytest.fixture(scope="module")
def setup():
    import jax
    import jax.numpy as jnp
    from experiments.ogbn_arxiv import model as jmodel
    from experiments.ogbn_arxiv import train as jtrain

    data = synthetic_node_classification(num_nodes=150, num_edges=600,
                                         feat_dim=20, num_classes=5, seed=0)
    flags = SimpleNamespace(add_reverse_edge=True, add_self_loop=True)
    jfg = jtrain.build_arxiv_graph(data, flags)
    tfg = ttrain.build_arxiv_graph(data, flags, "cpu")
    n_pad = tfg.n_pad
    feats = np.zeros((n_pad, 20), np.float32)
    feats[:150] = data.feat
    labels = np.zeros(n_pad, np.int64)
    labels[:150] = data.labels
    w = np.zeros(n_pad, np.float32)
    w[data.train_idx] = 1.0

    kw = dict(num_layers=LAYERS, norm="bn", residual=True, agg_type="sym")
    jm = jmodel.SIRModel(hidden_dim=H, output_dim=5, **kw)
    variables = jm.init(jax.random.PRNGKey(0), jfg, jnp.asarray(feats))
    tm = tmodel.SIRModel(20, H, 5, **kw)
    load_jax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
    return SimpleNamespace(jfg=jfg, tfg=tfg, feats=feats, labels=labels,
                           w=w, jm=jm, variables=variables, tm=tm)


def _jax_train_forward(s):
    import jax
    import jax.numpy as jnp
    from experiments.ogbn_arxiv import train as jtrain

    params, stats = s.variables["params"], s.variables["batch_stats"]

    def loss_fn(p):
        logits, upd = s.jm.apply(
            {"params": p, "batch_stats": stats}, s.jfg,
            jnp.asarray(s.feats), deterministic=False,
            mutable=["batch_stats"])
        loss = jtrain.soft_ce(logits, jnp.asarray(s.labels, jnp.int32),
                              jnp.asarray(s.w))
        return loss, (logits, upd["batch_stats"])

    (loss, (logits, new_stats)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    return loss, logits, new_stats, grads


def test_bridge_rejects_missing_and_extra_keys(setup):
    import jax

    tree = jax.tree_util.tree_map(np.asarray, setup.variables)
    del tree["params"]["readout"]["Dense_0"]["bias"]
    with pytest.raises(KeyError, match="readout/Dense_0/bias"):
        load_jax_variables(setup.tm, tree)
    tree = jax.tree_util.tree_map(np.asarray, setup.variables)
    tree["params"]["extra"] = {"kernel": np.zeros(3)}
    with pytest.raises(KeyError, match="extra/kernel"):
        load_jax_variables(setup.tm, tree)


def test_training_step_matches_jax(setup):
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.train import init_state
    from sir_gcn_tpu.train import make_adamw as j_make_adamw
    from sir_gcn_tpu.train import set_lr_scale as j_set_lr_scale
    from sir_gcn_tpu.train import warmup_scale as j_warmup_scale

    s = setup
    load_jax_variables(s.tm, jax.tree_util.tree_map(np.asarray, s.variables))
    loss_j, logits_j, stats_j, grads_j = _jax_train_forward(s)

    tm = s.tm
    opt = make_adamw(tm.parameters(), LR, WD)
    set_lr_scale(opt, warmup_scale(1, ttrain.WARMUP))
    tm.train()
    logits = tm(s.tfg, torch.from_numpy(s.feats))
    loss = ttrain.soft_ce(logits, torch.from_numpy(s.labels),
                          torch.from_numpy(s.w))
    loss.backward()

    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(logits_j), **FWD_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               **FWD_TOL)

    slots = _sir_model_slots(tm)
    flat_grads = {("params",) + tuple(k.key for k in path): v for path, v in
                  jax.tree_util.tree_flatten_with_path(grads_j)[0]}
    flat_stats = {("batch_stats",) + tuple(k.key for k in path): v
                  for path, v in
                  jax.tree_util.tree_flatten_with_path(stats_j)[0]}
    assert set(flat_grads) | set(flat_stats) == set(slots)
    for key, g in flat_grads.items():
        tensor, transpose = slots[key]
        have = tensor.grad.numpy()
        np.testing.assert_allclose(have.T if transpose else have,
                                   np.asarray(g), **BWD_TOL,
                                   err_msg="/".join(key))
    for key, v in flat_stats.items():  # BN running mean and var
        np.testing.assert_allclose(slots[key][0].numpy(), np.asarray(v),
                                   **FWD_TOL, err_msg="/".join(key))

    # eval mode with the updated running statistics
    tm.eval()
    with torch.no_grad():
        ev = tm(s.tfg, torch.from_numpy(s.feats))
    ev_j = s.jm.apply({"params": s.variables["params"],
                       "batch_stats": stats_j}, s.jfg, jnp.asarray(s.feats),
                      deterministic=True)
    np.testing.assert_allclose(ev.numpy(), np.asarray(ev_j), **FWD_TOL)

    # one AdamW step at the first warmup scale; Adam's first step is about
    # lr * sign(g), so entries with |g| < 1e-6 are left out
    opt.step()
    tx = j_make_adamw(LR, WD)
    state = j_set_lr_scale(init_state(s.variables, tx),
                           j_warmup_scale(1, 20))
    updates, _ = tx.update(grads_j, state.opt_state, state.params)
    new_params = jax.tree_util.tree_map(lambda p, u: p + u, state.params,
                                        updates)
    for path, p in jax.tree_util.tree_flatten_with_path(new_params)[0]:
        key = ("params",) + tuple(k.key for k in path)
        tensor, transpose = slots[key]
        have = tensor.detach().numpy()
        have = have.T if transpose else have
        keep = np.abs(np.asarray(flat_grads[key])) >= 1e-6
        np.testing.assert_allclose(have[keep], np.asarray(p)[keep],
                                   **FWD_TOL, err_msg="/".join(key))


def test_trainer_entry_point_on_cpu(capsys):
    results = ttrain.main([
        "--cpu", "--nhidden", "16", "--nlayers", "2", "--agg-type", "sym",
        "--norm", "bn", "--residual", "--dropout", "0.2",
        "--feat-dropout", "0.2", "--add-reverse-edge", "--add-self-loop",
        "--edge-bf16", "--epochs", "2", "--nruns", "1", "--log-every", "1",
        "--synthetic-nodes", "200", "--synthetic-edges", "800"])
    assert len(results) == 1
    r = results[0]
    assert len(r["train_losses"]) == 2
    assert np.isfinite(r["train_losses"]).all()
    assert 0.0 <= r["val_acc"] <= 1.0
    assert "Epoch 0002" in capsys.readouterr().out


def test_trainer_rejects_unported_flags():
    """Only ``--remat`` raises; every other flag of the JAX trainer
    parses, ``--mesh-devices 2`` and ``--dist-path gspmd`` among them."""
    with pytest.raises(NotImplementedError, match="--remat"):
        ttrain.get_args(["--cpu", "--remat"])
    ttrain.get_args(["--cpu", "--mesh-devices", "2", "--dist-path", "gspmd",
                     "--model", "GAT"])
    ttrain.get_args(["--cpu", "--mesh-devices", "1", "--gpu", "1",
                     "--use-labels", "--label-iters", "2", "--flag",
                     "--kd-mode", "student", "--l1", "1e-4", "--reorder",
                     "--no-fast-path", "--use-xrt-emb", "--resume"])


# imports every module named on the command line with flax unimportable, as
# on a card machine that has torch (and perhaps jax) but no flax
_NO_FLAX = """
import importlib, sys
class NoFlax:
    def find_spec(self, name, path=None, target=None):
        if name == "flax" or name.startswith("flax."):
            raise ImportError(f"no module named {name!r} (blocked)")
sys.meta_path.insert(0, NoFlax())
for name in sys.argv[1:]:
    importlib.import_module(name)
"""


def test_port_test_modules_import_without_flax():
    """Every ``tests/test_torch_*.py`` imports with flax missing: the card
    machine has none, and a module-level import of the JAX package's
    models or trainer there stops ``pytest -m cuda --noconftest`` at
    collection (this file did so before its JAX imports moved into the
    tests)."""
    root = Path(__file__).resolve().parents[1]
    names = sorted(f"tests.{p.stem}" for p in
                   (root / "tests").glob("test_torch_*.py"))
    assert "tests.test_torch_model" in names
    run = subprocess.run([sys.executable, "-c", _NO_FLAX, *names], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
