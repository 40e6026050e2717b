"""One train step of the ogbn-arxiv bag of tricks, the port's
``make_harness`` against the JAX package's, from the same weights
(carried across by ``load_jax_variables``, the label trick's wider input
included): the label trick with label reuse (k = 2) at mask-rate 0.5,
the KD student, ``--l1``/``--l2``, and FLAG (m = 2, with the label trick)
fed JAX's initial perturbation. Each compares the loss, the parameters
after AdamW, the BatchNorm running statistics and the eval logits with
label reuse; FLAG also the last perturbation.

Dropout and edge dropout are 0, so the two RNG streams never meet. The
JAX graph takes its CPU route, as the JAX suite runs it. Tolerances are
the JAX suite's: forward atol 2e-4 / rtol 1e-4 (losses, parameters,
statistics, logits, perturbations). Adam's first step is about lr *
sign(g), so parameter entries with |g| < 1e-6 are left out, and so are
perturbation entries whose gradient was under 1e-6 in some pass (its
sign may flip). JAX is imported inside the tests.
"""

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
N, D, C, H, LAYERS, LR, WD = 200, 12, 5, 16, 2, 1e-2, 1e-3
KW = dict(num_layers=LAYERS, norm="bn", residual=True, agg_type="sym")
BASE = dict(use_labels=False, label_iters=0, mask_rate=1.0, flag=False,
            m=0, kd_mode="teacher", kd_alpha=0.5, kd_temp=1.0, l1=0.0,
            l2=0.0, train_step_size=1e-2, untrain_step_size=5e-3)
CASES = {
    "labels_reuse": dict(use_labels=True, label_iters=2, mask_rate=0.5),
    "kd_student": dict(kd_mode="student", kd_temp=2.0, kd_alpha=0.7),
    "l1_l2": dict(l1=1e-3, l2=1e-3),
    "flag": dict(flag=True, m=2, use_labels=True, label_iters=1,
                 mask_rate=0.5),
}


@pytest.fixture(autouse=True)
def f32_edges():
    set_edge_dtype(None)
    yield
    set_edge_dtype(None)


@pytest.fixture(scope="module")
def graphs():
    from experiments.ogbn_arxiv import train as jtrain

    data = synthetic_node_classification(num_nodes=N, num_edges=800,
                                         feat_dim=D, num_classes=C, seed=0)
    flags = SimpleNamespace(add_reverse_edge=True, add_self_loop=True)
    jfg = jtrain.build_arxiv_graph(data, flags)
    tfg = ttrain.build_arxiv_graph(data, flags, "cpu")
    n_pad = tfg.n_pad

    def mask_of(idx):
        w = np.zeros(n_pad, np.float32)
        w[idx] = 1.0
        return w

    feats = np.zeros((n_pad, D), np.float32)
    feats[:N] = data.feat
    labels = np.zeros(n_pad, np.int64)
    labels[:N] = data.labels
    train_w, val_w, test_w = (mask_of(i) for i in
                              (data.train_idx, data.val_idx, data.test_idx))
    teacher = np.random.default_rng(3).random((n_pad, C)).astype(np.float32)
    teacher /= teacher.sum(-1, keepdims=True)
    return SimpleNamespace(data=data, jfg=jfg, tfg=tfg, n_pad=n_pad,
                           feats=feats, labels=labels, train_w=train_w,
                           val_w=val_w, test_w=test_w, mask_of=mask_of,
                           teacher=teacher)


def _epoch_masks(g, mask_rate):
    """The trainer's first epoch's masks (its host RNG at seed 0)."""
    sub = (np.random.default_rng(999).random(len(g.data.train_idx))
           < mask_rate)
    labeled = g.mask_of(g.data.train_idx[~sub])
    return dict(loss_w=g.mask_of(g.data.train_idx[sub]), labeled=labeled,
                unlabeled=np.clip(g.train_w - labeled + g.val_w + g.test_w,
                                  0, 1),
                eval_labeled=g.train_w,
                eval_unlabeled=np.clip(g.val_w + g.test_w, 0, 1))


def _jax_flag_perturbation(jm, g, args, params, stats, masks, p0):
    """JAX's FLAG loop (``experiments/ogbn_arxiv/train.py:177-205``) with
    its loss (``:148-171``) written out, returning the summed loss, the
    last perturbation and the smallest |gradient| each entry had over the
    passes; its loss must equal make_harness's."""
    import jax
    import jax.numpy as jnp
    from experiments.ogbn_arxiv import train as jtrain

    m = args.m + 1
    labels = jnp.asarray(g.labels, jnp.int32)
    one_hot = jax.nn.one_hot(labels, C) * masks["labeled"][:, None]
    f0 = jnp.concatenate([jnp.asarray(g.feats), one_hot], -1)
    unl = jnp.asarray(masks["unlabeled"])

    def loss_fn(p, bs, perturb):
        pert = jnp.concatenate([perturb, jnp.zeros((g.n_pad, C))], -1)

        def fwd(bs, f):
            logits, upd = jm.apply({"params": p, "batch_stats": bs}, g.jfg,
                                   f, pert, deterministic=False,
                                   mutable=["batch_stats"])
            return logits, upd["batch_stats"]

        f = f0
        logits, bs = fwd(bs, f)
        for _ in range(args.label_iters):
            probs = jax.nn.softmax(jax.lax.stop_gradient(logits))
            f = jnp.concatenate(
                [f[:, :-C], jnp.where(unl[:, None], probs, f[:, -C:])], -1)
            logits, bs = fwd(bs, f)
        return jtrain.soft_ce(logits, labels,
                              jnp.asarray(masks["loss_w"])) / m, bs

    train_mask = g.train_w.astype(bool)[:, None]
    step = np.where(train_mask, args.train_step_size,
                    args.untrain_step_size).astype(np.float32)
    perturb, total = jnp.asarray(p0), 0.0
    small = np.full(p0.shape, np.inf, np.float32)
    for _ in range(m):
        (loss, stats), gp = jax.value_and_grad(
            loss_fn, argnums=2, has_aux=True)(params, stats, perturb)
        small = np.minimum(small, np.abs(np.asarray(gp)))
        total = total + loss
        perturb = perturb + step * jnp.sign(gp)
    return float(total), np.asarray(perturb), small


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(graphs, case):
    import jax
    import jax.numpy as jnp
    from experiments.ogbn_arxiv import model as jmodel
    from experiments.ogbn_arxiv import train as jtrain
    from sir_gcn_tpu.train import init_state
    from sir_gcn_tpu.train import make_adamw as j_make_adamw
    from sir_gcn_tpu.train import set_lr_scale as j_set_lr_scale
    from sir_gcn_tpu.train import warmup_scale as j_warmup_scale

    g = graphs
    args = SimpleNamespace(**{**BASE, **CASES[case]})
    masks = _epoch_masks(g, args.mask_rate)
    input_dim = D + (C if args.use_labels else 0)

    # JAX: init, one jitted train step, then the eval with label reuse
    jm = jmodel.SIRModel(hidden_dim=H, output_dim=C, **KW)
    variables = jm.init(jax.random.PRNGKey(0), g.jfg,
                        jnp.zeros((g.n_pad, input_dim)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tx = j_make_adamw(LR, WD)
    state = j_set_lr_scale(init_state(variables, tx), j_warmup_scale(1, 20))
    j_step, j_eval = jtrain.make_harness(jm, g.jfg, args, C, tx)
    key = jax.random.PRNGKey(7)
    j_in = [jnp.asarray(x) for x in (
        masks["labeled"], masks["loss_w"], masks["unlabeled"],
        g.train_w.astype(bool), g.teacher)]
    new_state, j_loss = j_step(state, key, jnp.asarray(g.feats),
                               jnp.asarray(g.labels, jnp.int32), *j_in)
    p0 = None
    if args.flag:  # the train step's first split, as JAX draws it
        _, pk = jax.random.split(key)
        scale = np.where(g.train_w.astype(bool)[:, None],
                         args.train_step_size / args.untrain_step_size, 1.0)
        p0 = np.array(jax.random.uniform(
            pk, g.feats.shape, jnp.float32, -args.untrain_step_size,
            args.untrain_step_size) * scale, np.float32)

    # the port, from the same weights and the same perturbation
    tm = tmodel.SIRModel(input_dim, H, C, **KW)
    load_jax_variables(tm, variables)
    opt = make_adamw(tm.parameters(), LR, WD)
    set_lr_scale(opt, warmup_scale(1, ttrain.WARMUP))
    t_step, t_eval = ttrain.make_harness(tm, g.tfg, opt, args, C)
    t = {k: torch.from_numpy(v) for k, v in masks.items()}
    loss, perturb = t_step(
        torch.from_numpy(g.feats), torch.from_numpy(g.labels), t["loss_w"],
        None, labeled=t["labeled"], unlabeled=t["unlabeled"],
        train_mask=torch.from_numpy(g.train_w.astype(bool)),
        kd_teacher=torch.from_numpy(g.teacher),
        perturb=None if p0 is None else torch.from_numpy(p0))

    np.testing.assert_allclose(float(loss), float(j_loss), **FWD_TOL)
    slots = _sir_model_slots(tm)
    flat = {}
    for coll in ("params", "batch_stats"):
        tree = getattr(new_state, coll)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[(coll,) + tuple(k.key for k in path)] = np.asarray(v)
    assert set(flat) == set(slots)
    for key_, want in flat.items():
        tensor, transpose = slots[key_]
        have = tensor.detach().numpy()
        keep = np.ones(want.shape, bool)
        if tensor.grad is not None:  # a parameter: Adam's sign step
            grad = tensor.grad.numpy()
            keep = np.abs(grad.T if transpose else grad) >= 1e-6
        have = have.T if transpose else have
        np.testing.assert_allclose(have[keep], want[keep], **FWD_TOL,
                                   err_msg="/".join(key_))

    if args.flag:
        j_total, j_pert, small = _jax_flag_perturbation(
            jm, g, args, variables["params"], variables["batch_stats"],
            masks, p0)
        np.testing.assert_allclose(j_total, float(j_loss), rtol=1e-6)
        keep = small > 1e-6
        assert keep.mean() > 0.5
        np.testing.assert_allclose(perturb.numpy()[keep], j_pert[keep],
                                   **FWD_TOL)

    # the eval with label reuse, from JAX's updated state in both
    load_jax_variables(tm, {
        "params": jax.tree_util.tree_map(np.asarray, new_state.params),
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              new_state.batch_stats)})
    ev = t_eval(torch.from_numpy(g.feats), torch.from_numpy(g.labels),
                torch.from_numpy(masks["eval_labeled"]),
                torch.from_numpy(masks["eval_unlabeled"]))
    ev_j = j_eval(new_state, jnp.asarray(g.feats),
                  jnp.asarray(g.labels, jnp.int32),
                  jnp.asarray(masks["eval_labeled"]),
                  jnp.asarray(masks["eval_unlabeled"]))
    np.testing.assert_allclose(ev.numpy(), np.asarray(ev_j), **FWD_TOL)


def test_label_trick_model_bridges_the_wider_input(graphs):
    """The label trick widens the input by the class count: the bridge
    carries the [D + C, H] embedding across, and the port's logits equal
    JAX's on the assembled input."""
    import jax
    import jax.numpy as jnp
    from experiments.ogbn_arxiv import model as jmodel

    g = graphs
    x = np.concatenate([g.feats, np.eye(C, dtype=np.float32)[
        g.labels] * g.train_w[:, None]], -1)
    for name, kw in (("SIR", KW), ("GAT", dict(num_layers=LAYERS,
                                               norm="bn", num_heads=2))):
        jm = getattr(jmodel, f"{name}Model")(hidden_dim=H, output_dim=C,
                                            **kw)
        variables = jax.tree_util.tree_map(np.asarray, jm.init(
            jax.random.PRNGKey(1), g.jfg, jnp.asarray(x)))
        tm = getattr(tmodel, f"{name}Model")(D + C, H, C, **kw)
        load_jax_variables(tm, variables)
        tm.eval()
        with torch.no_grad():
            out = tm(g.tfg, torch.from_numpy(x))
        want = jm.apply(variables, g.jfg, jnp.asarray(x), deterministic=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **FWD_TOL,
                                   err_msg=name)
