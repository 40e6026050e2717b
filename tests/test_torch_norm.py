"""The port's norm zoo (``sir_gcn_tpu_torch/models/norm.py``) against the
JAX package's flax modules and against the NumPy oracles of the
reference math (``tests/test_norm.py``): every norm of ``get_norm``, with
and without a graph, in training mode (batch statistics, the running
statistics' update) and in eval mode, the output and every gradient.

The batch pads an empty graph in the middle and two graph slots at the
end, so GraphNorm meets graphs with no node. The flax weights and
running statistics are drawn at random before they are carried across by
``load_jax_variables``, so that a slot filled from the wrong array shows.
Tolerances are the JAX suite's: forward atol 2e-4 / rtol 1e-4, gradients
atol 3e-4 / rtol 1e-3.
"""

import numpy as np
import pytest
import torch

from sir_gcn_tpu_torch import batch_graphs
from sir_gcn_tpu_torch.models import (
    MLP,
    ContraNorm,
    GraphNorm,
    MaskedBatchNorm,
    get_norm,
)
from sir_gcn_tpu_torch.utils import load_jax_variables
from sir_gcn_tpu_torch.utils.convert import _slots

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
D = 6
# sizes of the real graphs; the empty one sits in the middle
SIZES = (3, 0, 5, 2)
N_PAD, E_PAD, G_PAD = 16, 24, 6


def _graphs_list(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, max(n, 1), 2 * n), rng.integers(0, max(n, 1),
                                                          2 * n), n)
            for n in SIZES]


def _graphs():
    from sir_gcn_tpu import batch_graphs as j_batch_graphs

    gs = _graphs_list()
    kw = dict(n_pad=N_PAD, e_pad=E_PAD, g_pad=G_PAD)
    return j_batch_graphs(gs, **kw), batch_graphs(gs, **kw)


def _feats(seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_PAD, D)) * scale + 0.5).astype(np.float32)


def _randomize(variables, seed=2):
    """The flax variables with every leaf redrawn (variances positive)."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, v):
        v = np.asarray(v)
        x = rng.normal(size=v.shape).astype(np.float32)
        if path[-1].key == "var":
            return np.abs(x) + 0.5
        return x

    return jax.tree_util.tree_map_with_path(draw, variables)


def _flax_norm(name, with_graph, **kw):
    from sir_gcn_tpu.models import get_norm as j_get_norm

    return j_get_norm(name, with_graph, D, **kw)


def _run_flax(norm, jg, x, variables, train, with_graph, gw):
    """(out, d sum(out*gw)/d params, d/dx, updated batch_stats)."""
    import jax
    import jax.numpy as jnp

    args = (jg,) if with_graph else ()
    mask = None if with_graph else jnp.asarray(jg.node_mask)
    stats = variables.get("batch_stats", {})

    def f(params, xx):
        v = {"params": params, "batch_stats": stats}
        call = args + (xx,) + (() if with_graph or mask is None
                               else (mask,))
        if train and stats:
            out, upd = norm.apply(v, *call, deterministic=False,
                                  mutable=["batch_stats"])
        else:
            out, upd = norm.apply(v, *call, deterministic=not train), {}
        return jnp.sum(out * gw), (out, upd)

    (_, (out, upd)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables.get("params", {}),
                                         jnp.asarray(x))
    return (np.asarray(out), jax.tree_util.tree_map(np.asarray, gp),
            np.asarray(gx), jax.tree_util.tree_map(np.asarray,
                                                   upd.get("batch_stats",
                                                           {})))


def _flat(tree, prefix):
    import jax

    return {prefix + tuple(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


NORMS = [("gn", True), ("cn", True), ("bn", True), ("ln", True),
         ("none", True), ("cn", False), ("bn", False), ("ln", False),
         ("none", False)]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name,with_graph", NORMS)
def test_norm_matches_flax(name, with_graph, train):
    """Out, input gradient, every weight gradient and, in training, the
    updated running statistics; without a graph the BatchNorms take the
    node mask as their row mask, as the molhiv readout does."""
    import jax
    import jax.numpy as jnp

    jg, tg = _graphs()
    x = _feats()
    gw = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    jn = _flax_norm(name, with_graph)
    init_args = ((jg,) if with_graph else ()) + (jnp.asarray(x),)
    variables = _randomize(jn.init(jax.random.PRNGKey(0), *init_args))
    out_j, gp_j, gx_j, stats_j = _run_flax(jn, jg, x, variables, train,
                                           with_graph, jnp.asarray(gw))

    tn = get_norm(name, with_graph, D)
    load_jax_variables(tn, variables)
    tn.train(train)
    xt = torch.from_numpy(x).requires_grad_()
    if with_graph:
        out = tn(tg, xt)
    elif isinstance(tn, (MaskedBatchNorm, ContraNorm)):
        out = tn(xt, tg.node_mask)
    else:
        out = tn(xt)
    (out * torch.from_numpy(gw)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), out_j, **FWD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), gx_j, **BWD_TOL)
    slots = _slots(tn)
    for key, g in _flat(gp_j, ("params",)).items():
        tensor, _ = slots[key]
        np.testing.assert_allclose(tensor.grad.numpy(), g, **BWD_TOL,
                                   err_msg="/".join(key))
    assert {k for k in slots if k[0] == "params"} == set(
        _flat(gp_j, ("params",)))
    if train:
        for key, v in _flat(stats_j, ("batch_stats",)).items():
            np.testing.assert_allclose(slots[key][0].numpy(), v, **FWD_TOL,
                                       err_msg="/".join(key))


def test_graphnorm_matches_numpy_oracle():
    """Per-graph statistics with weight 1, bias 0, mean_scale 1 (the
    oracle of tests/test_norm.py); an empty graph slot leaves the others
    alone; padding rows do not move the real ones."""
    _, tg = _graphs()
    x = _feats()
    out = GraphNorm(D)(tg, torch.from_numpy(x)).detach().numpy()
    start = 0
    for n in SIZES:
        xs = x[start:start + n]
        if n:
            demean = xs - xs.mean(0)
            std = np.sqrt((demean ** 2).mean(0) + 1e-5)
            np.testing.assert_allclose(out[start:start + n], demean / std,
                                       atol=1e-5)
        start += n
    x2 = x.copy()
    x2[start:] = 99.0
    out2 = GraphNorm(D)(tg, torch.from_numpy(x2)).detach().numpy()
    np.testing.assert_allclose(out2[:start], out[:start], atol=1e-6)
    assert np.isfinite(out2).all()


def test_masked_batchnorm_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    feats = rng.normal(loc=3.0, scale=2.0, size=(32, 4)).astype(np.float32)
    mask = np.arange(32) < 20
    bn = MaskedBatchNorm(4)
    out = bn(torch.from_numpy(feats), torch.from_numpy(mask)).detach()
    real = feats[:20]
    mean, var = real.mean(0), real.var(0)
    np.testing.assert_allclose(out.numpy()[:20],
                               (real - mean) / np.sqrt(var + 1e-5),
                               atol=1e-4)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * var * 20 / 19, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_contranorm_matches_numpy_oracle(masked):
    """The reference math (models/norm.py:40-45) with scale 0.5 and
    use_scale; with a mask the padding rows leave the Gram matrix and the
    BatchNorm statistics."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(12, 4)).astype(np.float32)
    mask = np.arange(12) < (9 if masked else 12)
    cn = ContraNorm(4, scale=0.5, temp=1.0, use_scale=True)
    out = cn(torch.from_numpy(feats),
             torch.from_numpy(mask) if masked else None).detach().numpy()

    def softmax(z, axis):
        z = z - z.max(axis=axis, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=axis, keepdims=True)

    xm = feats * mask[:, None]
    w = softmax(xm.T @ xm, 1)
    x = (1 + 0.5) * feats - 0.5 * (feats @ w)
    real = x[mask]
    want = (x - real.mean(0)) / np.sqrt(real.var(0) + 1e-5)
    np.testing.assert_allclose(out[mask], want[mask], atol=1e-4)


@pytest.mark.parametrize("with_graph", [True, False])
def test_norm_kwargs_reach_the_norms(with_graph):
    """An MLP with cn and ``norm_kwargs`` (scale, temp, use_scale) against
    flax's, through the bridge, in training mode."""
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.models import MLP as JMLP

    jg, tg = _graphs()
    x = _feats(scale=0.3)
    kw = dict(scale=0.3, temp=2.0, use_scale=True)
    jm = JMLP(D, 8, 5, 2, norm="cn", with_graph=with_graph, norm_kwargs=kw)
    args = ((jg,) if with_graph else ()) + (jnp.asarray(x),)
    variables = _randomize(jm.init(jax.random.PRNGKey(0), *args))
    out_j, _ = jm.apply(variables, *args, deterministic=False,
                        mutable=["batch_stats"])
    tm = MLP(D, 8, 5, 2, norm="cn", with_graph=with_graph, norm_kwargs=kw)
    load_jax_variables(tm, variables)
    assert tm.norms[0].__class__.__name__ == ("GraphContraNorm" if with_graph
                                              else "ContraNorm")
    targs = ((tg,) if with_graph else ()) + (torch.from_numpy(x),)
    np.testing.assert_allclose(tm(*targs).detach().numpy(),
                               np.asarray(out_j), **FWD_TOL)


def test_get_norm_rejects_what_flax_rejects():
    with pytest.raises(NotImplementedError, match="gn"):
        get_norm("gn", False, 4)
    with pytest.raises(NotImplementedError, match="foo"):
        get_norm("foo", True, 4)
