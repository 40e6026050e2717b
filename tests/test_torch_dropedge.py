"""DropEdge on the port's kernels (dynamic per-slot scales) against the JAX
package's.

One numpy mask goes into JAX ``sir_aggregate(edge_mask=...)`` and into the
port's. The JAX side runs its Pallas routes in interpret mode (its
``pallas_available`` reports True and the three Pallas factories get
``interpret=True``), so ``make_ell_sir_aggregate_pallas(...,
static_scale=False)`` (elementwise and general), the fused-edge factory and
the max factory compute the reference; f32 cases are also held against
JAX's own CPU route (its XLA factories). Covered: sum, mean and sym on the
elementwise route, the general route (centered_relu), the ``e`` route and
the fused-edge route, and max, forward and every gradient, with bf16 and
f32 edges, on a bidirected powerlaw graph with a hub above budget 256
(both plans' stage 2), isolated nodes, and a mask that drops every in-edge
of some nodes (mean's clamp, max's zero fill).

Also ``SIRConv`` and ``SIREConv`` under an injected mask against JAX's
through the weight bridge, and the arxiv ``SIRModel`` with edge dropout:
a fresh mask per layer and per step, the JAX model fed the same masks,
the static model in eval mode, and the trainer's ``--edge-dropout``.

Tolerances are the JAX suite's: forward atol 2e-4 / rtol 1e-4, gradients
atol 3e-4 / rtol 1e-3; g_WE, a sum over every slot, at atol 3e-4 plus
1e-5 of its largest entry. JAX is imported inside the tests.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sir_gcn_tpu_torch.experiments.ogbn_arxiv.model as tmodel
import sir_gcn_tpu_torch.experiments.ogbn_arxiv.train as ttrain
import sir_gcn_tpu_torch.ops.cuda.kernels as tkernels
import sir_gcn_tpu_torch.ops.ell as tell
import sir_gcn_tpu_torch.ops.message_passing as tmp
from sir_gcn_tpu_torch import build_graph
from sir_gcn_tpu_torch.data.synthetic import powerlaw_edges
from sir_gcn_tpu_torch.models import SIRConv, SIREConv
from sir_gcn_tpu_torch.utils import load_jax_variables
from sir_gcn_tpu_torch.utils.convert import _slots

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
H, DE, O = 16, 5, 12
ALPHA, SLOPE = 0.5, 0.2
N, N_EDGED = 52, 48   # nodes 48..51 have no edge
DROPPED = (3, 17, 30)  # nodes whose every in-edge the mask drops


def gw_tol(want) -> dict:
    return dict(atol=3e-4 + 1e-5 * float(np.abs(np.asarray(want)).max()),
                rtol=1e-3)


def port_act(route: str):
    return (tell.centered_relu(ALPHA) if route == "general"
            else tell.leaky_relu(SLOPE))


def jax_act(route: str):
    import jax

    if route == "general":
        return lambda z: jax.nn.relu(z - ALPHA * z.mean(-1, keepdims=True))
    return lambda z: jax.nn.leaky_relu(z, SLOPE)


@pytest.fixture(scope="module")
def case():
    """Both packages' FastGraphs of a bidirected powerlaw graph (node 0's
    307 in- and out-edges above budget 256: both plans' stage 2), node
    tables, edge tables, W_R and the DropEdge mask [E_pad]: a fifth of the
    edges at random and every in-edge of the ``DROPPED`` nodes."""
    import sir_gcn_tpu.ops.ell as jell
    from sir_gcn_tpu import build_graph as j_build_graph

    rng = np.random.default_rng(0)
    s, d = powerlaw_edges(rng, N_EDGED, 1200)
    src, dst = np.concatenate([s, d]), np.concatenate([d, s])
    tfg = tell.build_fast_graph(build_graph(src, dst, N))
    jfg = jell.build_fast_graph(j_build_graph(src, dst, N))
    assert tfg.dst_plan.buckets2 is not None
    assert tfg.src_plan.buckets2 is not None
    sorted_dst = tfg.graph.dst.numpy()
    mask = (rng.random(tfg.e_pad) >= 0.2) & ~np.isin(sorted_dst, DROPPED)
    x = lambda *shape, k=1.0: (rng.normal(size=shape) * k).astype(np.float32)
    return SimpleNamespace(
        tfg=tfg, jfg=jfg, mask=mask, eq=x(tfg.n_pad, H), ek=x(tfg.n_pad, H),
        e=x(tfg.e_pad, H), eb=x(tfg.e_pad, DE), we=x(DE, H, k=0.3),
        w=x(H, O, k=H ** -0.5), b=x(O), gw=x(tfg.n_pad, H),
        gwo=x(tfg.n_pad, O))


@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX package's routes as on its accelerator: ``pallas_available``
    True, and the Pallas factories in interpret mode."""
    import sir_gcn_tpu.ops.ell as jell
    import sir_gcn_tpu.ops.pallas as jpallas

    monkeypatch.setattr(jpallas, "pallas_available", lambda: True)
    for name in ("make_ell_sir_aggregate_pallas",
                 "make_ell_sir_aggregate_pallas_fused_edge",
                 "make_ell_sir_aggregate_max_pallas"):
        monkeypatch.setattr(jell, name, functools.partial(
            getattr(jell, name), interpret=True))


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


# the differentiated inputs of each route, after eq and ek
EXTRA = {"linear": (), "general": (), "e": ("e",), "fused": ("we",),
         "max": ("w", "b")}


def _kwargs(route, c, vals, lib):
    """sir_aggregate's keyword arguments of ``route`` from the case's
    differentiated ``vals`` (after eq, ek) and its edge basis."""
    if route == "e":
        return dict(e=vals[0])
    if route == "fused":
        return dict(e_basis=lib(c.eb), w_edge=vals[0])
    if route == "max":
        return dict(w_relation=vals[0], b_relation=vals[1])
    return {}


def _port(c, route, agg, mask):
    ts = [torch.from_numpy(getattr(c, k).copy()).requires_grad_()
          for k in ("eq", "ek") + EXTRA[route]]
    out = tmp.sir_aggregate(
        c.tfg, ts[0], ts[1], port_act(route), agg,
        edge_mask=None if mask is None else torch.from_numpy(mask),
        **_kwargs(route, c, ts[2:], torch.from_numpy))
    gw = c.gwo if route == "max" else c.gw
    (out * torch.from_numpy(gw)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax(c, route, agg, mask):
    import jax
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.message_passing as jmp

    names = ("eq", "ek") + EXTRA[route]
    gw = jnp.asarray(c.gwo if route == "max" else c.gw)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(*vals):
        y = jmp.sir_aggregate(c.jfg, vals[0], vals[1], jax_act(route), agg,
                              edge_mask=jmask,
                              **_kwargs(route, c, vals[2:], jnp.asarray))
        return jnp.sum(y * gw), y

    f = jax.value_and_grad(loss, argnums=tuple(range(len(names))),
                           has_aux=True)
    if not (route == "fused" and jmp.get_edge_dtype() is not None):
        # jit only speeds the interpreted kernels up; on the fused route
        # in bf16 it also moves XLA's roundings off the kernel's (0.07 of
        # 157 in one sum), so that route runs eagerly
        f = jax.jit(f)
    (_, out), grads = f(*(jnp.asarray(getattr(c, k)) for k in names))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _assert_close(route, got, want):
    out, grads = got
    np.testing.assert_allclose(out, want[0], **FWD_TOL)
    names = ("eq", "ek") + EXTRA[route]
    for name, a, b in zip(names, grads, want[1]):
        tol = gw_tol(b) if name in ("we", "w") else BWD_TOL
        np.testing.assert_allclose(a, b, **tol, err_msg=name)


CASES = [(r, a, "bf16") for r in ("linear", "general", "e", "fused")
         for a in ("sum", "mean", "sym")]
CASES += [("max", "max", "bf16"), ("max", "max", "f32"),
          ("linear", "mean", "f32"), ("fused", "sym", "f32"),
          ("general", "sym", "f32"), ("e", "mean", "f32")]


@pytest.mark.parametrize("route,agg,dt", CASES)
def test_dropedge_matches_jax_pallas(case, route, agg, dt, jax_pallas,
                                     edge_dtype):
    edge_dtype(dt)
    got = _port(case, route, agg, case.mask)
    _assert_close(route, got, _jax(case, route, agg, case.mask))
    if route == "max":  # masked-out nodes and isolated ones read 0
        empty = np.isin(np.arange(case.tfg.n_pad), DROPPED + tuple(
            range(N_EDGED, case.tfg.n_pad)))
        assert (got[0][empty] == 0).all() and (got[0][~empty] != 0).any()


@pytest.mark.parametrize("route,agg", [("linear", "mean"), ("e", "sym"),
                                       ("max", "max")])
def test_dropedge_matches_jax_cpu_route(case, route, agg):
    """Against the JAX package's route on its CPU (the XLA factories)."""
    got = _port(case, route, agg, case.mask)
    _assert_close(route, got, _jax(case, route, agg, case.mask))


@pytest.fixture
def kernel_calls(monkeypatch):
    """The plain versions the port's wrappers run on the CPU, in order."""
    calls = []
    for name in dir(tkernels):
        if name.startswith("ell_") and name.endswith("_plain"):
            fn = getattr(tkernels, name)
            monkeypatch.setattr(tkernels, name, lambda *a, _n=name, _f=fn,
                                **k: (calls.append(_n[4:-6]), _f(*a, **k))[1])
    return calls


@pytest.mark.parametrize("route,want", [
    ("linear", ["act_reduce", "src_bwd"]),
    ("general", ["act_reduce", "geq_reduce", "act_reduce_bwd", "src_bwd"]),
    ("e", ["act_reduce", "src_bwd"]),
    ("fused", ["edge_act_reduce2", "edge_src_bwd"]),
    ("max", ["max_fwd", "max_wincount", "max_bwd", "scaled_reduce"]),
])
def test_dropedge_runs_the_kernels_on_dynamic_scales(case, route, want,
                                                     kernel_calls,
                                                     monkeypatch):
    """Each route keeps its kernels under a mask, and they read the
    dynamic slot scales: the static scales of the kept edges, zero on
    every dropped edge."""
    scales = []
    spy = tell.slot_scale
    monkeypatch.setattr(tell, "slot_scale", lambda *a: (
        scales.append(spy(*a)), scales[-1])[1])
    agg = "max" if route == "max" else "sym"
    _port(case, route, agg, case.mask)
    assert kernel_calls == want
    assert len(scales) == (1 if route == "max" else 2)
    fg = case.tfg
    for plan, s in zip((fg.dst_plan, fg.src_plan), scales):
        kept = case.mask[plan.host["slot_edge"]] & (
            plan.host["slot_valid"] > 0)
        assert ((s.numpy() > 0) == kept).all()
    kernel_calls.clear()
    _port(case, route, agg, None)  # no mask: the static scales
    assert kernel_calls == want


def test_dropedge_full_mask_equals_static(case):
    """A mask that keeps every edge gives the static route's values (mean
    divides by the kept count after the aggregate instead of folding
    1/deg into the scale)."""
    keep = np.ones(case.tfg.e_pad, bool)
    for route, agg in (("linear", "mean"), ("fused", "sym"), ("max", "max")):
        a = _port(case, route, agg, keep)
        b = _port(case, route, agg, None)
        _assert_close(route, a, (b[0], b[1]))


# ----------------------------------------------------------------------
# SIRConv, SIREConv and the arxiv SIRModel under DropEdge
# ----------------------------------------------------------------------

def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items")
                   else {prefix + (k,): np.asarray(v)})
    return out


@pytest.mark.parametrize("layer,agg", [("sirconv", "sym"),
                                       ("sirconv", "mean"),
                                       ("sireconv", "sym"),
                                       ("sireconv", "mean")])
def test_convs_with_injected_mask_match_jax(case, layer, agg, jax_pallas,
                                            kernel_calls):
    """The layers with one mask, against JAX's (its Pallas routes): the
    SIREConv takes the fused-edge kernels (#7, #8) on dynamic scales."""
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.models.conv import SIRConv as JSIRConv
    from sir_gcn_tpu.models.conv import SIREConv as JSIREConv

    rng = np.random.default_rng(7)
    c = case
    x = rng.normal(size=(c.tfg.n_pad, 10)).astype(np.float32)
    ef = rng.normal(size=(c.tfg.graph.num_edges, DE)).astype(np.float32)
    jact = jax_act("linear")
    if layer == "sirconv":
        jconv = JSIRConv(hidden_dim=H, output_dim=O, activation=jact,
                         agg_type=agg)
        conv = SIRConv(10, H, O, port_act("linear"), agg_type=agg)
        jargs, targs = (jnp.asarray(x),), (torch.from_numpy(x),)
    else:
        jconv = JSIREConv(hidden_dim=H, output_dim=O, activation=jact,
                          agg_type=agg)
        conv = SIREConv(10, DE, H, O, port_act("linear"), agg_type=agg)
        jargs = (jnp.asarray(x), jnp.asarray(ef))
        targs = (torch.from_numpy(x), torch.from_numpy(ef))
    variables = jax.tree_util.tree_map(
        np.asarray, jconv.init(jax.random.PRNGKey(3), c.jfg, *jargs))
    load_jax_variables(conv, variables)
    slots = _slots(conv)

    out = conv(c.tfg, *targs, edge_mask=torch.from_numpy(c.mask))
    (out * torch.from_numpy(c.gwo)).sum().backward()
    if layer == "sireconv":
        assert kernel_calls == ["edge_act_reduce2", "edge_src_bwd"]

    def loss(p):
        y = jconv.apply(p, c.jfg, *jargs, edge_mask=jnp.asarray(c.mask),
                        deterministic=True)
        return jnp.sum(y * c.gwo), y

    (_, jout), gp = jax.value_and_grad(loss, has_aux=True)(variables)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    grads = _flat(gp)
    assert set(grads) == set(slots)
    for key, g in grads.items():
        tensor, transpose = slots[key]
        have = tensor.grad.numpy()
        np.testing.assert_allclose(have.T if transpose else have, g,
                                   **gw_tol(g), err_msg="/".join(key))


@pytest.fixture(scope="module")
def arxiv():
    """A small arxiv-shaped task, both packages' graphs, and the JAX
    SIRModel's variables (3 layers, bn, residual, sym, edge dropout 0.3,
    no other dropout)."""
    import jax
    import jax.numpy as jnp
    from experiments.ogbn_arxiv import model as jmodel
    from experiments.ogbn_arxiv import train as jtrain

    from sir_gcn_tpu_torch.data import synthetic_node_classification

    data = synthetic_node_classification(num_nodes=150, num_edges=600,
                                         feat_dim=20, num_classes=5, seed=0)
    flags = SimpleNamespace(add_reverse_edge=True, add_self_loop=True)
    jfg = jtrain.build_arxiv_graph(data, flags)
    tfg = ttrain.build_arxiv_graph(data, flags, "cpu")
    feats = np.zeros((tfg.n_pad, 20), np.float32)
    feats[:150] = data.feat
    kw = dict(num_layers=3, norm="bn", residual=True, agg_type="sym",
              edge_dropout=0.3)
    jm = jmodel.SIRModel(hidden_dim=H, output_dim=5, **kw)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jfg, jnp.asarray(feats)))
    return SimpleNamespace(jfg=jfg, tfg=tfg, feats=feats, jm=jm,
                           variables=variables, kw=kw,
                           gw=np.random.default_rng(1).normal(
                               size=(tfg.n_pad, 5)).astype(np.float32))


def _port_model(a, edge_dropout):
    m = tmodel.SIRModel(20, H, 5, **{**a.kw, "edge_dropout": edge_dropout})
    load_jax_variables(m, a.variables)
    return m


def test_arxiv_model_draws_a_fresh_mask_per_layer_and_step(arxiv,
                                                          monkeypatch):
    """Training draws one mask per layer per step from the forward's
    generator, inside the graph's edge mask; the JAX model fed the same
    masks gives the same logits and gradients."""
    import jax
    import jax.numpy as jnp
    from experiments.ogbn_arxiv import model as jmodel

    a = arxiv
    masks = []
    draw = tmodel.drop_edge_mask
    monkeypatch.setattr(tmodel, "drop_edge_mask", lambda *args: (
        masks.append(draw(*args)), masks[-1])[1])
    m = _port_model(a, 0.3)
    m.train()
    gen = torch.Generator().manual_seed(5)
    logits = m(a.tfg, torch.from_numpy(a.feats), generator=gen)
    (logits * torch.from_numpy(a.gw)).sum().backward()
    m(a.tfg, torch.from_numpy(a.feats), generator=gen)
    assert len(masks) == 6
    valid = a.tfg.edge_mask
    for mk in masks:
        assert mk.dtype == torch.bool and not (mk & ~valid).any()
        kept = float(mk.sum()) / float(valid.sum())
        assert 0.55 < kept < 0.85
    for i in range(6):
        for j in range(i):
            assert not torch.equal(masks[i], masks[j]), (i, j)

    # the JAX model, fed the first step's masks in order
    queue = [jnp.asarray(mk.numpy()) for mk in masks[:3]]
    monkeypatch.setattr(jmodel, "drop_edge_mask",
                        lambda rng, graph, rate: queue.pop(0))
    params, stats = a.variables["params"], a.variables["batch_stats"]

    def loss(p):
        y, _ = a.jm.apply({"params": p, "batch_stats": stats}, a.jfg,
                          jnp.asarray(a.feats), deterministic=False,
                          mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(y * a.gw), y

    (_, jlogits), grads = jax.value_and_grad(loss, has_aux=True)(params)
    assert not queue
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **FWD_TOL)
    slots = _slots(m)
    for key, g in _flat(grads).items():
        tensor, transpose = slots[("params",) + key]
        have = tensor.grad.numpy()
        np.testing.assert_allclose(have.T if transpose else have, g,
                                   **BWD_TOL, err_msg="/".join(key))


def test_arxiv_model_eval_and_rate_zero_keep_static_scales(arxiv,
                                                           monkeypatch):
    """In eval mode, and at edge dropout 0 in training, the convs get no
    mask (the static scales), and eval equals the model without edge
    dropout."""
    a = arxiv
    seen = []
    agg = tmp.sir_aggregate
    monkeypatch.setattr(tmp, "sir_aggregate", lambda *args, **kw: (
        seen.append(kw.get("edge_mask")), agg(*args, **kw))[1])
    feats = torch.from_numpy(a.feats)
    with torch.no_grad():
        dropped, plain = _port_model(a, 0.3).eval(), _port_model(a, 0.0)
        got = dropped(a.tfg, feats)
        want = plain.eval()(a.tfg, feats)
        plain.train()(a.tfg, feats, generator=torch.Generator())
    assert seen == [None] * 9
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_trainer_takes_edge_dropout_on_cpu():
    results = ttrain.main([
        "--cpu", "--nhidden", "16", "--nlayers", "2", "--agg-type", "mean",
        "--norm", "bn", "--residual", "--edge-dropout", "0.2",
        "--add-reverse-edge", "--add-self-loop", "--epochs", "2",
        "--nruns", "1", "--synthetic-nodes", "200",
        "--synthetic-edges", "800"])
    assert np.isfinite(results[0]["train_losses"]).all()
