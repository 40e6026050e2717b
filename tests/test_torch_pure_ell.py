"""The port's pure ELL route (any torch sigma on a FastGraph) against the
JAX package's pure-XLA factories ``make_ell_sir_aggregate`` and
``make_ell_sir_aggregate_max``, and ``sir_aggregate``'s routing to it.

* the linear aggregate with erf-GELU (``F.gelu`` against
  ``jax.nn.gelu(approximate=False)``) and with an MLP sigma, with and
  without an edge term, on static scales and under a DropEdge mask;
* max with erf-GELU and an edge term, and max whose products tie exactly
  (duplicated edges, quarter-integer data: every product and sum exact in
  f32, so both packages see the same ties and split them equally);
* ``sir_aggregate`` with a sigma outside the registry: every aggregation,
  with and without ``e`` and ``edge_mask``, against JAX's
  ``sir_aggregate`` on its CPU route, with no kernel (plain version) run;
* an MLP sigma's parameter gradients, against the CSR aggregate on the
  same graph; the routing log line, once per sigma.

Tolerances are the JAX suite's: forward atol 2e-4 / rtol 1e-4, gradients
atol 3e-4 / rtol 1e-3. JAX is imported inside the tests.
"""

import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import sir_gcn_tpu_torch.ops.cuda.kernels as tkernels
import sir_gcn_tpu_torch.ops.ell as tell
import sir_gcn_tpu_torch.ops.message_passing as tmp
from sir_gcn_tpu_torch import build_graph

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
H, O, HM = 16, 10, 24  # HM: the MLP sigma's hidden width


def graph_edges(graph: str, rng):
    """(src, dst, n, max_budget) of the test graphs."""
    if graph == "hub":  # node 0 takes 300 in-edges: the hub stage 2
        n = 40
        return (rng.integers(0, n, 360),
                np.concatenate([np.zeros(300, np.int64),
                                rng.integers(0, n, 60)]), n, 64)
    if graph == "isolated":  # nodes 30..59 have no edge
        return rng.integers(0, 30, 150), rng.integers(0, 30, 150), 60, 16
    n = 40
    return rng.integers(0, n, 203), rng.integers(0, n, 203), n, 16


def make_case(graph: str, seed: int = 0):
    import sir_gcn_tpu.ops.ell as jell
    from sir_gcn_tpu import build_graph as j_build_graph

    rng = np.random.default_rng(seed)
    src, dst, n, mb = graph_edges(graph, rng)
    tfg = tell.build_fast_graph(build_graph(src, dst, n), max_budget=mb)
    jfg = jell.build_fast_graph(j_build_graph(src, dst, n), max_budget=mb)
    x = lambda *shape, k=1.0: (rng.normal(size=shape) * k).astype(np.float32)
    mask = rng.random(tfg.e_pad) >= 0.25
    return SimpleNamespace(
        tfg=tfg, jfg=jfg, eq=x(tfg.n_pad, H), ek=x(tfg.n_pad, H),
        e=x(tfg.e_pad, H), w=x(H, O, k=H ** -0.5), b=x(O),
        gw=x(tfg.n_pad, H), gwo=x(tfg.n_pad, O), mask=mask,
        mlp=dict(w1=x(H, HM, k=H ** -0.5), b1=x(HM, k=0.1),
                 w2=x(HM, H, k=HM ** -0.5), b2=x(H, k=0.1)))


def sigmas(c, name: str):
    """(port sigma, JAX sigma): erf-GELU, or an MLP tanh(z W1 + b1) W2 +
    b2 (a torch module with the case's weights, a JAX closure over
    them)."""
    import jax
    import jax.numpy as jnp

    if name == "gelu":
        return F.gelu, lambda z: jax.nn.gelu(z, approximate=False)
    p = c.mlp
    mlp = nn.Sequential(nn.Linear(H, HM), nn.Tanh(), nn.Linear(HM, H))
    with torch.no_grad():
        for lin, w, b in ((mlp[0], p["w1"], p["b1"]),
                          (mlp[2], p["w2"], p["b2"])):
            lin.weight.copy_(torch.from_numpy(w.T))
            lin.bias.copy_(torch.from_numpy(b))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    return mlp, lambda z: (jnp.tanh(z @ jp["w1"] + jp["b1"]) @ jp["w2"]
                           + jp["b2"])


def _t(x):
    return torch.from_numpy(np.asarray(x).copy()).requires_grad_()


def jax_scale(c, agg):
    """The per-edge scale that JAX's ``sir_aggregate`` hands its factory
    under the case's mask: validity times the sym norm."""
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.message_passing as jmp

    g = c.jfg.graph
    s = (g.edge_mask & jnp.asarray(c.mask)).astype(jnp.float32)
    sym = jmp._edge_scale(g, agg)
    return s if sym is None else s * sym


def jax_kept_mean(jfg, y, s):
    """JAX's ``sir_aggregate``: mean under a mask divides the factory's
    sums by the kept in-edges."""
    import jax.numpy as jnp

    plan = jfg.dst_plan
    counts = plan.reduce_slots_sum(plan.gather_edges(s)[:, None]
                                   * plan.slot_valid[:, None])
    return y / jnp.maximum(counts, 1.0)


def _compare(got, want, names):
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **FWD_TOL)
    for name, a, b in zip(names, got[1], want[1]):
        np.testing.assert_allclose(a, np.asarray(b), **BWD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("graph,act,agg,edge,dynamic", [
    ("random", "gelu", "sum", False, False),
    ("hub", "gelu", "mean", True, False),
    ("isolated", "gelu", "sym", True, True),
    ("hub", "gelu", "sum", False, True),
    ("random", "mlp", "sym", True, False),
    ("hub", "mlp", "mean", False, True),
    ("isolated", "mlp", "sum", True, True),
])
def test_pure_linear_matches_jax_xla_route(graph, act, agg, edge, dynamic):
    import jax
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.ell as jell

    c = make_case(graph)
    tact, jact = sigmas(c, act)
    names = ("eq", "ek", "e") if edge else ("eq", "ek")
    ts = [_t(getattr(c, k)) for k in names]
    out = tell.pure_ell_sir_aggregate(
        c.tfg, ts[0], ts[1], tact, agg, e=ts[2] if edge else None,
        edge_mask=torch.from_numpy(c.mask) if dynamic else None)
    (out * torch.from_numpy(c.gw)).sum().backward()

    f = jell.make_ell_sir_aggregate(c.jfg, jact, agg, with_edge=edge,
                                    static_scale=not dynamic)
    s = jax_scale(c, agg)
    e0 = jnp.zeros((0,), jnp.float32)

    def loss(*v):
        y = f(v[0], v[1], v[2] if edge else e0, s)
        if dynamic and agg == "mean":
            y = jax_kept_mean(c.jfg, y, s)
        return jnp.sum(y * c.gw), y

    (_, jout), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(getattr(c, k)) for k in names))
    _compare((out.detach().numpy(), [t.grad.numpy() for t in ts]),
             (jout, grads), names)


def tie_case():
    """A graph whose every edge appears twice, quarter-integer data and
    weights, and an edge table equal on the two copies of an edge: the
    copies' products tie exactly, as do many others by chance."""
    import sir_gcn_tpu.ops.ell as jell
    from sir_gcn_tpu import build_graph as j_build_graph

    rng = np.random.default_rng(9)
    n, h, o = 24, 8, 6
    src0, dst0 = rng.integers(0, 20, 70), rng.integers(0, 20, 70)
    src, dst = np.tile(src0, 2), np.tile(dst0, 2)
    tfg = tell.build_fast_graph(build_graph(src, dst, n), max_budget=8)
    jfg = jell.build_fast_graph(j_build_graph(src, dst, n), max_budget=8)
    q = lambda *shape: (rng.integers(-8, 9, shape) / 4).astype(np.float32)
    e_orig = q(70, h)
    e = np.zeros((tfg.e_pad, h), np.float32)
    perm = tfg.graph.edge_perm.numpy()[:len(src)]
    e[:len(src)] = np.tile(e_orig, (2, 1))[perm]
    return SimpleNamespace(tfg=tfg, jfg=jfg, eq=q(tfg.n_pad, h),
                           ek=q(tfg.n_pad, h), e=e, w=q(h, o), b=q(o),
                           gwo=q(tfg.n_pad, o),
                           mask=np.asarray(tfg.edge_mask))


@pytest.mark.parametrize("kind", ["gelu", "ties", "gelu_noedge"])
def test_pure_max_matches_jax_xla_route(kind):
    import jax
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.ell as jell

    edge = kind != "gelu_noedge"
    if kind == "ties":
        c = tie_case()
        tact, jact = torch.relu, jax.nn.relu
    else:
        c = make_case("hub" if edge else "isolated", seed=2)
        tact, jact = sigmas(c, "gelu")
    scale = c.mask.astype(np.float32)  # the validity JAX's factory takes
    names = ("eq", "ek", "e", "w", "b") if edge else ("eq", "ek", "w", "b")
    ts = dict(zip(names, (_t(getattr(c, k)) for k in names)))
    out = tell.pure_ell_sir_aggregate_max(
        c.tfg, ts["eq"], ts["ek"], ts["w"], ts["b"], tact, e=ts.get("e"),
        edge_mask=torch.from_numpy(c.mask))
    (out * torch.from_numpy(c.gwo)).sum().backward()

    f = jell.make_ell_sir_aggregate_max(c.jfg, jact, with_edge=edge)
    e0 = jnp.zeros((0,), jnp.float32)

    def loss(*v):
        a = dict(zip(names, v))
        y = f(a["eq"], a["ek"], a.get("e", e0), jnp.asarray(scale), a["w"],
              a["b"])
        return jnp.sum(y * c.gwo), y

    (_, jout), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(getattr(c, k)) for k in names))
    got = (out.detach().numpy(), [ts[k].grad.numpy() for k in names])
    _compare(got, (jout, grads), names)
    if kind == "ties":  # the copies of an edge split its cotangent
        np.testing.assert_array_equal(got[0], np.asarray(jout))
        assert (np.asarray(grads[2]) != 0).any()


@pytest.fixture
def kernel_calls(monkeypatch):
    calls = []
    for name in dir(tkernels):
        if name.startswith("ell_") and name.endswith("_plain"):
            fn = getattr(tkernels, name)
            monkeypatch.setattr(tkernels, name, lambda *a, _n=name, _f=fn,
                                **k: (calls.append(_n), _f(*a, **k))[1])
    return calls


@pytest.mark.parametrize("agg", ["sum", "mean", "sym", "max"])
@pytest.mark.parametrize("edge,masked", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_sir_aggregate_routes_any_sigma_to_the_pure_route(agg, edge, masked,
                                                          kernel_calls):
    """A sigma outside the registry on a FastGraph, against JAX's
    ``sir_aggregate`` on its CPU route (the same XLA factories); no kernel
    runs. Mean under a mask divides by the kept in-edges, max takes the
    mask as validity."""
    import jax
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.message_passing as jmp

    c = make_case("hub", seed=3)
    names = ("eq", "ek") + (("e",) if edge else ()) + (
        ("w", "b") if agg == "max" else ())
    gw = c.gwo if agg == "max" else c.gw

    def kwargs(a, lib):
        kw = {}
        if edge:
            kw["e"] = a["e"]
        if agg == "max":
            kw.update(w_relation=a["w"], b_relation=a["b"])
        if masked:
            kw["edge_mask"] = lib(c.mask)
        return kw

    ts = dict(zip(names, (_t(getattr(c, k)) for k in names)))
    out = tmp.sir_aggregate(c.tfg, ts["eq"], ts["ek"], F.gelu, agg,
                            **kwargs(ts, torch.from_numpy))
    (out * torch.from_numpy(gw)).sum().backward()
    assert kernel_calls == []

    def loss(*v):
        a = dict(zip(names, v))
        y = jmp.sir_aggregate(c.jfg, a["eq"], a["ek"],
                              lambda z: jax.nn.gelu(z, approximate=False),
                              agg, **kwargs(a, jnp.asarray))
        return jnp.sum(y * gw), y

    (_, jout), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(getattr(c, k)) for k in names))
    _compare((out.detach().numpy(), [ts[k].grad.numpy() for k in names]),
             (jout, grads), names)


@pytest.mark.parametrize("agg", ["sym", "max"])
def test_mlp_sigma_gets_its_parameter_gradients(agg):
    """The pure route differentiates sigma by autograd, so an MLP sigma's
    weights get gradients: the same as through the CSR aggregate of the
    same graph, whose every step is autograd's."""
    c = make_case("hub", seed=4)
    grads = []
    for graph in (c.tfg, c.tfg.graph):
        mlp, _ = sigmas(c, "mlp")
        ts = [_t(a) for a in (c.eq, c.ek, c.e)]
        kw = dict(e=ts[2], edge_mask=torch.from_numpy(c.mask))
        if agg == "max":
            kw.update(w_relation=torch.from_numpy(c.w))
        out = tmp.sir_aggregate(graph, ts[0], ts[1], mlp, agg, **kw)
        gw = c.gwo if agg == "max" else c.gw
        (out * torch.from_numpy(gw)).sum().backward()
        grads.append([out.detach().numpy()]
                     + [t.grad.numpy() for t in ts]
                     + [p.grad.numpy() for p in mlp.parameters()])
    np.testing.assert_allclose(grads[0][0], grads[1][0], **FWD_TOL)
    for a, b in zip(grads[0][1:], grads[1][1:]):
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, **BWD_TOL)


def test_routing_is_logged_once_per_sigma(caplog):
    """The pure route is logged once per sigma; a registry sigma's route
    follows from its type and is not logged."""
    c = make_case("random", seed=5)
    eq, ek = torch.from_numpy(c.eq), torch.from_numpy(c.ek)

    def gelu_tanh(z):
        return F.gelu(z, approximate="tanh")

    leaky = tell.leaky_relu(0.2)
    with caplog.at_level(logging.INFO, logger="sir_gcn_tpu_torch.routing"):
        for _ in range(2):
            for act in (gelu_tanh, leaky, tell.centered_relu(0.5)):
                tmp.sir_aggregate(c.tfg, eq, ek, act, "sym")
    lines = [r.getMessage() for r in caplog.records
             if r.name == "sir_gcn_tpu_torch.routing"]
    assert lines == ["sigma routing: gelu_tanh -> pure-ell"]


def _closure_over(t):
    def gain_gelu(z):
        return F.gelu(z) * t
    return gain_gelu


@pytest.mark.parametrize("kind,pure", [
    ("F.gelu", False), ("lambda", False), ("torch.tanh", False),
    ("parameter-free module", False), ("mlp", True),
    ("closure over a tensor", True), ("partial with a tensor", True),
    ("bound method of a module", True), ("module with a buffer", True),
])
def test_only_a_sigma_holding_tensors_takes_the_pure_route_on_the_card(
        kind, pure):
    """On a CUDA device the pure route is JAX's XLA route: only a sigma
    that holds tensors takes it (JAX's ``make_jaxpr(act).consts``); a
    parameter-free sigma outside the registry raises, since JAX runs it on
    its Pallas kernels. On the CPU every such sigma takes the pure route,
    and a registry sigma resolves to itself on both."""
    import functools

    mlp, _ = sigmas(make_case("random"), "mlp")
    buffered = nn.Module()
    buffered.register_buffer("gain", torch.ones(H))
    act = {
        "F.gelu": F.gelu,
        "lambda": lambda z: F.gelu(z, approximate="tanh"),
        "torch.tanh": torch.tanh,
        "parameter-free module": nn.GELU(),
        "mlp": mlp,
        "closure over a tensor": _closure_over(torch.ones(H)),
        "partial with a tensor": functools.partial(torch.mul,
                                                   other=torch.ones(H)),
        "bound method of a module": mlp.forward,
        "module with a buffer": buffered,
    }[kind]
    card = torch.device("cuda")
    assert tell.resolve_activation(act, torch.device("cpu")) is None
    if pure:
        assert tell.resolve_activation(act, card) is None
    else:
        with pytest.raises(NotImplementedError, match="holds no tensor"):
            tell.resolve_activation(act, card)
    leaky = tell.leaky_relu(0.2)
    assert tell.resolve_activation(leaky, card) is leaky
