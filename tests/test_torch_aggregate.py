"""The port's ``sir_aggregate`` (static sum/mean/sym scales) and its
gradients, against the JAX package's Pallas route in interpret mode and
its ``sir_aggregate`` on the same FastGraph. Tolerances are the JAX
suite's: forward atol 2e-4 / rtol 1e-4, gradients atol 3e-4 / rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sir_gcn_tpu.ops.ell as jell
import sir_gcn_tpu.ops.message_passing as jmp
from sir_gcn_tpu import build_graph as j_build_graph
import sir_gcn_tpu_torch.ops.cuda.kernels as tkernels
import sir_gcn_tpu_torch.ops.ell as tell
import sir_gcn_tpu_torch.ops.message_passing as tmp
from sir_gcn_tpu_torch import build_graph as t_build_graph

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
H = 24


def jax_act(x):
    return jax.nn.leaky_relu(x, 0.2)


def make_graphs(graph: str):
    rng = np.random.default_rng(3)
    if graph == "hub":  # node 0 takes 300 in-edges: the hub stage 2
        n = 40
        src = rng.integers(0, n, 380)
        dst = np.concatenate([np.zeros(300, np.int64),
                              rng.integers(0, n, 80)])
        pad = {}
    else:
        n = 50
        src, dst = rng.integers(0, n, 260), rng.integers(0, n, 260)
        pad = dict(n_pad=64, e_pad=320)
    kw = dict(max_budget=64)
    jfg = jell.build_fast_graph(j_build_graph(src, dst, n, **pad), **kw)
    tfg = tell.build_fast_graph(t_build_graph(src, dst, n, **pad), **kw)
    x = rng.normal(size=(3, tfg.n_pad, H)).astype(np.float32)
    return jfg, tfg, x[0], x[1], x[2]


@pytest.fixture
def edge_dtype():
    def use(name):
        tmp.set_edge_dtype(torch.bfloat16 if name == "bf16" else None)
        return jnp.bfloat16 if name == "bf16" else None
    yield use
    tmp.set_edge_dtype(None)


def _torch_run(tfg, eq, ek, w, agg):
    teq = torch.from_numpy(eq).requires_grad_()
    tek = torch.from_numpy(ek).requires_grad_()
    out = tmp.sir_aggregate(tfg, teq, tek, tell.leaky_relu(0.2), agg)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), teq.grad.numpy(), tek.grad.numpy()


def _jax_grads(f, eq, ek, w):
    def loss(a, b):
        return jnp.sum(f(a, b) * jnp.asarray(w))
    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(eq), jnp.asarray(ek))


@pytest.mark.parametrize("graph,agg,dt", [
    ("random", "sum", "f32"), ("random", "mean", "f32"),
    ("random", "sym", "f32"), ("hub", "sum", "f32"), ("hub", "mean", "f32"),
    ("hub", "sym", "f32"), ("random", "sym", "bf16"), ("hub", "sym", "bf16"),
])
def test_sir_aggregate_matches_jax_pallas(graph, agg, dt, edge_dtype):
    jdt = edge_dtype(dt)
    jfg, tfg, eq, ek, w = make_graphs(graph)
    out, geq, gek = _torch_run(tfg, eq, ek, w, agg)

    pal = jell.make_ell_sir_aggregate_pallas(
        jfg, jax_act, agg, interpret=True, static_scale=True,
        edge_dtype=jdt)
    e0, s0 = jnp.zeros((0,), jnp.float32), jnp.zeros((jfg.e_pad,))
    f = lambda a, b: pal(a, b, e0, s0)
    np.testing.assert_allclose(out, np.asarray(f(jnp.asarray(eq),
                                                 jnp.asarray(ek))),
                               **FWD_TOL)
    jgeq, jgek = _jax_grads(f, eq, ek, w)
    np.testing.assert_allclose(geq, np.asarray(jgeq), **BWD_TOL)
    np.testing.assert_allclose(gek, np.asarray(jgek), **BWD_TOL)

    if dt == "f32":  # the JAX sir_aggregate on the CPU: the pure ELL route
        f = lambda a, b: jmp.sir_aggregate(jfg, a, b, jax_act, agg)
        np.testing.assert_allclose(
            out, np.asarray(f(jnp.asarray(eq), jnp.asarray(ek))), **FWD_TOL)
        jgeq, jgek = _jax_grads(f, eq, ek, w)
        np.testing.assert_allclose(geq, np.asarray(jgeq), **BWD_TOL)
        np.testing.assert_allclose(gek, np.asarray(jgek), **BWD_TOL)


def test_grad_and_no_grad_paths_reach_their_kernels(monkeypatch):
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name + ("2" if k.get("derivative") else ""))
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tkernels, "ell_act_reduce_plain",
                        spy("act_reduce", tkernels.ell_act_reduce_plain))
    monkeypatch.setattr(tkernels, "ell_src_bwd_plain",
                        spy("src_bwd", tkernels.ell_src_bwd_plain))
    _, tfg, eq, ek, w = make_graphs("random")
    act = tell.leaky_relu(0.2)

    with torch.no_grad():
        tmp.sir_aggregate(tfg, torch.from_numpy(eq), torch.from_numpy(ek),
                          act, "sym")
    assert calls == ["act_reduce"]
    calls.clear()
    tmp.sir_aggregate(tfg, torch.from_numpy(eq), torch.from_numpy(ek), act,
                      "sym")  # nothing needs a gradient
    assert calls == ["act_reduce"]
    calls.clear()
    _torch_run(tfg, eq, ek, w, "sym")
    assert calls == ["act_reduce2", "src_bwd"]


def test_unported_branches_raise():
    """What still raises: a graph of no type sir_aggregate knows (the
    HaloGraph's route is ported, in tests/test_torch_dist_aggregate.py).
    The branches that raised before this port had them now compute, held
    against the
    JAX package's ``sir_aggregate`` on the same graph (its CPU route): a
    sigma outside the registry (the pure ELL route), with sum and with
    max, a plain ``GraphBatch`` (the CSR aggregate), and a DropEdge mask
    (dynamic scales)."""
    jfg, tfg, eq, ek, w = make_graphs("random")
    rng = np.random.default_rng(4)
    wr = rng.normal(size=(H, 9)).astype(np.float32)
    mask = rng.random(tfg.e_pad) >= 0.3
    act = tell.leaky_relu(0.2)
    with pytest.raises(NotImplementedError, match="not a GraphBatch"):
        tmp.sir_aggregate(object(), torch.from_numpy(eq),
                          torch.from_numpy(ek), act, "sum")

    cases = [  # (port graph, JAX graph, port sigma, JAX sigma, agg, kw)
        (tfg, jfg, torch.tanh, jnp.tanh, "sum", {}),
        (tfg, jfg, torch.tanh, jnp.tanh, "max", {"w_relation": wr}),
        (tfg.graph, jfg.graph, act, jax_act, "sum", {}),
        (tfg, jfg, act, jax_act, "sum", {"edge_mask": mask}),
    ]
    for tg, jg, tact, jact, agg, kw in cases:
        gw = w if agg == "sum" else w[:, :9]
        teq = torch.from_numpy(eq).requires_grad_()
        tek = torch.from_numpy(ek).requires_grad_()
        out = tmp.sir_aggregate(tg, teq, tek, tact, agg, **{
            k: torch.from_numpy(v) for k, v in kw.items()})
        (out * torch.from_numpy(gw)).sum().backward()
        f = lambda a, b: jmp.sir_aggregate(jg, a, b, jact, agg, **{
            k: jnp.asarray(v) for k, v in kw.items()})
        np.testing.assert_allclose(
            out.detach().numpy(),
            np.asarray(f(jnp.asarray(eq), jnp.asarray(ek))), **FWD_TOL)
        jgeq, jgek = _jax_grads(f, eq, ek, gw)
        np.testing.assert_allclose(teq.grad.numpy(), np.asarray(jgeq),
                                   **BWD_TOL)
        np.testing.assert_allclose(tek.grad.numpy(), np.asarray(jgek),
                                   **BWD_TOL)
