"""The port's segment ops and its CSR aggregate on a plain ``GraphBatch``
against the JAX package's (``sir_gcn_tpu/ops/segment.py`` and the generic
branch of ``sir_aggregate``, ``sir_aggregate_concat``,
``copy_src_aggregate``), forward and gradients.

The segment ops run on the graph's int32 dst ids, with ties, an empty
segment and a segment whose rows are all invalid (softmax's NaN trap:
its gradient must stay finite). The aggregates run on a padded graph with
isolated nodes and nodes whose every in-edge the mask drops: sum, mean,
sym and max, with and without an edge term and a DropEdge mask, with the
registry's leaky_relu and with a plain torch callable.

Tolerances are the JAX suite's: forward atol 2e-4 / rtol 1e-4, gradients
atol 3e-4 / rtol 1e-3. JAX is imported inside the tests.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sir_gcn_tpu_torch.ops.cuda.kernels as tkernels
import sir_gcn_tpu_torch.ops.ell as tell
import sir_gcn_tpu_torch.ops.message_passing as tmp
from sir_gcn_tpu_torch import build_graph
from sir_gcn_tpu_torch.ops import segment as tseg

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
H, O = 12, 7
N, N_EDGED = 40, 34  # nodes 34..39 have no edge
DROPPED = (5, 11)    # nodes whose every in-edge the mask drops


def _t(x):
    return torch.from_numpy(np.asarray(x).copy()).requires_grad_()


def _grads(fn, arrays, gw):
    """fn(*tensors), its value and the gradients of sum(out * gw)."""
    ts = [_t(a) for a in arrays]
    out = fn(*ts)
    (out * torch.from_numpy(gw)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_grads(fn, arrays, gw):
    import jax
    import jax.numpy as jnp

    def loss(*v):
        y = fn(*v)
        return jnp.sum(y * gw), y

    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(arrays))), has_aux=True)(
        *(jnp.asarray(a) for a in arrays))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _compare(got, want):
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    assert np.isfinite(got[0]).all()
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, **BWD_TOL, err_msg=str(i))


# ----------------------------------------------------------------------
# The segment ops
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def segs():
    """Sorted int32 ids over 9 segments: 3 has no row; 6's rows are all
    invalid; rows 0-2 and 10-11 repeat one value (exact ties)."""
    rng = np.random.default_rng(0)
    ids = np.sort(np.concatenate([rng.integers(0, 9, 40),
                                  np.full(4, 6)]))
    ids = ids[ids != 3].astype(np.int32)
    data = rng.normal(size=(len(ids), 5)).astype(np.float32)
    data[1:3] = data[0]
    data[10:12] = data[10]
    valid = rng.random(len(ids)) > 0.2
    valid[ids == 6] = False
    valid[:3] = True
    return SimpleNamespace(ids=ids, data=data, valid=valid, n=9,
                           gw=rng.normal(size=(9, 5)).astype(np.float32),
                           ge=rng.normal(size=(len(ids), 5)).astype(
                               np.float32))


@pytest.mark.parametrize("op", ["sum", "mean", "max", "softmax", "gather"])
def test_segment_ops_match_jax(segs, op):
    import jax.numpy as jnp
    from sir_gcn_tpu.ops import segment as jseg

    s = segs
    vt, vj = torch.from_numpy(s.valid), jnp.asarray(s.valid)
    it, ij = torch.from_numpy(s.ids), jnp.asarray(s.ids)
    counts = np.bincount(s.ids[s.valid], minlength=s.n).astype(np.float32)
    ops = {
        "sum": (lambda d: tseg.segment_sum(d, it, s.n),
                lambda d: jseg.segment_sum(d, ij, s.n), s.gw),
        "mean": (lambda d: tseg.segment_mean(
                     torch.where(vt[:, None], d, 0.0), it, s.n,
                     torch.from_numpy(counts)),
                 lambda d: jseg.segment_mean(
                     jnp.where(vj[:, None], d, 0.0), ij, s.n,
                     jnp.asarray(counts)), s.gw),
        "max": (lambda d: tseg.segment_max(d, it, s.n, vt),
                lambda d: jseg.segment_max(d, ij, s.n, vj), s.gw),
        "softmax": (lambda d: tseg.segment_softmax(d, it, s.n, vt),
                    lambda d: jseg.segment_softmax(d, ij, s.n, vj), s.ge),
        "gather": (lambda d: tseg.gather_rows(d, it),
                   lambda d: jseg.gather_rows(d, ij), s.ge[:, :5]),
    }
    tfn, jfn, gw = ops[op]
    data = s.data[:s.n] if op == "gather" else s.data
    got = _grads(tfn, [data], gw)
    _compare(got, _jax_grads(jfn, [data], gw))
    if op == "max":  # the empty and the all-invalid segment read 0; the
        # tied rows 0-2 share their segment's cotangent equally
        assert (got[0][[3, 6]] == 0).all()
        seg0 = s.ids == s.ids[0]
        if np.argmax(np.where(s.valid[seg0], s.data[seg0, 0], -np.inf)) == 0:
            np.testing.assert_allclose(got[1][0][:3, 0], s.gw[s.ids[0], 0] / 3)
    if op == "softmax":
        assert (got[0][~s.valid] == 0).all()
        sums = np.zeros((s.n, 5))
        np.add.at(sums, s.ids, got[0])
        np.testing.assert_allclose(sums[[i for i in range(s.n)
                                         if i not in (3, 6)]], 1.0,
                                   rtol=1e-5)


# ----------------------------------------------------------------------
# The CSR aggregate on a plain GraphBatch
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def csr():
    from sir_gcn_tpu import build_graph as j_build_graph

    rng = np.random.default_rng(1)
    src = rng.integers(0, N_EDGED, 200)
    dst = rng.integers(0, N_EDGED, 200)
    pad = dict(n_pad=48, e_pad=256)
    tg = build_graph(src, dst, N, **pad)
    jg = j_build_graph(src, dst, N, **pad)
    mask = (rng.random(tg.e_pad) >= 0.25) & ~np.isin(tg.dst.numpy(),
                                                     DROPPED)
    x = lambda *shape, k=1.0: (rng.normal(size=shape) * k).astype(np.float32)
    return SimpleNamespace(
        tg=tg, jg=jg, mask=mask, eq=x(tg.n_pad, H), ek=x(tg.n_pad, H),
        e=x(tg.e_pad, H), w=x(H, O, k=H ** -0.5), b=x(O),
        gw=x(tg.n_pad, H), gwo=x(tg.n_pad, O),
        scale=rng.random(tg.e_pad).astype(np.float32))


def sigma(kind: str):
    """(port sigma, JAX sigma): the registry's leaky_relu(0.2), or a plain
    callable."""
    import jax

    if kind == "registry":
        return tell.leaky_relu(0.2), lambda z: jax.nn.leaky_relu(z, 0.2)
    return (lambda z: torch.tanh(z) * z,
            lambda z: jax.numpy.tanh(z) * z)


@pytest.mark.parametrize("agg", ["sum", "mean", "sym", "max"])
@pytest.mark.parametrize("edge,masked,kind", [
    (False, False, "registry"), (True, False, "callable"),
    (False, True, "callable"), (True, True, "registry")])
def test_csr_aggregate_matches_jax(csr, agg, edge, masked, kind,
                                   monkeypatch):
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.message_passing as jmp

    monkeypatch.setattr(tkernels, "on_cuda", lambda device: pytest.fail(
        "the CSR aggregate reached a kernel wrapper"))
    c = csr
    tact, jact = sigma(kind)
    names = ("eq", "ek") + (("e",) if edge else ()) + (
        ("w", "b") if agg == "max" else ())

    def run(graph, act, lib, mp):
        def fn(*v):
            a = dict(zip(names, v))
            kw = {"e": a["e"]} if edge else {}
            if agg == "max":
                kw.update(w_relation=a["w"], b_relation=a["b"])
            if masked:
                kw["edge_mask"] = lib(c.mask)
            return mp.sir_aggregate(graph, a["eq"], a["ek"], act, agg, **kw)
        return fn

    arrays = [getattr(c, k) for k in names]
    gw = c.gwo if agg == "max" else c.gw
    got = _grads(run(c.tg, tact, torch.from_numpy, tmp), arrays, gw)
    _compare(got, _jax_grads(run(c.jg, jact, jnp.asarray, jmp), arrays, gw))
    empty = list(range(N_EDGED, N)) + (list(DROPPED) if masked else [])
    assert (got[0][empty] == 0).all()


@pytest.mark.parametrize("agg", ["sum", "mean", "sym", "max"])
@pytest.mark.parametrize("edge,masked", [(False, False), (True, True)])
def test_sir_aggregate_concat_matches_jax(csr, agg, edge, masked):
    """An MLP message over [eq[dst] || ek[src] (|| e)], weights shared."""
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.message_passing as jmp

    c = csr
    rng = np.random.default_rng(2)
    din = 3 * H if edge else 2 * H
    w1 = (rng.normal(size=(din, 16)) / np.sqrt(din)).astype(np.float32)
    w2 = (rng.normal(size=(16, H)) / 4).astype(np.float32)
    tw1, tw2 = torch.from_numpy(w1), torch.from_numpy(w2)
    names = ("eq", "ek") + (("e",) if edge else ())

    def run(graph, msg, lib, mp):
        def fn(*v):
            a = dict(zip(names, v))
            return mp.sir_aggregate_concat(
                graph, a["eq"], a["ek"], msg, agg, e=a.get("e"),
                edge_mask=lib(c.mask) if masked else None)
        return fn

    arrays = [getattr(c, k) for k in names]
    got = _grads(run(c.tg, lambda x: torch.tanh(x @ tw1) @ tw2,
                     torch.from_numpy, tmp), arrays, c.gw)
    want = _jax_grads(run(c.jg, lambda x: jnp.tanh(x @ w1) @ w2,
                          jnp.asarray, jmp), arrays, c.gw)
    _compare(got, want)


@pytest.mark.parametrize("agg,scaled,masked", [
    ("sum", False, False), ("sum", True, True), ("mean", True, False),
    ("mean", False, True), ("max", False, True), ("sym", True, False)])
def test_copy_src_aggregate_matches_jax(csr, agg, scaled, masked):
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.message_passing as jmp

    c = csr

    def run(graph, lib, mp):
        return lambda x: mp.copy_src_aggregate(
            graph, x, agg, edge_scale=lib(c.scale) if scaled else None,
            edge_mask=lib(c.mask) if masked else None)

    got = _grads(run(c.tg, torch.from_numpy, tmp), [c.eq], c.gw)
    _compare(got, _jax_grads(run(c.jg, jnp.asarray, jmp), [c.eq], c.gw))


def test_csr_aggregate_on_fast_graph_arrays(csr):
    """``sir_aggregate_concat`` and ``copy_src_aggregate`` read a FastGraph
    as its GraphBatch, as the JAX package's do."""
    c = csr
    fg = tell.build_fast_graph(c.tg)
    x = torch.from_numpy(c.eq)
    for fn in (lambda g: tmp.copy_src_aggregate(g, x, "mean"),
               lambda g: tmp.sir_aggregate_concat(g, x, x, torch.tanh,
                                                  "sym")):
        np.testing.assert_array_equal(fn(fg).numpy(), fn(c.tg).numpy())
