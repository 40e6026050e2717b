"""The port's edge features against the JAX package's.

* the plan's edge -> slot maps ``edge2dst_slot`` / ``edge2src_slot``,
  array-equal to JAX's;
* the plain versions of the edge-term forms of ``ell_act_reduce``,
  ``ell_act_reduce2`` and ``ell_src_bwd`` (with its per-edge cotangent
  g_e) and of the fused-edge kernels ``ell_edge_act_reduce2`` and
  ``ell_edge_src_bwd``, against the Pallas kernels run in interpret mode
  bucket by bucket, with a fifth of the slot scales zeroed;
* the fused route (``sir_aggregate(e_basis=..., w_edge=...)``) with its
  gradients for eq, ek and W_E against
  ``make_ell_sir_aggregate_pallas_fused_edge(interpret=True)``, and the
  generic route (``sir_aggregate(e=...)``) with g_e against
  ``make_ell_sir_aggregate_pallas(with_edge=True, interpret=True)``, on
  random, hub (stage 2) and isolated-node graphs, sum/mean/sym, f32/bf16;
* ``SIREConv`` on both routes, with ``linear_edge`` and with an ``Embed``
  edge encoder, against the JAX ``SIREConv`` through the weight bridge;
* which kernels each route reaches, and what still raises;
* the decode of ``ell_edge_layout``'s codes (the paths of #7 and #8);
* shapes past a block's shared memory (De = 500 in #7, De = 60 in #8 at
  H = 128), which the kernels take on their columns path, against the
  Pallas kernels.

Tolerances are the JAX suite's: forward atol 2e-4 / rtol 1e-4, gradients
atol 3e-4 / rtol 1e-3. g_WE, a sum over every slot, is held at GW_TOL:
atol 3e-4 plus 1e-5 of its largest entry, rtol 1e-3. bf16 is rounded at
the same points in both packages.

The ``cuda`` tests compare each kernel with its plain version on the card
(on both of #7's and #8's paths, the register path and the shared-memory
loop, with the path each shape takes; and on plans with odd row counts,
rows of more than 32 slots, budgets off multiples of 8, zero scales and a
basis off 16-byte alignment), ask two launches of #7 and #8 for equal
bits, and skip where there is no card. JAX is imported inside the tests that use
it, so that the card's tests run where JAX is not installed
(``pytest -m cuda --noconftest tests/test_torch_edge.py``).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sir_gcn_tpu_torch.ops.cuda.kernels as tkernels
import sir_gcn_tpu_torch.ops.ell as tell
import sir_gcn_tpu_torch.ops.message_passing as tmp
from sir_gcn_tpu_torch import build_graph
from sir_gcn_tpu_torch.models import Embed, SIREConv
from sir_gcn_tpu_torch.ops.cuda import (
    LAUNCHES,
    EdgeLayout,
    decode_edge_layout,
    ell_act_reduce2_edge,
    ell_act_reduce_edge,
    ell_act_reduce_plain,
    ell_edge_act_reduce2,
    ell_edge_act_reduce2_plain,
    ell_edge_layout,
    ell_edge_src_bwd,
    ell_edge_src_bwd_plain,
    ell_src_bwd_edge,
    ell_src_bwd_plain,
    reset_launch_counts,
)
from sir_gcn_tpu_torch.utils import load_jax_variables
from sir_gcn_tpu_torch.utils.convert import _slots

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
BF16_STEP = dict(atol=3e-4, rtol=2.0 ** -7)
H = 24
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
ACT = tell.leaky_relu(0.2)


def gw_tol(want) -> dict:
    return dict(atol=3e-4 + 1e-5 * float(np.abs(np.asarray(want)).max()),
                rtol=1e-3)


# the port's sigma of each case name (leaky_relu the default)
ACTS = {"leaky_relu": ACT, "gelu": tell.gelu()}


def jax_side(dt: str, act: str = "leaky_relu"):
    """The JAX package's ell module, Pallas kernels, sigma and edge dtype."""
    import jax
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.ell as jell
    from sir_gcn_tpu.ops import pallas

    jact = {"leaky_relu": lambda x: jax.nn.leaky_relu(x, 0.2),
            "gelu": lambda x: jax.nn.gelu(x, approximate=False),
            "tanh": jnp.tanh}[act]
    return jell, pallas, jact, {"f32": None, "bf16": jnp.bfloat16}[dt]


def graph_edges(graph: str, rng):
    """(src, dst, n, max_budget) of the test graphs."""
    if graph == "hub":  # node 0 takes 300 in-edges: the hub stage 2
        n = 40
        return (rng.integers(0, n, 360),
                np.concatenate([np.zeros(300, np.int64),
                                rng.integers(0, n, 60)]), n, 64)
    if graph == "isolated":  # nodes 30..59 have no edge
        return rng.integers(0, 30, 150), rng.integers(0, 30, 150), 60, 16
    n = 40  # budgets 1..16, with 10, 12, 14
    return rng.integers(0, n, 203), rng.integers(0, n, 203), n, 16


def make_case(graph: str, de: int, h: int = H, seed: int = 0,
              device="cpu", with_jax: bool = True):
    """Both packages' FastGraphs of one graph, node tables eq/ek/g [N, H],
    an edge table e [E_pad, H], an edge basis [E_pad, De] and W_E [De, H],
    and slot scales (sym) with a fifth of the slots zeroed."""
    rng = np.random.default_rng(seed)
    src, dst, n, mb = graph_edges(graph, rng)
    tfg = tell.build_fast_graph(build_graph(src, dst, n, device=device),
                                max_budget=mb)
    jfg = None
    if with_jax:
        import sir_gcn_tpu.ops.ell as jell
        from sir_gcn_tpu import build_graph as j_build_graph

        jfg = jell.build_fast_graph(j_build_graph(src, dst, n),
                                    max_budget=mb)
    eq, ek, g = (rng.normal(size=(tfg.n_pad, h)).astype(np.float32)
                 for _ in range(3))
    e = rng.normal(size=(tfg.e_pad, h)).astype(np.float32)
    eb = rng.normal(size=(tfg.e_pad, de)).astype(np.float32)
    we = (rng.normal(size=(de, h)) * 0.3).astype(np.float32)
    scales = {}
    for side in ("dst", "src"):
        s = getattr(tfg, f"{side}_slot_scales")["sym"].cpu().numpy()
        scales[side] = (s * (rng.random(s.shape) > 0.2)).astype(np.float32)
    return SimpleNamespace(tfg=tfg, jfg=jfg, eq=eq, ek=ek, g=g, e=e, eb=eb,
                           we=we, scales=scales)


def _t(x, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(np.asarray(x)).to(device=device, dtype=dtype)


@pytest.fixture
def edge_dtype():
    def use(name):
        tmp.set_edge_dtype(DTYPES[name])
    yield use
    tmp.set_edge_dtype(None)


# ----------------------------------------------------------------------
# The plan's edge -> slot maps
# ----------------------------------------------------------------------

@pytest.mark.parametrize("graph", ["random", "hub", "isolated"])
def test_edge_slot_maps_match_jax(graph):
    c = make_case(graph, de=5)
    for name in ("edge2dst_slot", "edge2src_slot"):
        got = getattr(c.tfg, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(c.jfg, name)))
    # each valid edge sits in the slot the map names, in both plans
    valid = c.tfg.edge_mask.numpy()
    for plan, m in ((c.tfg.dst_plan, c.tfg.edge2dst_slot),
                    (c.tfg.src_plan, c.tfg.edge2src_slot)):
        slots = m.numpy()[valid]
        np.testing.assert_array_equal(plan.host["slot_edge"][slots],
                                      np.nonzero(valid)[0])
        assert (plan.host["slot_valid"][slots] == 1).all()


# ----------------------------------------------------------------------
# Plain versions against the Pallas kernels
# ----------------------------------------------------------------------

def _jnp(x):
    import jax.numpy as jnp

    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _cast(x, jdt):
    return x if jdt is None else x.astype(jdt)


def _add_cast(a, b, jdt):
    import jax.numpy as jnp

    if jdt is None:
        return a + b
    return (a.astype(jnp.float32) + b.astype(jnp.float32)).astype(jdt)


def _cases(*cases):
    """leaky_relu cases under their own ids, and erf-GELU cases (the last
    field "gelu") with it appended."""
    return [pytest.param(*c, id="-".join(map(str, c[:-1]))
                         + ("-gelu" if c[-1] == "gelu" else ""))
            for c in cases]


@pytest.mark.parametrize("graph,dt,act", _cases(
    ("random", "f32", "leaky_relu"), ("hub", "bf16", "leaky_relu"),
    ("isolated", "bf16", "leaky_relu"), ("random", "f32", "gelu"),
    ("hub", "bf16", "gelu")))
def test_edge_term_plains_match_pallas(graph, dt, act):
    import jax.numpy as jnp

    jell, pallas, jact, jdt = jax_side(dt, act)
    c = make_case(graph, de=5, seed=1)
    fg, tdt = c.tfg, DTYPES[dt]
    plan, splan = fg.dst_plan, fg.src_plan
    sd, ss = c.scales["dst"], c.scales["src"]
    fwd = (_t(c.eq), _t(c.ek, tdt), fg.dst_slot_srcnode, _t(sd), plan.row_key,
           plan.row_ptr, ACTS[act])
    edge = dict(e=_t(c.e, tdt), slot_edge=plan.slot_edge)

    ekg = _add_cast(jnp.take(_cast(_jnp(c.ek), jdt), _jnp(fg.dst_slot_srcnode),
                             axis=0),
                    jnp.take(_cast(_jnp(c.e), jdt), _jnp(plan.slot_edge),
                             axis=0), jdt)
    eq_rows = jnp.take(_jnp(c.eq), _jnp(plan.row_key), axis=0)
    want1, want2, want2s = [], [], []
    for b, nr, so, ro in jell._bucket_offsets(plan.buckets1):
        args = (ekg[so:so + b * nr], eq_rows[ro:ro + nr],
                _jnp(sd[so:so + b * nr]).reshape(nr, b), b, jact)
        want1.append(np.asarray(pallas.bucket_bcast_act_reduce(
            *args, interpret=True)))
        r, s = pallas.bucket_bcast_act_reduce2(*args, interpret=True)
        want2.append(np.asarray(r))
        want2s.append(np.asarray(s))
    np.testing.assert_allclose(ell_act_reduce_edge(*fwd, **edge).numpy(),
                               np.concatenate(want1), **FWD_TOL)
    rows, srows = ell_act_reduce2_edge(*fwd, **edge)
    np.testing.assert_allclose(rows.numpy(), np.concatenate(want2), **FWD_TOL)
    np.testing.assert_allclose(srows.numpy(), np.concatenate(want2s),
                               **FWD_TOL)

    rows, g_e = ell_src_bwd_edge(
        _t(c.eq, tdt), _t(c.g, tdt), _t(c.ek), fg.src_slot_dstnode, _t(ss),
        splan.row_key, splan.row_ptr, ACTS[act], _t(c.e, tdt),
        splan.slot_edge, fg.edge2src_slot, fg.edge_mask)
    idx = _jnp(fg.src_slot_dstnode)
    eqg = _add_cast(jnp.take(_cast(_jnp(c.eq), jdt), idx, axis=0),
                    jnp.take(_cast(_jnp(c.e), jdt), _jnp(splan.slot_edge),
                             axis=0), jdt)
    gg = jnp.take(_cast(_jnp(c.g), jdt), idx, axis=0)
    ek_rows = jnp.take(_jnp(c.ek), _jnp(splan.row_key), axis=0)
    want, gzs = [], []
    for b, nr, so, ro in jell._bucket_offsets(splan.buckets1):
        r, gz = pallas.bucket_src_bwd(
            eqg[so:so + b * nr], ek_rows[ro:ro + nr],
            _jnp(ss[so:so + b * nr]).reshape(nr, b), gg[so:so + b * nr], b,
            jact, interpret=True, gz_dtype=jdt or jnp.float32)
        want.append(np.asarray(r))
        gzs.append(gz)
    np.testing.assert_allclose(rows.numpy(), np.concatenate(want), **BWD_TOL)
    want_ge = jell._edge_cotangent(jnp.concatenate(gzs),
                                   _jnp(fg.edge2src_slot),
                                   _jnp(fg.edge_mask))
    assert g_e.dtype == torch.float32
    np.testing.assert_allclose(g_e.numpy(), np.asarray(want_ge), **BWD_TOL)


def check_fused_plains(c, dt: str, act: str, tact=None) -> None:
    """#7 and #8 (the plain versions on the CPU) against
    ``bucket_edge_act_reduce2`` and ``bucket_edge_src_bwd`` in interpret
    mode, bucket by bucket, on case ``c`` with edges of ``dt`` and the
    sigma ``act`` (the port's ``tact``, ACTS[act] by default)."""
    import jax.numpy as jnp

    jell, pallas, jact, jdt = jax_side(dt, act)
    tact = tact or ACTS[act]
    fg, tdt = c.tfg, DTYPES[dt]
    plan, splan = fg.dst_plan, fg.src_plan
    sd, ss = c.scales["dst"], c.scales["src"]

    rows, srows = ell_edge_act_reduce2(
        _t(c.eq), _t(c.ek, tdt), _t(c.eb), _t(c.we), fg.dst_slot_srcnode,
        plan.slot_edge, _t(sd), plan.row_key, plan.row_ptr, tact)
    ekg = jnp.take(_cast(_jnp(c.ek), jdt), _jnp(fg.dst_slot_srcnode), axis=0)
    egr = jnp.take(_jnp(c.eb), _jnp(plan.slot_edge), axis=0)
    eq_rows = jnp.take(_jnp(c.eq), _jnp(plan.row_key), axis=0)
    want, want_s = [], []
    for b, nr, so, ro in jell._bucket_offsets(plan.buckets1):
        r, s = pallas.bucket_edge_act_reduce2(
            ekg[so:so + b * nr], egr[so:so + b * nr], eq_rows[ro:ro + nr],
            _jnp(sd[so:so + b * nr]).reshape(nr, b), _jnp(c.we), b, jact,
            interpret=True)
        want.append(np.asarray(r))
        want_s.append(np.asarray(s))
    np.testing.assert_allclose(rows.numpy(), np.concatenate(want), **FWD_TOL)
    np.testing.assert_allclose(srows.numpy(), np.concatenate(want_s),
                               **FWD_TOL)

    rows, g_we = ell_edge_src_bwd(
        _t(c.eq, tdt), _t(c.g, tdt), _t(c.ek), _t(c.eb), _t(c.we),
        fg.src_slot_dstnode, splan.slot_edge, _t(ss), splan.row_key,
        splan.row_ptr, tact)
    idx = _jnp(fg.src_slot_dstnode)
    eqg = jnp.take(_cast(_jnp(c.eq), jdt), idx, axis=0)
    gg = jnp.take(_cast(_jnp(c.g), jdt), idx, axis=0)
    egr = jnp.take(_jnp(c.eb), _jnp(splan.slot_edge), axis=0)
    ek_rows = jnp.take(_jnp(c.ek), _jnp(splan.row_key), axis=0)
    want, gwes = [], []
    for b, nr, so, ro in jell._bucket_offsets(splan.buckets1):
        r, gwe = pallas.bucket_edge_src_bwd(
            eqg[so:so + b * nr], egr[so:so + b * nr], ek_rows[ro:ro + nr],
            _jnp(ss[so:so + b * nr]).reshape(nr, b), gg[so:so + b * nr],
            _jnp(c.we), b, jact, interpret=True)
        want.append(np.asarray(r))
        gwes.append(np.asarray(gwe))
    np.testing.assert_allclose(rows.numpy(), np.concatenate(want), **BWD_TOL)
    want_gwe = sum(gwes)
    np.testing.assert_allclose(g_we.numpy(), want_gwe, **gw_tol(want_gwe))


@pytest.mark.parametrize("graph,de,dt,act", _cases(
    ("random", 5, "f32", "leaky_relu"), ("hub", 16, "bf16", "leaky_relu"),
    ("isolated", 16, "f32", "leaky_relu"), ("random", 5, "f32", "gelu"),
    ("hub", 16, "bf16", "gelu")))
def test_fused_edge_plains_match_pallas(graph, de, dt, act):
    check_fused_plains(make_case(graph, de=de, seed=2), dt, act)


# ----------------------------------------------------------------------
# The two routes of sir_aggregate against the JAX routes
# ----------------------------------------------------------------------

def _port_grads(c, agg, w, act=ACT, **edge):
    teq, tek = _t(c.eq).requires_grad_(), _t(c.ek).requires_grad_()
    out = tmp.sir_aggregate(c.tfg, teq, tek, act, agg, **edge)
    (out * _t(w)).sum().backward()
    return out.detach().numpy(), teq.grad.numpy(), tek.grad.numpy()


@pytest.mark.parametrize("graph,agg,dt,de", [
    ("random", "sum", "f32", 5), ("random", "mean", "f32", 16),
    ("random", "sym", "bf16", 16), ("hub", "sym", "f32", 16),
    ("hub", "sum", "bf16", 5), ("hub", "mean", "f32", 5),
    ("isolated", "mean", "bf16", 5), ("isolated", "sym", "f32", 16),
])
def test_fused_route_matches_jax(graph, agg, dt, de, edge_dtype):
    import jax
    import jax.numpy as jnp

    jell, _, jact, jdt = jax_side(dt)
    edge_dtype(dt)
    c = make_case(graph, de=de, seed=3)
    w = np.random.default_rng(4).normal(size=c.eq.shape).astype(np.float32)
    twe = _t(c.we).requires_grad_()
    out, geq, gek = _port_grads(c, agg, w, e_basis=_t(c.eb), w_edge=twe)

    f = jell.make_ell_sir_aggregate_pallas_fused_edge(
        c.jfg, jact, agg, interpret=True, edge_dtype=jdt, static_scale=True)
    s0 = jnp.zeros((c.jfg.e_pad,), jnp.float32)
    eb = jnp.asarray(c.eb)
    np.testing.assert_allclose(out, np.asarray(f(c.eq, c.ek, eb, c.we, s0)),
                               **FWD_TOL)
    want = jax.grad(lambda a, b, m: jnp.sum(f(a, b, eb, m, s0) * w),
                    argnums=(0, 1, 2))(c.eq, c.ek, c.we)
    np.testing.assert_allclose(geq, np.asarray(want[0]), **BWD_TOL)
    np.testing.assert_allclose(gek, np.asarray(want[1]), **BWD_TOL)
    np.testing.assert_allclose(twe.grad.numpy(), np.asarray(want[2]),
                               **gw_tol(want[2]))


@pytest.mark.parametrize("graph,agg,dt", [
    ("random", "sum", "f32"), ("random", "sym", "bf16"),
    ("hub", "mean", "f32"), ("hub", "sym", "bf16"),
    ("isolated", "sum", "bf16"), ("isolated", "mean", "f32"),
])
def test_generic_edge_route_matches_jax(graph, agg, dt, edge_dtype):
    import jax
    import jax.numpy as jnp

    jell, _, jact, jdt = jax_side(dt)
    edge_dtype(dt)
    c = make_case(graph, de=5, seed=5)
    w = np.random.default_rng(6).normal(size=c.eq.shape).astype(np.float32)
    te = _t(c.e).requires_grad_()
    out, geq, gek = _port_grads(c, agg, w, e=te)

    f = jell.make_ell_sir_aggregate_pallas(
        c.jfg, jact, agg, with_edge=True, interpret=True, edge_dtype=jdt,
        static_scale=True)
    s0 = jnp.zeros((c.jfg.e_pad,), jnp.float32)
    np.testing.assert_allclose(out, np.asarray(f(c.eq, c.ek, c.e, s0)),
                               **FWD_TOL)
    want = jax.grad(lambda a, b, e: jnp.sum(f(a, b, e, s0) * w),
                    argnums=(0, 1, 2))(c.eq, c.ek, c.e)
    for got, ref in zip((geq, gek, te.grad.numpy()), want):
        np.testing.assert_allclose(got, np.asarray(ref), **BWD_TOL)
    with torch.no_grad():  # the edge-term form of #1
        np.testing.assert_allclose(
            tmp.sir_aggregate(c.tfg, _t(c.eq), _t(c.ek), ACT, agg,
                              e=_t(c.e)).numpy(), out, **FWD_TOL)


@pytest.mark.parametrize("graph", ["random", "hub"])
def test_e_basis_route_equals_e_route(graph):
    """The fused route computes the generic route of e = e_basis @ w_edge,
    gradients included (g_WE = e_basis^T g_e), in f32 (in bf16 the generic
    route rounds e, the fused route never does)."""
    c = make_case(graph, de=6, seed=7, with_jax=False)
    w = np.random.default_rng(8).normal(size=c.eq.shape).astype(np.float32)
    eb = _t(c.eb)
    twe = _t(c.we).requires_grad_()
    a = _port_grads(c, "sym", w, e_basis=eb, w_edge=twe)
    te = (eb @ _t(c.we)).requires_grad_()
    b = _port_grads(c, "sym", w, e=te)
    np.testing.assert_allclose(a[0], b[0], **FWD_TOL)
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_allclose(x, y, **BWD_TOL)
    want = (eb.T @ te.grad).numpy()
    np.testing.assert_allclose(twe.grad.numpy(), want, **gw_tol(want))


# ----------------------------------------------------------------------
# Which kernels each route reaches
# ----------------------------------------------------------------------

@pytest.fixture
def kernel_calls(monkeypatch):
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name + ("2" if k.get("derivative") else "")
                         + ("_edge" if k.get("e") is not None else ""))
            return fn(*a, **k)
        return wrapped

    for name in ("act_reduce", "src_bwd", "edge_act_reduce2",
                 "edge_src_bwd"):
        plain = f"ell_{name}_plain"
        monkeypatch.setattr(tkernels, plain,
                            spy(name, getattr(tkernels, plain)))
    return calls


def _conv(edge_encoder=None, dropout=0.0, agg="sym", de=5):
    return SIREConv(12, de, H, 8, ACT, dropout=dropout, agg_type=agg,
                    edge_encoder=edge_encoder,
                    generator=torch.Generator().manual_seed(0))


def test_routes_reach_their_kernels(kernel_calls):
    c = make_case("random", de=5, with_jax=False)
    fg = c.tfg
    x = _t(np.random.default_rng(9).normal(size=(fg.n_pad, 12)))
    ef = _t(c.eb[:fg.graph.num_edges])
    gen = torch.Generator().manual_seed(1)

    def run(conv, grad=True):
        kernel_calls.clear()
        if grad:
            conv(fg, x, ef, generator=gen).sum().backward()
        else:
            with torch.no_grad():
                conv(fg, x, ef, generator=gen)
        return list(kernel_calls)

    fused = _conv(dropout=0.0)
    assert run(fused) == ["edge_act_reduce2", "edge_src_bwd"]
    assert run(fused, grad=False) == ["edge_act_reduce2"]
    generic = _conv(dropout=0.2)   # edge dropout in training: e route
    assert run(generic) == ["act_reduce2_edge", "src_bwd_edge"]
    assert run(generic, grad=False) == ["act_reduce_edge"]
    generic.eval()                 # eval turns the fused route back on
    assert run(generic, grad=False) == ["edge_act_reduce2"]
    enc = _conv(edge_encoder=Embed(4, H, generator=torch.Generator()))
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, 4, fg.graph.num_edges))
    kernel_calls.clear()
    enc(fg, x, ids).sum().backward()
    assert kernel_calls == ["act_reduce2_edge", "src_bwd_edge"]


def test_unported_edge_branches_raise():
    """What still raises: malformed edge arguments. The branches that
    raised before the port had them now compute, held against the JAX
    package's: the SIREConv max layer on a FastGraph (JAX's SIREConv),
    max with e_basis on the kernels (JAX's max builder ``with_edge`` on
    e = e_basis @ w_edge), e_basis under a DropEdge mask (the fused
    kernels on dynamic scales), and a sigma outside the registry with e
    (the pure ELL route)."""
    import jax
    import jax.numpy as jnp

    jell, _, jact, _ = jax_side("f32")
    c = make_case("random", de=5)
    eq, ek, e, eb, we = (_t(a) for a in (c.eq, c.ek, c.e, c.eb, c.we))
    jconv, variables, x, ef = _jax_sireconv(c, False, "max", 5, 4)
    conv = _conv(agg="max")
    load_jax_variables(conv, variables)
    np.testing.assert_allclose(
        conv(c.tfg, _t(x), _t(ef)).detach().numpy(),
        np.asarray(jconv.apply(variables, c.jfg, jnp.asarray(x),
                               jnp.asarray(ef), deterministic=True)),
        **FWD_TOL)
    wr = np.random.default_rng(5).normal(size=(H, H)).astype(np.float32) / 5
    f = jell.make_ell_sir_aggregate_max_pallas(c.jfg, jact, with_edge=True,
                                               interpret=True)
    np.testing.assert_allclose(
        tmp.sir_aggregate(c.tfg, eq, ek, ACT, "max", e_basis=eb, w_edge=we,
                          w_relation=_t(wr)).numpy(),
        np.asarray(f(c.eq, c.ek, jnp.asarray(c.eb) @ jnp.asarray(c.we),
                     jnp.asarray(c.jfg.edge_mask, jnp.float32), wr,
                     jnp.zeros((H,), jnp.float32))), **FWD_TOL)
    with pytest.raises(ValueError, match="not both"):
        tmp.sir_aggregate(c.tfg, eq, ek, ACT, "sum", e=e, e_basis=eb,
                          w_edge=we)
    with pytest.raises(ValueError, match="w_edge"):
        tmp.sir_aggregate(c.tfg, eq, ek, ACT, "sum", e_basis=eb)

    mask = np.random.default_rng(3).random(c.tfg.e_pad) >= 0.3
    w = np.random.default_rng(4).normal(size=c.eq.shape).astype(np.float32)
    twe = _t(c.we).requires_grad_()
    out, geq, gek = _port_grads(c, "sum", w, e_basis=eb, w_edge=twe,
                                edge_mask=torch.from_numpy(mask))
    f = jell.make_ell_sir_aggregate_pallas_fused_edge(
        c.jfg, jact, "sum", interpret=True, static_scale=False)
    s = jnp.asarray(mask & np.asarray(c.jfg.edge_mask), jnp.float32)
    jeb = jnp.asarray(c.eb)
    np.testing.assert_allclose(out, np.asarray(f(c.eq, c.ek, jeb, c.we, s)),
                               **FWD_TOL)
    want = jax.grad(lambda a, b, m: jnp.sum(f(a, b, jeb, m, s) * w),
                    argnums=(0, 1, 2))(c.eq, c.ek, c.we)
    np.testing.assert_allclose(geq, np.asarray(want[0]), **BWD_TOL)
    np.testing.assert_allclose(gek, np.asarray(want[1]), **BWD_TOL)
    np.testing.assert_allclose(twe.grad.numpy(), np.asarray(want[2]),
                               **gw_tol(want[2]))

    te = _t(c.e).requires_grad_()
    out, geq, gek = _port_grads(c, "sum", w, e=te, act=torch.tanh)
    f = jell.make_ell_sir_aggregate(c.jfg, jnp.tanh, "sum", with_edge=True,
                                    static_scale=True)
    s0 = jnp.zeros((c.jfg.e_pad,), jnp.float32)
    np.testing.assert_allclose(out, np.asarray(f(c.eq, c.ek, c.e, s0)),
                               **FWD_TOL)
    want = jax.grad(lambda a, b, x: jnp.sum(f(a, b, x, s0) * w),
                    argnums=(0, 1, 2))(c.eq, c.ek, c.e)
    for got, ref in zip((geq, gek, te.grad.numpy()), want):
        np.testing.assert_allclose(got, np.asarray(ref), **BWD_TOL)


def test_edge_wrappers_check_inputs_and_count_no_cpu_launch():
    c = make_case("random", de=5, with_jax=False)
    fg, plan, splan = c.tfg, c.tfg.dst_plan, c.tfg.src_plan
    fwd = (_t(c.eq), _t(c.ek), fg.dst_slot_srcnode, _t(c.scales["dst"]),
           plan.row_key, plan.row_ptr, ACT)
    fused = (_t(c.eq), _t(c.ek), _t(c.eb), _t(c.we), fg.dst_slot_srcnode,
             plan.slot_edge, _t(c.scales["dst"]), plan.row_key, plan.row_ptr,
             ACT)
    reset_launch_counts()
    ell_act_reduce_edge(*fwd, _t(c.e), plan.slot_edge)
    ell_edge_act_reduce2(*fused)
    assert all(v == 0 for v in LAUNCHES.values())
    with pytest.raises(TypeError, match="e has dtype"):   # e not ek's type
        ell_act_reduce_edge(*fwd, _t(c.e, torch.bfloat16), plan.slot_edge)
    with pytest.raises(ValueError, match="slot_edge"):
        ell_act_reduce2_edge(*fwd, _t(c.e), splan.slot_edge[:-1])
    with pytest.raises(ValueError, match="edge count"):
        ell_src_bwd_edge(_t(c.eq), _t(c.g), _t(c.ek), fg.src_slot_dstnode,
                         _t(c.scales["src"]), splan.row_key, splan.row_ptr,
                         ACT, _t(c.e), splan.slot_edge,
                         fg.edge2src_slot[:-1], fg.edge_mask)
    with pytest.raises(ValueError, match="w_e"):
        ell_edge_act_reduce2(*fused[:3], _t(c.we.T.copy()), *fused[4:])
    # any De and H: at H = 128, De = 500 passes a block's shared memory in
    # the forward and De = 60 in the backward (the columns path on the
    # card); they compute, held to the Pallas kernels, and launch nothing
    for de in (500, 60):
        check_fused_plains(make_case("random", de=de, h=128, seed=de), "f32",
                           "leaky_relu")
    assert all(v == 0 for v in LAUNCHES.values())


def test_edge_layout_python_side():
    """``ell_edge_layout`` checks its widths before it asks the library,
    and its codes decode to each kernel's path and the launch shapes."""
    for h, de in ((0, 16), (96, 0), (-1, 5)):
        with pytest.raises(ValueError, match="positive"):
            ell_edge_layout(h, de, ACT, torch.float32)
    arxiv = 2 | 2 << 2 | 3 << 4 | 16 << 7 | 4 << 12 | 2 << 16 | 4 << 20 \
        | 4 << 24
    assert decode_edge_layout(arxiv) == EdgeLayout(
        "registers", "registers", 3, 16, 4, 2, 4, 4)
    # H = 128, De = 16: the backward's W_E and g_WE exceed its registers
    mixed = 2 | 1 << 2 | 4 << 4 | 16 << 7 | 4 << 12 | 1 << 16 | 4 << 20 \
        | 8 << 24
    assert decode_edge_layout(mixed) == EdgeLayout(
        "registers", "shared", 4, 16, 4, 1, 4, 8)
    # De = 60 at H = 128: the forward's loop, the backward on the columns
    # path in two chunks of 64 columns (its nine [60, 128] tables exceed a
    # block's shared memory)
    wide = 1 | 3 << 2 | 4 << 4 | 1 << 12 | 1 << 16 | 8 << 20 | 8 << 24 \
        | 2 << 31
    assert decode_edge_layout(wide) == EdgeLayout(
        "shared", "columns", 4, 0, 1, 1, 8, 8, 0, 64, False, False)
    # De = 600 at H = 100: both on the columns path, the backward's W_E and
    # partials in device memory
    large = 3 | 3 << 2 | 4 << 4 | 1 << 12 | 1 << 16 | 8 << 20 | 8 << 24 \
        | 2 << 28 | 4 << 31 | 1 << 35
    assert decode_edge_layout(large) == EdgeLayout(
        "columns", "columns", 4, 0, 1, 1, 8, 8, 64, 128, False, True)
    assert decode_edge_layout(-1) is None
    with pytest.raises(ValueError, match="no path"):
        decode_edge_layout(arxiv & ~3)
    with pytest.raises(ValueError, match="chunk"):
        decode_edge_layout(arxiv | 3)  # the columns path without a chunk


def test_edge_layout_decodes_the_tiles_path():
    """#8's fourth path, tiles, takes a third bit of its path code (bit
    36): at H = 512, De = 16 in bf16 the forward on the shared-memory loop,
    the backward on tiles with chunks of 128 columns, 16 basis values a
    slot and 8 slots a batch (4 in f32); a code naming a fifth path, or
    tiles without a chunk, is refused."""
    tiles = 1 | 4 << 4 | 16 << 7 | 1 << 12 | 8 << 16 | 8 << 20 | 8 << 24 \
        | 4 << 31 | 1 << 36
    assert decode_edge_layout(tiles) == EdgeLayout(
        "shared", "tiles", 4, 16, 1, 8, 8, 8, 0, 128, False, False)
    f32 = tiles & ~(0xF << 16) | 4 << 16
    assert decode_edge_layout(f32).bwd_inflight == 4
    with pytest.raises(ValueError, match="no path"):
        decode_edge_layout(tiles | 1 << 2)  # path 5
    with pytest.raises(ValueError, match="chunk"):
        decode_edge_layout(tiles & ~(7 << 31))


def test_ell_ab_edge_needs_a_card(tmp_path):
    """The A/B tool's edge mode (two ell_edge_kernels.cu builds) runs on
    the card only, and --probes is not one of its options."""
    from sir_gcn_tpu_torch.tools import ell_ab

    with pytest.raises(SystemExit):
        ell_ab.main(["--edge", "--probes", str(tmp_path / "other.cu")])
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ell_ab.main(["--edge", str(tmp_path / "other.cu")])


# ----------------------------------------------------------------------
# Embed, SIREConv and the weight bridge
# ----------------------------------------------------------------------

def test_embed_init_and_lookup():
    a = Embed(7, 5, padding_idx=2, generator=torch.Generator().manual_seed(3))
    b = Embed(7, 5, padding_idx=2, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a.embedding, b.embedding, atol=0, rtol=0)
    assert (a.embedding[2] == 0).all() and (a.embedding[3] != 0).all()
    big = Embed(400, 50, generator=torch.Generator().manual_seed(0))
    table = big.embedding.detach()
    assert abs(float(table.mean())) < 0.02
    assert abs(float(table.std()) - 1.0) < 0.02
    ids = torch.tensor([[0, 2], [6, 2]])
    out = a(ids)
    assert out.shape == (2, 2, 5)
    torch.testing.assert_close(out[1, 0], a.embedding[6], atol=0, rtol=0)
    out.sum().backward()  # the padding row still gets a gradient, as in JAX
    assert float(a.embedding.grad[2].sum()) == 2 * 5


def _jax_sireconv(c, encoder: bool, agg: str, de: int, num_types: int):
    """The JAX SIREConv, its variables and inputs on the case's graph."""
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.models.conv import SIREConv as JSIREConv
    from sir_gcn_tpu.models.layers import Embed as JEmbed

    rng = np.random.default_rng(11)
    e_raw = c.tfg.graph.num_edges
    x = rng.normal(size=(c.tfg.n_pad, 12)).astype(np.float32)
    ef = (rng.integers(0, num_types, e_raw) if encoder
          else rng.normal(size=(e_raw, de)).astype(np.float32))
    conv = JSIREConv(hidden_dim=H, output_dim=8,
                     activation=lambda z: jax.nn.leaky_relu(z, 0.2),
                     agg_type=agg,
                     edge_encoder=JEmbed(num_types, H) if encoder else None)
    variables = conv.init(jax.random.PRNGKey(2), c.jfg, jnp.asarray(x),
                          jnp.asarray(ef))
    return conv, jax.tree_util.tree_map(np.asarray, variables), x, ef


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items")
                   else {prefix + (k,): np.asarray(v)})
    return out


@pytest.mark.parametrize("route,graph,agg", [
    ("fused", "random", "sym"), ("fused", "hub", "mean"),
    ("embed", "random", "sum"), ("embed", "isolated", "sym"),
])
def test_sireconv_matches_jax(route, graph, agg):
    import jax
    import jax.numpy as jnp

    encoder, de, types = route == "embed", 5, 4
    c = make_case(graph, de=de, seed=10)
    jconv, variables, x, ef = _jax_sireconv(c, encoder, agg, de, types)
    conv = SIREConv(12, de, H, 8, ACT, agg_type=agg,
                    edge_encoder=Embed(types, H) if encoder else None)
    load_jax_variables(conv, variables)
    slots = _slots(conv)
    assert ("params", "linear_edge", "Dense_0", "kernel") in slots or encoder

    tx = _t(x).requires_grad_()
    tef = torch.from_numpy(ef) if encoder else _t(ef)
    w = np.random.default_rng(12).normal(
        size=(c.tfg.n_pad, 8)).astype(np.float32)
    out = conv(c.tfg, tx, tef)
    (out * _t(w)).sum().backward()

    def loss(p, xx):
        y = jconv.apply(p, c.jfg, xx, jnp.asarray(ef), deterministic=True)
        return jnp.sum(y * w), y

    (_, jout), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        variables, jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **BWD_TOL)
    grads = _flat(gp)
    assert set(grads) == set(slots)
    for key, g in grads.items():
        tensor, transpose = slots[key]
        have = tensor.grad.numpy()
        np.testing.assert_allclose(have.T if transpose else have, g,
                                   **BWD_TOL, err_msg="/".join(key))


@pytest.mark.parametrize("encoder", [False, True])
def test_bridge_round_trip_and_key_checks(encoder):
    c = make_case("random", de=5, seed=13)
    _, variables, *_ = _jax_sireconv(c, encoder, "sum", 5, 4)
    conv = SIREConv(12, 5, H, 8, ACT,
                    edge_encoder=Embed(4, H) if encoder else None)
    load_jax_variables(conv, variables)
    p = variables["params"]
    if encoder:
        np.testing.assert_array_equal(
            conv.edge_encoder.embedding.detach().numpy(),
            p["edge_encoder"]["embedding"])
        assert conv.linear_edge is None
    else:
        np.testing.assert_array_equal(
            conv.linear_edge.weight.detach().numpy(),
            p["linear_edge"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(conv.linear_query.weight.detach().numpy(),
                                  p["linear_query"]["Dense_0"]["kernel"].T)

    edge_key = "edge_encoder" if encoder else "linear_edge"
    missing = {"params": {k: v for k, v in p.items() if k != edge_key}}
    with pytest.raises(KeyError, match="missing"):
        load_jax_variables(conv, missing)
    extra = {"params": {**p, "linear_spare": {"Dense_0": {
        "kernel": np.zeros((5, H), np.float32)}}}}
    with pytest.raises(KeyError, match="left over"):
        load_jax_variables(conv, extra)
    emb = Embed(4, H)
    table = np.arange(4 * H, dtype=np.float32).reshape(4, H)
    load_jax_variables(emb, {"params": {"embedding": table}})
    np.testing.assert_array_equal(emb.embedding.detach().numpy(), table)


# ----------------------------------------------------------------------
# On the card: each kernel against its plain version
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the paths #7 and #8 take (csrc/ell_edge_kernels.cu): registers for H <=
# 128 and De <= 16, in the backward only while ceil(H / 32) features a lane
# times the basis width held (De padded to 8 or 16) stay <= 48
EDGE_PATHS = {(24, 5): ("registers", "registers"),
              (20, 5): ("registers", "registers"),
              (40, 12): ("registers", "registers"),
              (96, 16): ("registers", "registers"),
              (128, 8): ("registers", "registers"),
              (128, 16): ("registers", "shared"),
              (200, 5): ("shared", "shared"),
              (200, 16): ("shared", "shared")}


def fused_args(fg, eq, ek, g, eb, we, sd, ss, act, dtype):
    """The arguments of #7 and #8 on the card: ek (#7) and eq, g (#8) in
    the edge type."""
    plan, splan = fg.dst_plan, fg.src_plan
    fwd = (eq, ek.to(dtype), eb, we, fg.dst_slot_srcnode, plan.slot_edge,
           sd, plan.row_key, plan.row_ptr, act)
    bwd = (eq.to(dtype), g.to(dtype), ek, eb, we, fg.src_slot_dstnode,
           splan.slot_edge, ss, splan.row_key, splan.row_ptr, act)
    return fwd, bwd


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("graph,h,de", [("hub", 24, 5), ("random", 96, 16),
                                        ("isolated", 200, 16),
                                        ("random", 200, 5),
                                        ("random", 20, 5),
                                        ("random", 128, 16)])
@pytest.mark.parametrize("act", sorted(ACTS))
def test_edge_kernels_match_plain_on_card(cuda_device, graph, h, de, dt,
                                          act):
    c = make_case(graph, de=de, h=h, device=cuda_device, with_jax=False)
    d, tdt, fg = cuda_device, DTYPES[dt], c.tfg
    ACT = ACTS[act]
    plan, splan = fg.dst_plan, fg.src_plan
    sd, ss = _t(c.scales["dst"], device=d), _t(c.scales["src"], device=d)
    e = _t(c.e, tdt, d)
    fwd = (_t(c.eq, device=d), _t(c.ek, tdt, d), fg.dst_slot_srcnode, sd,
           plan.row_key, plan.row_ptr, ACT)
    bwd = (_t(c.eq, tdt, d), _t(c.g, tdt, d), _t(c.ek, device=d),
           fg.src_slot_dstnode, ss, splan.row_key, splan.row_ptr, ACT)
    ge_args = (e, splan.slot_edge, fg.edge2src_slot, fg.edge_mask)
    eb, we = _t(c.eb, device=d), _t(c.we, device=d)
    fused_fwd = (fwd[0], fwd[1], eb, we, fg.dst_slot_srcnode,
                 plan.slot_edge) + fwd[3:]
    fused_bwd = bwd[:3] + (eb, we, fg.src_slot_dstnode,
                           splan.slot_edge) + bwd[4:]
    reset_launch_counts()
    got = (ell_act_reduce_edge(*fwd, e, plan.slot_edge),
           *ell_act_reduce2_edge(*fwd, e, plan.slot_edge),
           *ell_src_bwd_edge(*bwd, *ge_args),
           *ell_edge_act_reduce2(*fused_fwd),
           *ell_edge_src_bwd(*fused_bwd))
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {
        "ell_act_reduce_edge": 1, "ell_act_reduce2_edge": 1,
        "ell_src_bwd_edge": 1, "ell_edge_act_reduce2": 1,
        "ell_edge_src_bwd": 1}
    edge = dict(e=e, slot_edge=plan.slot_edge)
    want = (ell_act_reduce_plain(*fwd, **edge),
            *ell_act_reduce_plain(*fwd, derivative=True, **edge),
            *ell_src_bwd_plain(*bwd, e=e, slot_edge=splan.slot_edge,
                               edge2slot=fg.edge2src_slot,
                               edge_mask=fg.edge_mask),
            *ell_edge_act_reduce2_plain(*fused_fwd),
            *ell_edge_src_bwd_plain(*fused_bwd))
    # g_e is stored after rounding to the edge type: values that agree in
    # f32 can round to neighbouring bf16 values, one step apart
    ge_tol = BF16_STEP if dt == "bf16" else BWD_TOL
    tols = [FWD_TOL] * 3 + [BWD_TOL, ge_tol] + [FWD_TOL] * 2 + [BWD_TOL]
    for a, b, tol in zip(got, want, tols):
        torch.testing.assert_close(a, b, **tol)
    torch.testing.assert_close(got[-1], want[-1],
                               **gw_tol(want[-1].cpu().numpy()))
    lay = ell_edge_layout(h, de, ACT, tdt)
    assert (lay.fwd, lay.bwd) == EDGE_PATHS[h, de], lay


@pytest.mark.cuda
@pytest.mark.parametrize("h,de,dt,aligned", [
    (96, 16, "bf16", True), (96, 16, "f32", False), (40, 12, "bf16", True),
    (24, 5, "f32", True), (128, 8, "bf16", False), (128, 16, "f32", True),
    (200, 16, "bf16", True)])
def test_fused_edge_kernels_on_awkward_plans_on_card(cuda_device, h, de, dt,
                                                     aligned):
    """#7 and #8 against their plain versions on plans with odd row counts
    on both sides (a part-full last tile of rows), rows of 40 to 104 slots
    (several 32-slot chunks), budgets off multiples of 8 (10, 12, 28), a
    fifth of the scales zeroed, both sigmas, and a basis that starts 4
    bytes past a 16-byte boundary (``aligned`` False: 4-byte copies)."""
    rng = np.random.default_rng(0)
    n, d = 70, cuda_device
    dst = np.concatenate([np.repeat([0, 1, 2, 3], [100, 37, 27, 45]),
                          rng.integers(4, n, 260)])
    src = rng.integers(0, n, dst.size)
    src[rng.permutation(dst.size)[:110]] = np.repeat([5, 6], [70, 40])
    fg = tell.build_fast_graph(build_graph(src, dst, n, device=d),
                               max_budget=256)
    for plan in (fg.dst_plan, fg.src_plan):
        budgets = set(np.diff(plan.row_ptr.cpu().numpy()).tolist())
        assert plan.num_rows % 2 == 1
        assert max(budgets) > 32 and {b % 8 for b in budgets} - {0}
    eq, ek, g = (_t(rng.normal(size=(fg.n_pad, h)), device=d)
                 for _ in range(3))
    basis = rng.normal(size=(fg.e_pad, de)).astype(np.float32)
    eb = torch.empty(fg.e_pad * de + 1, device=d)[1 - aligned:][
        :fg.e_pad * de].view(fg.e_pad, de)
    eb.copy_(_t(basis, device=d))
    assert (eb.data_ptr() % 16 == 0) == aligned
    we = _t(rng.normal(size=(de, h)) * 0.3, device=d)
    sd, ss = (getattr(fg, f"{side}_slot_scales")["sym"] * _t(
        rng.random(getattr(fg, f"{side}_plan").num_slots) > 0.2, device=d)
        for side in ("dst", "src"))
    assert bool((sd == 0).any()) and bool((ss == 0).any())
    for act in (ACT, tell.tanh, tell.gelu()):
        fwd, bwd = fused_args(fg, eq, ek, g, eb, we, sd, ss, act, DTYPES[dt])
        got = ell_edge_act_reduce2(*fwd) + ell_edge_src_bwd(*bwd)
        want = (ell_edge_act_reduce2_plain(*fwd)
                + ell_edge_src_bwd_plain(*bwd))
        for a, b, tol in zip(got, want, (FWD_TOL, FWD_TOL, BWD_TOL)):
            torch.testing.assert_close(a, b, **tol)
        torch.testing.assert_close(got[3], want[3],
                                   **gw_tol(want[3].cpu().numpy()))
        lay = ell_edge_layout(h, de, act, DTYPES[dt])
        assert (lay.fwd, lay.bwd) == EDGE_PATHS[h, de], lay


@pytest.mark.cuda
@pytest.mark.parametrize("h,de,dt,act", [
    (96, 16, "bf16", "leaky_relu"), (96, 16, "f32", "tanh"),
    (128, 16, "bf16", "leaky_relu"), (40, 12, "f32", "leaky_relu")])
def test_fused_edge_kernels_are_bitwise_repeatable_on_card(cuda_device, h,
                                                           de, dt, act):
    """Two launches of #7 and #8 on the same inputs give bitwise equal
    rows, srows, g_ek rows and g_WE, on both of #8's paths: every sum's
    order is fixed by the grid, with no atomics. A graph of 4,000 nodes
    and 40,000 edges fills many blocks."""
    rng = np.random.default_rng(7)
    n, e, d = 4000, 40000, cuda_device
    fg = tell.build_fast_graph(
        build_graph(rng.integers(0, n, e), rng.integers(0, n, e), n,
                    device=d), max_budget=64)
    eq, ek, g = (_t(rng.normal(size=(fg.n_pad, h)), device=d)
                 for _ in range(3))
    eb = _t(rng.normal(size=(fg.e_pad, de)), device=d)
    we = _t(rng.normal(size=(de, h)) * 0.3, device=d)
    tact = {"leaky_relu": ACT, "tanh": tell.tanh}[act]
    fwd, bwd = fused_args(fg, eq, ek, g, eb, we, fg.dst_slot_scales["sym"],
                          fg.src_slot_scales["sym"], tact, DTYPES[dt])
    first = ell_edge_act_reduce2(*fwd) + ell_edge_src_bwd(*bwd)
    second = ell_edge_act_reduce2(*fwd) + ell_edge_src_bwd(*bwd)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
