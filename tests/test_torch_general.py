"""The port's general sigma route and full-vjp kernels against the JAX
package's.

* the registry's row-wise entries (centered_relu, softmax): their written
  vjp against torch's autograd;
* the plain versions of ``ell_act_reduce_rowwise`` (#1r),
  ``ell_geq_reduce`` (#3), ``ell_src_bwd_rowwise`` (#4r),
  ``ell_src_bwd_fused`` (#5) and ``ell_act_reduce_bwd`` (#6) against the
  Pallas kernels run in interpret mode bucket by bucket, with a fifth of
  the slot scales zeroed, for centered_relu, softmax and tanh;
* the general route of ``sir_aggregate``, out and gradients, against
  ``make_ell_sir_aggregate_pallas(act_elementwise=False, interpret=True)``
  and ``make_ell_sir_aggregate``, on random, hub (stage 2) and
  isolated-node graphs, sum/mean/sym, f32/bf16;
* tanh forced onto the general route (``sir_elementwise=False``) against
  the elementwise route; ``fuse_bwd_take`` against the default backward and
  JAX's fused backward (leaky_relu(0.2) at H = 96 among them, the arxiv
  SIRModel's); #5's plain version with leaky_relu against the Pallas
  kernel; the dst-major composition (#6 then #12) against JAX's
  gradients;
* ``SIRConv`` with centered_relu against the JAX ``SIRConv`` through the
  weight bridge: out, every parameter gradient, one AdamW step;
* which kernels the route reaches, and what raises; the layout query's
  decoder and checks, and the A/B tool's ``--general`` mode without a
  card.

Tolerances are the JAX suite's: forward atol 2e-4 / rtol 1e-4, gradients
atol 3e-4 / rtol 1e-3; a g_z stored in bf16 at one bf16 step. bf16 is
rounded at the same points in both packages.

The ``cuda`` tests compare each kernel with its plain version on the card,
on the path its entry chooses (``GENERAL_PATHS``), on awkward plans, with
leaky_relu besides (#5's lane-group path for an elementwise sigma), ask
two launches of #1r, #3, #4r, #5 and #6 for the same
bits, and #6's rows for #3's bits; they skip where there is no card. JAX
is imported inside the tests that use it (``pytest -m cuda --noconftest
tests/test_torch_general.py`` on the card).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sir_gcn_tpu_torch.ops.cuda.kernels as tkernels
import sir_gcn_tpu_torch.ops.ell as tell
import sir_gcn_tpu_torch.ops.message_passing as tmp
from sir_gcn_tpu_torch import build_graph
from sir_gcn_tpu_torch.ops.cuda import (
    LAUNCHES,
    GeneralLayout,
    WideLayout,
    decode_general_layout,
    ell_act_reduce,
    ell_act_reduce_bwd,
    ell_act_reduce_bwd_plain,
    ell_act_reduce_plain,
    ell_act_reduce_rowwise,
    ell_geq_reduce,
    ell_general_layout,
    ell_geq_reduce_plain,
    ell_scaled_reduce,
    ell_src_bwd,
    ell_src_bwd_fused,
    ell_src_bwd_fused_plain,
    ell_src_bwd_plain,
    ell_src_bwd_rowwise,
    reset_launch_counts,
)
from sir_gcn_tpu_torch.ops.cuda.checks import near_gate, slot_rows

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
BF16_STEP = dict(atol=3e-4, rtol=2.0 ** -7)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
ALPHA = 0.5
SLOPE = 0.2  # the arxiv SIRModel's leaky_relu
ACTS = {"centered_relu": tell.centered_relu(ALPHA), "softmax": tell.softmax,
        "tanh": dataclasses.replace(tell.tanh, sir_elementwise=False)}
# on the card also the elementwise sigma that #5 takes on its lane-group
# path (and the other kernels on their first design)
CARD_ACTS = {**ACTS, "leaky_relu": tell.leaky_relu(SLOPE)}


def jax_act(name: str):
    import jax
    import jax.numpy as jnp

    return {"centered_relu": lambda z: jax.nn.relu(
                z - ALPHA * z.mean(-1, keepdims=True)),
            "softmax": lambda z: jax.nn.softmax(z, axis=-1),
            "tanh": jnp.tanh,
            "leaky_relu": lambda z: jax.nn.leaky_relu(z, SLOPE)}[name]


def jax_dtype(dt: str):
    import jax.numpy as jnp

    return {"f32": None, "bf16": jnp.bfloat16}[dt]


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


def make_case(graph: str, h: int, seed: int = 0, device="cpu",
              with_jax: bool = True):
    """Both packages' FastGraphs of one graph, node tables eq/ek/g [N, H],
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
    scales = {}
    for side in ("dst", "src"):
        s = getattr(tfg, f"{side}_slot_scales")["sym"].cpu().numpy()
        scales[side] = (s * (rng.random(s.shape) > 0.2)).astype(np.float32)
    return SimpleNamespace(tfg=tfg, jfg=jfg, eq=eq, ek=ek, g=g,
                           scales=scales)


def _t(x, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(np.asarray(x)).to(device=device, dtype=dtype)


def _jnp(x):
    import jax.numpy as jnp

    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _cast(x, jdt):
    return x if jdt is None else x.astype(jdt)


@pytest.fixture
def edge_dtype():
    def use(name):
        tmp.set_edge_dtype(DTYPES[name])
    yield use
    tmp.set_edge_dtype(None)


# ----------------------------------------------------------------------
# The registry's row-wise entries
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["centered_relu", "softmax"])
def test_rowwise_vjp_matches_autograd(name):
    act = ACTS[name]
    rng = np.random.default_rng(1)
    z = _t(rng.normal(size=(5, 3, 24)))
    g = _t(rng.normal(size=(5, 3, 24)))
    _, want = torch.autograd.functional.vjp(act, z, g)
    torch.testing.assert_close(act.vjp(z, g), want, atol=1e-6, rtol=1e-5)
    assert not act.diagonal and not act.elementwise
    with pytest.raises(ValueError, match="elementwise derivative"):
        act.grad(z)
    forced = ACTS["tanh"]
    assert forced.diagonal and not forced.elementwise
    torch.testing.assert_close(forced.vjp(z, g), tell.tanh.grad(z) * g)


# ----------------------------------------------------------------------
# Plain versions against the Pallas kernels
# ----------------------------------------------------------------------

def _dst_inputs(c, jdt):
    import jax.numpy as jnp

    plan = c.tfg.dst_plan
    ekg = jnp.take(_cast(_jnp(c.ek), jdt), _jnp(c.tfg.dst_slot_srcnode),
                   axis=0)
    rk = _jnp(plan.row_key)
    return (ekg, jnp.take(_jnp(c.eq), rk, axis=0),
            jnp.take(_jnp(c.g), rk, axis=0))


@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("graph,h,dt", [("random", 24, "f32"),
                                        ("hub", 40, "bf16"),
                                        ("isolated", 128, "bf16"),
                                        ("random", 512, "bf16")])
def test_general_plains_match_pallas(graph, h, dt, act):
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.ell as jell
    from sir_gcn_tpu.ops import pallas

    jact, jdt, tact, tdt = jax_act(act), jax_dtype(dt), ACTS[act], DTYPES[dt]
    c = make_case(graph, h, seed=1)
    fg = c.tfg
    plan, splan = fg.dst_plan, fg.src_plan
    sd, ss = c.scales["dst"], c.scales["src"]
    fwd = (_t(c.eq), _t(c.ek, tdt), fg.dst_slot_srcnode, _t(sd), plan.row_key,
           plan.row_ptr, tact)

    ekg, eq_rows, g_rows = _dst_inputs(c, jdt)
    want1, want3, want6 = [], [], []
    for b, nr, so, ro in jell._bucket_offsets(plan.buckets1):
        args = (ekg[so:so + b * nr], eq_rows[ro:ro + nr],
                _jnp(sd[so:so + b * nr]).reshape(nr, b))
        want1.append(np.asarray(pallas.bucket_bcast_act_reduce(
            *args, b, jact, interpret=True)))
        want3.append(np.asarray(pallas.bucket_geq_reduce(
            *args, g_rows[ro:ro + nr], b, jact, interpret=True)))
        want6.append(pallas.bucket_bcast_act_reduce_bwd(
            *args, g_rows[ro:ro + nr], b, jact, interpret=True,
            gz_dtype=jdt or jnp.float32))
    np.testing.assert_allclose(ell_act_reduce_rowwise(*fwd).numpy(),
                               np.concatenate(want1), **FWD_TOL)
    np.testing.assert_allclose(ell_geq_reduce(*fwd, _t(c.g)).numpy(),
                               np.concatenate(want3), **BWD_TOL)
    g_slots, geq = ell_act_reduce_bwd(*fwd, _t(c.g), gz_dtype=tdt)
    assert g_slots.dtype == tdt and geq.dtype == torch.float32
    np.testing.assert_allclose(
        g_slots.float().numpy(),
        np.concatenate([np.asarray(gz, np.float32) for gz, _ in want6]),
        **(BF16_STEP if dt == "bf16" else BWD_TOL))
    np.testing.assert_allclose(
        geq.numpy(), np.concatenate([np.asarray(r) for _, r in want6]),
        **BWD_TOL)

    # the src-major backward, from two tables (#4r) and from one (#5)
    idx = _jnp(fg.src_slot_dstnode)
    eqg = jnp.take(_cast(_jnp(c.eq), jdt), idx, axis=0)
    gg = jnp.take(_cast(_jnp(c.g), jdt), idx, axis=0)
    ek_rows = jnp.take(_jnp(c.ek), _jnp(splan.row_key), axis=0)
    want4, want5 = [], []
    for b, nr, so, ro in jell._bucket_offsets(splan.buckets1):
        sc = _jnp(ss[so:so + b * nr]).reshape(nr, b)
        r, _ = pallas.bucket_src_bwd(eqg[so:so + b * nr], ek_rows[ro:ro + nr],
                                     sc, gg[so:so + b * nr], b, jact,
                                     interpret=True)
        want4.append(np.asarray(r))
        if h % 128 == 0:  # the TPU kernel's lane split
            both = jnp.concatenate([eqg[so:so + b * nr], gg[so:so + b * nr]],
                                   axis=1)
            r, _ = pallas.bucket_src_bwd_fused(both, ek_rows[ro:ro + nr], sc,
                                               b, jact, interpret=True)
            want5.append(np.asarray(r))
    bwd = (fg.src_slot_dstnode, _t(ss), splan.row_key, splan.row_ptr, tact)
    np.testing.assert_allclose(
        ell_src_bwd_rowwise(_t(c.eq, tdt), _t(c.g, tdt), _t(c.ek),
                            *bwd).numpy(), np.concatenate(want4), **BWD_TOL)
    both = torch.cat([_t(c.eq, tdt), _t(c.g, tdt)], 1)
    np.testing.assert_allclose(
        ell_src_bwd_fused(both, _t(c.ek), *bwd).numpy(),
        np.concatenate(want5 or want4), **BWD_TOL)


# ----------------------------------------------------------------------
# The general route of sir_aggregate against the JAX routes
# ----------------------------------------------------------------------

def _port_grads(c, act, agg, w, **kw):
    teq, tek = _t(c.eq).requires_grad_(), _t(c.ek).requires_grad_()
    if kw:
        out = tell.ell_sir_aggregate(c.tfg, teq, tek, act, agg,
                                     edge_dtype=tmp.get_edge_dtype(), **kw)
    else:
        out = tmp.sir_aggregate(c.tfg, teq, tek, act, agg)
    (out * _t(w)).sum().backward()
    return out.detach().numpy(), teq.grad.numpy(), tek.grad.numpy()


def _jax_grads(f, c, w):
    import jax
    import jax.numpy as jnp

    s0 = jnp.zeros((c.jfg.e_pad,), jnp.float32)
    e0 = jnp.zeros((0,), jnp.float32)
    out = f(c.eq, c.ek, e0, s0)
    g = jax.grad(lambda a, b: jnp.sum(f(a, b, e0, s0) * w),
                 argnums=(0, 1))(c.eq, c.ek)
    return (np.asarray(out),) + tuple(np.asarray(x) for x in g)


def _assert_same(got, want):
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **BWD_TOL)


@pytest.mark.parametrize("graph,agg,dt,act", [
    ("random", "sum", "f32", "centered_relu"),
    ("random", "sym", "bf16", "softmax"),
    ("hub", "mean", "f32", "softmax"),
    ("hub", "sym", "bf16", "centered_relu"),
    ("isolated", "sum", "bf16", "softmax"),
    ("isolated", "mean", "f32", "centered_relu"),
])
def test_general_route_matches_jax(graph, agg, dt, act, edge_dtype):
    import sir_gcn_tpu.ops.ell as jell

    edge_dtype(dt)
    c = make_case(graph, 24, seed=3)
    w = np.random.default_rng(4).normal(size=c.eq.shape).astype(np.float32)
    got = _port_grads(c, ACTS[act], agg, w)
    f = jell.make_ell_sir_aggregate_pallas(
        c.jfg, jax_act(act), agg, interpret=True, edge_dtype=jax_dtype(dt),
        static_scale=True, act_elementwise=False)
    _assert_same(got, _jax_grads(f, c, w))
    if dt == "f32":  # the XLA builder carries no edge dtype
        _assert_same(got, _jax_grads(jell.make_ell_sir_aggregate(
            c.jfg, jax_act(act), agg, static_scale=True), c, w))
    with torch.no_grad():  # the forward without a gradient
        np.testing.assert_allclose(
            tmp.sir_aggregate(c.tfg, _t(c.eq), _t(c.ek), ACTS[act],
                              agg).numpy(), got[0], **FWD_TOL)


@pytest.mark.parametrize("graph,agg,dt", [("random", "sym", "bf16"),
                                          ("hub", "mean", "f32")])
def test_tanh_forced_general_equals_elementwise(graph, agg, dt, edge_dtype):
    edge_dtype(dt)
    c = make_case(graph, 40, seed=5, with_jax=False)
    w = np.random.default_rng(6).normal(size=c.eq.shape).astype(np.float32)
    _assert_same(_port_grads(c, ACTS["tanh"], agg, w),
                 _port_grads(c, tell.tanh, agg, w))


@pytest.mark.parametrize("act,h,dt", [("tanh", 24, "bf16"),
                                      ("centered_relu", 128, "f32"),
                                      ("softmax", 128, "bf16"),
                                      ("leaky_relu", 96, "bf16")])
def test_fuse_bwd_take_matches_default_and_jax(act, h, dt, edge_dtype):
    """fuse_bwd_take=True: the same gradients as the default backward and
    as JAX's fused backward (on its elementwise route at any width, which
    it pads to 128 lanes; on its general route at H % 128 == 0). The
    leaky_relu case is the arxiv SIRModel's sigma and width."""
    import sir_gcn_tpu.ops.ell as jell

    edge_dtype(dt)
    tact = {"tanh": tell.tanh, "leaky_relu": CARD_ACTS["leaky_relu"]}.get(
        act) or ACTS[act]
    c = make_case("random", h, seed=7)
    w = np.random.default_rng(8).normal(size=c.eq.shape).astype(np.float32)
    fused = _port_grads(c, tact, "sym", w, fuse_bwd_take=True)
    _assert_same(fused, _port_grads(c, tact, "sym", w))
    f = jell.make_ell_sir_aggregate_pallas(
        c.jfg, jax_act(act), "sym", interpret=True, edge_dtype=jax_dtype(dt),
        static_scale=True, act_elementwise=tact.elementwise,
        fuse_bwd_take=True)
    _assert_same(fused, _jax_grads(f, c, w))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fused_plain_matches_pallas_elementwise(dt):
    """``ell_src_bwd_fused_plain`` with the elementwise leaky_relu (the
    sigma #5 runs on JAX's elementwise route) against
    ``bucket_src_bwd_fused`` in interpret mode, bucket by bucket, at
    H = 128 (the TPU kernel's lane split)."""
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.ell as jell
    from sir_gcn_tpu.ops import pallas

    h, jdt, tdt = 128, jax_dtype(dt), DTYPES[dt]
    c = make_case("hub", h, seed=13)
    fg, splan, ss = c.tfg, c.tfg.src_plan, c.scales["src"]
    idx = _jnp(fg.src_slot_dstnode)
    both = jnp.concatenate([jnp.take(_cast(_jnp(c.eq), jdt), idx, axis=0),
                            jnp.take(_cast(_jnp(c.g), jdt), idx, axis=0)],
                           axis=1)
    ek_rows = jnp.take(_jnp(c.ek), _jnp(splan.row_key), axis=0)
    want = []
    for b, nr, so, ro in jell._bucket_offsets(splan.buckets1):
        r, _ = pallas.bucket_src_bwd_fused(
            both[so:so + b * nr], ek_rows[ro:ro + nr],
            _jnp(ss[so:so + b * nr]).reshape(nr, b), b,
            jax_act("leaky_relu"), interpret=True)
        want.append(np.asarray(r))
    got = ell_src_bwd_fused_plain(
        torch.cat([_t(c.eq, tdt), _t(c.g, tdt)], 1), _t(c.ek),
        fg.src_slot_dstnode, _t(ss), splan.row_key, splan.row_ptr,
        CARD_ACTS["leaky_relu"])
    np.testing.assert_allclose(got.numpy(), np.concatenate(want), **BWD_TOL)


@pytest.mark.parametrize("act", sorted(ACTS))
def test_dst_major_composition_matches_jax(act):
    """#6 then #12: g_eq from the dst-major rows, g_ek from the per-slot
    g_z reduced by src through ``src_slot_from_dst_slot``."""
    import sir_gcn_tpu.ops.ell as jell

    c = make_case("hub", 24, seed=9)
    fg = c.tfg
    plan, splan = fg.dst_plan, fg.src_plan
    w = np.random.default_rng(10).normal(size=c.eq.shape).astype(np.float32)
    g_slots, geq = ell_act_reduce_bwd(
        _t(c.eq), _t(c.ek), fg.dst_slot_srcnode, fg.dst_slot_scales["mean"],
        plan.row_key, plan.row_ptr, ACTS[act], _t(w))
    g_eq = plan.finalize_rows_sum(geq)
    g_ek = splan.finalize_rows_sum(ell_scaled_reduce(
        g_slots, fg.src_slot_from_dst_slot, splan.slot_valid, splan.row_ptr))
    f = jell.make_ell_sir_aggregate_pallas(
        c.jfg, jax_act(act), "mean", interpret=True, static_scale=True,
        act_elementwise=False)
    want = _jax_grads(f, c, w)
    np.testing.assert_allclose(g_eq.numpy(), want[1], **BWD_TOL)
    np.testing.assert_allclose(g_ek.numpy(), want[2], **BWD_TOL)


# ----------------------------------------------------------------------
# SIRConv with a row-wise sigma through the weight bridge
# ----------------------------------------------------------------------

def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items")
                   else {prefix + (k,): np.asarray(v)})
    return out


@pytest.mark.parametrize("graph,agg", [("hub", "sym"), ("isolated", "mean")])
def test_sirconv_centered_relu_matches_jax(graph, agg):
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.models.conv import SIRConv as JSIRConv
    from sir_gcn_tpu.train import init_state
    from sir_gcn_tpu.train import make_adamw as j_make_adamw

    from sir_gcn_tpu_torch.models import SIRConv
    from sir_gcn_tpu_torch.train import make_adamw
    from sir_gcn_tpu_torch.utils import load_jax_variables
    from sir_gcn_tpu_torch.utils.convert import _slots

    lr, wd = 1e-2, 1e-3
    c = make_case(graph, 16, seed=11)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(c.tfg.n_pad, 10)).astype(np.float32)
    w = rng.normal(size=(c.tfg.n_pad, 12)).astype(np.float32)
    jconv = JSIRConv(hidden_dim=16, output_dim=12,
                     activation=jax_act("centered_relu"), agg_type=agg)
    variables = jax.tree_util.tree_map(np.asarray, jconv.init(
        jax.random.PRNGKey(3), c.jfg, jnp.asarray(x)))
    conv = SIRConv(10, 16, 12, ACTS["centered_relu"], agg_type=agg)
    load_jax_variables(conv, variables)
    slots = _slots(conv)

    tx = torch.from_numpy(x).requires_grad_()
    out = conv(c.tfg, tx)
    (out * _t(w)).sum().backward()

    def loss(p, xx):
        y = jconv.apply(p, c.jfg, xx, deterministic=True)
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

    # one AdamW step; Adam's first step is about lr * sign(g), so entries
    # with |g| < 1e-6 are left out
    make_adamw(conv.parameters(), lr, wd).step()
    tx_j = j_make_adamw(lr, wd)
    state = init_state(variables, tx_j)
    updates, _ = tx_j.update(gp["params"], state.opt_state, state.params)
    new = _flat(jax.tree_util.tree_map(lambda p, u: p + u, state.params,
                                       updates))
    for key, p in new.items():
        tensor, transpose = slots[("params",) + key]
        have = tensor.detach().numpy()
        keep = np.abs(grads[("params",) + key]) >= 1e-6
        np.testing.assert_allclose((have.T if transpose else have)[keep],
                                   p[keep], **FWD_TOL, err_msg="/".join(key))


# ----------------------------------------------------------------------
# Which kernels the route reaches, and what raises
# ----------------------------------------------------------------------

@pytest.fixture
def kernel_calls(monkeypatch):
    calls = []
    for name in ("ell_act_reduce_plain", "ell_geq_reduce_plain",
                 "ell_src_bwd_plain", "ell_src_bwd_fused_plain"):
        fn = getattr(tkernels, name)
        monkeypatch.setattr(tkernels, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n[4:-6]), _f(*a, **k))[1])
    return calls


def test_general_route_reaches_its_kernels(kernel_calls):
    c = make_case("random", 24, with_jax=False)
    act = ACTS["centered_relu"]
    with torch.no_grad():
        tmp.sir_aggregate(c.tfg, _t(c.eq), _t(c.ek), act, "sym")
    assert kernel_calls == ["act_reduce"]
    for fuse, last in ((False, "src_bwd"), (True, "src_bwd_fused")):
        kernel_calls.clear()
        reset_launch_counts()
        w = np.ones_like(c.eq)
        _port_grads(c, act, "sym", w, fuse_bwd_take=fuse)
        # ell_src_bwd_fused's plain version runs ell_src_bwd's
        assert kernel_calls[:3] == ["act_reduce", "geq_reduce", last]
        assert all(v == 0 for v in LAUNCHES.values())  # CPU: no launch


def test_general_route_raises():
    """What still raises on the general route (a row-wise sigma declared
    elementwise, malformed arguments), and the calls that raised before
    the route took the edge term and any width, which now compute: ``e``
    and ``e_basis`` with a row-wise sigma equal the pure ELL route's, H =
    257 takes the wide path of a row-wise sigma (on the CPU its plain
    versions), and max with tanh declared non-elementwise takes the max
    kernels' tanh form, JAX's max route (its Pallas builder in interpret
    mode)."""
    c = make_case("random", 24, with_jax=False)
    fg, plan = c.tfg, c.tfg.dst_plan
    eq, ek = _t(c.eq), _t(c.ek)
    act = ACTS["centered_relu"]
    e = _t(np.random.default_rng(2).normal(size=(fg.e_pad, 24)))
    torch.testing.assert_close(
        tmp.sir_aggregate(fg, eq, ek, act, "sum", e=e),
        tell.pure_ell_sir_aggregate(fg, eq, ek, act, "sum", e=e), **FWD_TOL)
    basis, w_edge = e[:, :5].contiguous(), e[:5].contiguous()
    torch.testing.assert_close(
        tmp.sir_aggregate(fg, eq, ek, act, "sym", e_basis=basis,
                          w_edge=w_edge),
        tell.pure_ell_sir_aggregate(fg, eq, ek, act, "sym",
                                    e=basis @ w_edge), **FWD_TOL)
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.ell as jell

    cj = make_case("random", 24)
    wr = np.random.default_rng(4).normal(size=(24, 8)).astype(np.float32)
    f = jell.make_ell_sir_aggregate_max_pallas(cj.jfg, jax_act("tanh"),
                                               interpret=True)
    np.testing.assert_allclose(
        tmp.sir_aggregate(cj.tfg, _t(cj.eq), _t(cj.ek), ACTS["tanh"], "max",
                          w_relation=_t(wr)).numpy(),
        np.asarray(f(cj.eq, cj.ek, jnp.zeros((0,), jnp.float32),
                     jnp.asarray(cj.jfg.edge_mask, jnp.float32), wr,
                     jnp.zeros((8,), jnp.float32))), **FWD_TOL)
    with pytest.raises(ValueError, match="declared elementwise"):
        tell.Activation("softmax", sir_elementwise=True)
    # H = 257 takes the wide path of a row-wise sigma, and chunks for an
    # elementwise one
    rng = np.random.default_rng(3)
    wide = _t(rng.normal(size=(fg.n_pad, 257)))
    args = (fg.dst_slot_srcnode, fg.dst_slot_scales["sym"], plan.row_key,
            plan.row_ptr)
    torch.testing.assert_close(ell_act_reduce_rowwise(wide, wide, *args, act),
                               ell_act_reduce_plain(wide, wide, *args, act))
    both = _t(rng.normal(size=(fg.n_pad, 514)))
    torch.testing.assert_close(
        ell_src_bwd_fused(both, wide, *args, act),
        ell_src_bwd_plain(both[:, :257], both[:, 257:], wide, *args, act))
    assert ell_act_reduce_rowwise(wide, wide, *args,
                                  ACTS["tanh"]).shape[1] == 257
    # the elementwise kernels refuse a row-wise sigma
    with pytest.raises(ValueError, match="needs an elementwise sigma"):
        ell_act_reduce(eq, ek, *args, act)
    with pytest.raises(ValueError, match="needs an elementwise sigma"):
        ell_src_bwd(eq, eq, ek, *args, tell.softmax)
    with pytest.raises(ValueError, match="g "):
        ell_geq_reduce(eq, ek, *args, act, eq[:-1].contiguous())
    with pytest.raises(TypeError, match="gz_dtype"):
        ell_act_reduce_bwd(eq, ek, *args, act, eq, gz_dtype=torch.float16)


def test_general_layout_python_side(monkeypatch):
    """``ell_general_layout`` checks its arguments before it asks the
    library, asks it by the ids of the source's modes for the five kernels
    with a lane-group path (#6 ``ell_act_reduce_bwd`` by MODE_EMIT, with
    its five tensors), answers None for #6 without asking where its g_slots
    is not in ek's type (the entry's mixed types take the first design),
    and its codes decode to the lane-group layout."""
    act = ACTS["centered_relu"]
    with pytest.raises(ValueError, match="not a kernel of the general"):
        ell_general_layout("ell_src_bwd", 96, torch.bfloat16, act)
    for h in (0, -4):
        with pytest.raises(ValueError, match="positive"):
            ell_general_layout("ell_geq_reduce", h, torch.bfloat16, act)
    with pytest.raises(ValueError, match="at most five"):
        ell_general_layout("ell_geq_reduce", 96, torch.bfloat16, act,
                           *[torch.zeros(1)] * 6)
    # MODE_GEQ, MODE_SRC, MODE_FWD, MODE_FUSED, MODE_EMIT of
    # csrc/ell_general_kernels.cu
    assert tkernels._GENERAL_LAYOUT_KERNEL == {
        "ell_geq_reduce": 0, "ell_src_bwd_rowwise": 1,
        "ell_act_reduce_rowwise": 2, "ell_src_bwd_fused": 3,
        "ell_act_reduce_bwd": 4}
    # #6 at the arxiv width in bf16, a library answering the layout the
    # source gives a vjp mode there: groups of 8 lanes, 2 chunks a lane
    asked = []

    class Library:
        def ell_general_layout(self, *args):
            asked.append(args)
            return 12 << 16 | 8 << 8 | 1

    monkeypatch.setattr(tkernels, "_library", lambda name: Library())
    bf = torch.bfloat16
    eq, ek, g = torch.zeros((4, 96)), torch.zeros((4, 96), dtype=bf), \
        torch.zeros((4, 96))
    gz, geq = torch.zeros((9, 96), dtype=bf), torch.zeros((4, 96))
    assert ell_general_layout("ell_act_reduce_bwd", 96, torch.bfloat16, act,
                              eq, ek, g, gz, geq) == GeneralLayout(
                                  12, 8, 4, 2, 1)
    (call,) = asked
    assert call[:4] == (4, 96, 1, act.kernel_id) and len(call) == 9
    assert call[4:] == tuple(t.data_ptr() for t in (eq, ek, g, gz, geq))
    assert ell_general_layout("ell_act_reduce_bwd", 96, torch.bfloat16, act,
                              eq, ek, g, gz.float(), geq) is None
    assert len(asked) == 1
    # the arxiv width: 12 chunks of bf16 on groups of 8 lanes (2 chunks, 16
    # values a lane), 24 of f32 on groups of 8 (3 chunks, 12 values); 64
    # chunks (H = 256, f32) on 16 lanes, 4 a lane
    assert decode_general_layout(12 << 16 | 8 << 8 | 2) == GeneralLayout(
        12, 8, 4, 2, 2)
    assert decode_general_layout(24 << 16 | 8 << 8 | 2) == GeneralLayout(
        24, 8, 4, 3, 2)
    assert decode_general_layout(64 << 16 | 16 << 8 | 2) == GeneralLayout(
        64, 16, 2, 4, 2)
    assert decode_general_layout(1 << 16 | 1 << 8 | 4) == GeneralLayout(
        1, 1, 32, 1, 4)
    # past H = 256 #1r, #3 and #4r take groups of the whole warp, one slot
    # a warp: at 512 64 chunks of bf16 (2 a lane) or 128 of f32 (4 a lane);
    # at 264 in f32 66 chunks, 3 a lane; #3 at 384 in f32 96 chunks, 3 a
    # lane
    assert decode_general_layout(64 << 16 | 32 << 8 | 1) == GeneralLayout(
        64, 32, 1, 2, 1)
    assert decode_general_layout(128 << 16 | 32 << 8 | 1) == GeneralLayout(
        128, 32, 1, 4, 1)
    assert decode_general_layout(66 << 16 | 32 << 8 | 1) == GeneralLayout(
        66, 32, 1, 3, 1)
    assert decode_general_layout(96 << 16 | 32 << 8 | 1) == GeneralLayout(
        96, 32, 1, 3, 1)
    assert decode_general_layout(0) is None
    for bad in (12 << 16 | 3 << 8 | 2, 12 << 16 | 64 << 8 | 2,
                4 << 8 | 2, 12 << 16 | 4 << 8, -1, 1 << 24 | 4 << 8 | 2):
        with pytest.raises(ValueError, match="no lane-group path"):
            decode_general_layout(bad)


def test_general_layout_asks_the_given_library(monkeypatch):
    """With ``lib`` (another build of the source, as the A/B tool passes
    it) ``ell_general_layout`` asks that library and not the package's:
    the A/B holds an output to the other build's bits only where both
    builds report the same path."""
    act = ACTS["softmax"]

    def refuse(name):
        raise AssertionError("the package's library was asked")

    class Other:
        def __init__(self):
            self.asked = []

        def ell_general_layout(self, *args):
            self.asked.append(args)
            return 1 << 30 | 16 << 16 | 1  # the parent's wide path at 512

        def ell_general_edge_layout(self, *args):
            self.asked.append(args)
            return 64 << 16 | 32 << 8 | 1

    monkeypatch.setattr(tkernels, "_library", refuse)
    other = Other()
    eq, g = torch.zeros((4, 512), dtype=torch.bfloat16), \
        torch.zeros((4, 512), dtype=torch.bfloat16)
    ek, out = torch.zeros((4, 512)), torch.zeros((4, 512))
    assert ell_general_layout("ell_src_bwd_rowwise", 512, torch.bfloat16,
                              act, eq, g, ek, out, lib=other) == \
        tkernels.WideLayout(16, 1)
    assert other.asked[-1][:4] == (1, 512, 1, act.kernel_id)
    assert ell_general_layout("ell_src_bwd_rowwise_edge", 512,
                              torch.bfloat16, act, eq, g, eq, ek, out,
                              lib=other) == GeneralLayout(64, 32, 1, 2, 1)
    assert other.asked[-1][:4] == (1, 512, 1, act.kernel_id)
    assert len(other.asked) == 2


def test_ell_ab_general_takes_hidden(tmp_path):
    """``--hidden`` is for ``--general`` too (H = 512 on the arxiv plan,
    the wide widths), positive only, and still refused without a mode that
    takes it (``--define`` stays the max mode's); with it the general mode
    still needs a card."""
    from sir_gcn_tpu_torch.tools import ell_ab

    other = str(tmp_path / "other.cu")
    for argv in (["--hidden", "512", other],
                 ["--lab", "--hidden", "512", other],
                 ["--general", "--hidden", "0", other],
                 ["--general", "--define", "X", other]):
        with pytest.raises(SystemExit):
            ell_ab.main(argv)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ell_ab.main(["--general", "--hidden", "512", other])


def test_ell_ab_general_needs_a_card(tmp_path):
    """The A/B tool's general mode (two ell_general_kernels.cu builds) runs
    on the card only, and --probes is not one of its options."""
    from sir_gcn_tpu_torch.tools import ell_ab

    with pytest.raises(SystemExit):
        ell_ab.main(["--general", "--probes", str(tmp_path / "other.cu")])
    with pytest.raises(SystemExit):
        ell_ab.main(["--general", "--edge", str(tmp_path / "other.cu")])
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ell_ab.main(["--general", str(tmp_path / "other.cu")])


# a full-warp #4r entry's ptxas report, as nvcc -Xptxas -v prints it
PTXAS_GROUP = (
    "_ZN55_GLOBAL__N__21ceaac0_22_ell_general_kernels_cu_b0490e7b12group_"
    "kernelILi3E13__nv_bfloat16Li32ELi2ELi1ELb0EEEvPKT0_S4_PKfS6_S4_PKiS8_"
    "S6_S8_S8_iifPfPS2_S9_")
PTXAS_LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z4copyPf' for 'sm_90a'
ptxas info    : Function properties for _Z4copyPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 8 registers, 360 bytes cmem[0]
ptxas info    : Compiling entry function '{PTXAS_GROUP}' for 'sm_90a'
ptxas info    : Function properties for {PTXAS_GROUP}
    24 bytes stack frame, 28 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers, 24 bytes cumulative
ptxas info    : Compile time = 9.542 ms
"""


def test_ptxas_entries_pairs_each_entry_with_its_report():
    """``build.ptxas_entries`` gives each entry function of a ``-Xptxas
    -v`` report its registers and spill stores, in order, and nothing for
    an empty report."""
    from sir_gcn_tpu_torch.ops.cuda import build

    assert build.ptxas_entries(PTXAS_LOG) == [("_Z4copyPf", 8, 0),
                                              (PTXAS_GROUP, 128, 28)]
    assert build.ptxas_entries("") == []


def test_general_source_builds_in_parts(monkeypatch, tmp_path):
    """The general source compiles as ``build.PARTS`` says: one ``nvcc -c``
    a part, each selecting its part by the macro the source reads, none
    with ``-shared``, then one link of the parts into the library; another
    source is one ``nvcc`` into its library, with no link."""
    from sir_gcn_tpu_torch.ops.cuda import build

    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    macro, n = build.PARTS["ell_general_kernels"]
    assert f"#ifdef {macro}" in build.SOURCES[
        "ell_general_kernels"].read_text()
    tmp = tmp_path / "lib.so.tmp"
    compiles, link = build._commands("ell_general_kernels", tmp)
    assert len(compiles) == n and n > 1
    objs = []
    for k, cmd in enumerate(compiles):
        assert cmd[0] == "nvcc" and "-c" in cmd and "-shared" not in cmd
        assert f"-D{macro}={k}" in cmd
        objs.append(cmd[cmd.index("-o") + 1])
    assert len(set(objs)) == n
    assert link[:2] == ["nvcc", "-shared"] and link[-n:] == objs
    assert link[link.index("-o") + 1] == str(tmp)
    single, none = build._commands("ell_edge_kernels", tmp)
    assert none is None and len(single) == 1 and "-shared" in single[0]
    assert single[0][-3:] == ["-o", str(tmp),
                              str(build.SOURCES["ell_edge_kernels"])]



def test_build_main_times_a_source_whole_or_in_parts(monkeypatch, tmp_path,
                                                     capsys):
    """``python -m sir_gcn_tpu_torch.ops.cuda.build NAME [SOURCE]
    [--whole]`` compiles NAME in its parts (one ``nvcc -c`` a part, then a
    link) or with ``--whole`` in one ``nvcc``, from SOURCE where given,
    prints how and in how many seconds, and leaves no directory behind."""
    import sys

    from sir_gcn_tpu_torch.ops.cuda import build

    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        "open(args[args.index('-o') + 1], 'w').write(' '.join(args))\n"
        "if '-shared' not in args or '-Xptxas' in args:\n"
        "    print(\"ptxas info : Compiling entry function '_Z1kv'\")\n"
        "    print('ptxas info : Used 8 registers')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    n = build.PARTS["ell_general_kernels"][1]
    build._main(["ell_general_kernels"])
    out = capsys.readouterr().out
    assert f"ell_general_kernels.cu in {n} parts in " in out
    assert out.rstrip().endswith(f" s, {n} kernels")
    other = tmp_path / "old.cu"
    other.write_text("")
    build._main(["ell_general_kernels", str(other), "--whole"])
    out = capsys.readouterr().out
    assert out.startswith(f"built {other} whole in ")
    assert out.rstrip().endswith(" s, 1 kernels")
    assert list((tmp_path / "kernels").iterdir()) == []

def test_ell_ab_wide_build_report_raises_on_no_entry():
    """``ell_ab.wide_build_report`` reports the full-warp entries of a
    build (registers, spills, warps an SM at 4 KB of key rows a warp) and
    raises where the report names none of ``WIDE_ENTRIES``."""
    from sir_gcn_tpu_torch.tools import ell_ab

    assert ell_ab.wide_build_report(PTXAS_LOG, 512, "this build") == [
        "group_kernelILi3E13__nv_bfloat16Li32ELi2ELi1ELb0E: 128 registers, "
        "28 B spill stores, 16 warps an SM"]
    for log in ("", PTXAS_LOG.replace(PTXAS_GROUP, "_Z5otherPf")):
        with pytest.raises(RuntimeError, match="names no entry"):
            ell_ab.wide_build_report(log, 512, "the other build")


def test_near_gate_flags_valid_slots_and_their_rows():
    """``checks.near_gate`` flags the (slot, feature) of a valid slot whose
    centered_relu gate z - alpha * mean(z) lies within NEAR_GATE of 0
    (relative to 1 + |alpha * mean|), and ``slot_rows`` the rows of a plan
    holding a flagged slot; chip_smoke's ``near_gates`` gives both and the
    count."""
    from chip_smoke import near_gates
    from sir_gcn_tpu_torch.ops.cuda.checks import (NEAR_GATE, near_gate,
                                                   slot_rows)

    act = tell.centered_relu(0.5)
    # slot 0: mean 1, gate z - 0.5 at feature 0 just inside the band;
    # slot 1 the same but at scale 0; slot 2 just outside; slot 3 far
    z = torch.tensor([[0.5 + 0.5 * NEAR_GATE, 1.0, 1.5, 1.0],
                      [0.5 + 0.5 * NEAR_GATE, 1.0, 1.5, 1.0],
                      [0.5 + 3.0 * NEAR_GATE, 1.0, 1.5, 1.0],
                      [2.0, 0.0, 0.0, 2.0]])
    z[:, 2] = 4.0 - z[:, 0] - z[:, 1] - z[:, 3]  # mean exactly 1
    scale = torch.tensor([1.0, 0.0, 1.0, 1.0])
    near = near_gate(z, scale, act)
    assert near.tolist() == [[True, False, False, False],
                             [False] * 4, [False] * 4, [False] * 4]
    plan = SimpleNamespace(row_ptr=torch.tensor([0, 1, 3, 3, 4],
                                                dtype=torch.int32))
    slots = near.any(1)
    assert slot_rows(plan, slots).tolist() == [True, False, False, False]
    assert slot_rows(plan, torch.tensor([False, False, True, True])
                     ).tolist() == [False, True, False, True]
    got = near_gates(plan, z, scale, act)
    assert got[0].tolist() == slots.tolist()
    assert got[1].tolist() == [True, False, False, False] and got[2] == 1


# ----------------------------------------------------------------------
# On the card: each kernel against its plain version
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the lane-group path of #3, #4r (csrc/ell_general_kernels.cu) for a
# row-wise sigma and of #5 for any sigma, by (H, gathered dtype): (16-byte
# chunks a row, lanes a group), the group the narrowest power of two that
# leaves a lane at most 16 values and 4 chunks of a row; None where the
# rows are not whole 16-byte chunks (the first design, which an elementwise
# sigma but in #5, and a misaligned table, also take)
GENERAL_PATHS = {(24, "bf16"): (3, 2), (24, "f32"): (6, 2),
                 (20, "bf16"): None, (20, "f32"): (5, 2),
                 (96, "bf16"): (12, 8), (96, "f32"): (24, 8),
                 (128, "bf16"): (16, 8), (128, "f32"): (32, 8),
                 (200, "bf16"): (25, 16), (200, "f32"): (50, 16),
                 (256, "bf16"): (32, 16), (256, "f32"): (64, 16)}


# #1r's, whose lane holds at most 24 values (the forward holds no
# cotangent row): groups of 4 lanes, 3 chunks each, at H = 96 in bf16
FWD_PATHS = {**GENERAL_PATHS, (24, "bf16"): (3, 1), (96, "bf16"): (12, 4)}


def assert_general_paths(h, dt, act, geq_args, src_args, both, outs,
                         aligned=True, emit=None):
    """#1r, #3 (``ell_geq_reduce``'s args: eq, ek, ..., g), #4r
    (``ell_src_bwd_rowwise``'s: eq, g, ek, ...), #5 (``both``, then #4r's
    ek) and, given its outputs ``emit`` (g_slots, geq_rows), #6 took the
    path GENERAL_PATHS names; ``outs`` are the outputs of #1r, #3, #4r and
    #5."""
    eq, ek, g = geq_args[0], geq_args[1], geq_args[-1]
    tables = {"ell_act_reduce_rowwise": (eq, ek, outs[0]),
              "ell_geq_reduce": (eq, ek, g, outs[1]),
              "ell_src_bwd_rowwise": (*src_args[:3], outs[2]),
              "ell_src_bwd_fused": (both, src_args[2], outs[3])}
    if emit is not None:
        tables["ell_act_reduce_bwd"] = (eq, ek, g, *emit)
    for name, ts in tables.items():
        group = aligned and (not act.diagonal or name == "ell_src_bwd_fused")
        paths = FWD_PATHS if name == "ell_act_reduce_rowwise" else \
            GENERAL_PATHS
        want = paths[h, dt] if group else None
        lay = ell_general_layout(name, h, DTYPES[dt], act, *ts)
        got = None if lay is None else (lay.chunks, lay.group_width)
        assert got == want, (name, h, dt, act.name, lay)
        assert lay is None or lay.inflight == 1, lay


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", sorted(CARD_ACTS))
@pytest.mark.parametrize("graph,h", [("hub", 24), ("random", 96),
                                     ("isolated", 200), ("random", 20),
                                     ("random", 128), ("random", 256)])
def test_general_kernels_match_plain_on_card(cuda_device, graph, h, act,
                                             dt):
    """Each kernel against its plain version, on the path its entry
    chooses: #1r, #3, #4r on the lane-group path for a row-wise sigma, #5
    for any sigma and #6 for a row-wise sigma, where a row is whole 16-byte
    chunks, else the first design (H = 20 in bf16; tanh sent down the
    general route and leaky_relu but in #5)."""
    c = make_case(graph, h, device=cuda_device, with_jax=False)
    d, tdt, tact, fg = cuda_device, DTYPES[dt], CARD_ACTS[act], c.tfg
    plan, splan = fg.dst_plan, fg.src_plan
    fwd = (_t(c.eq, device=d), _t(c.ek, tdt, d), fg.dst_slot_srcnode,
           _t(c.scales["dst"], device=d), plan.row_key, plan.row_ptr, tact)
    g = _t(c.g, device=d)
    eqb, gb = _t(c.eq, tdt, d), _t(c.g, tdt, d)
    rest = (_t(c.ek, device=d), fg.src_slot_dstnode,
            _t(c.scales["src"], device=d), splan.row_key, splan.row_ptr, tact)
    both = torch.cat([eqb, gb], 1)
    reset_launch_counts()
    got = (ell_act_reduce_rowwise(*fwd), ell_geq_reduce(*fwd, g),
           *ell_act_reduce_bwd(*fwd, g, gz_dtype=tdt),
           ell_src_bwd_rowwise(eqb, gb, *rest),
           ell_src_bwd_fused(both, *rest))
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {
        "ell_act_reduce_rowwise": 1, "ell_geq_reduce": 1,
        "ell_act_reduce_bwd": 1, "ell_src_bwd_rowwise": 1,
        "ell_src_bwd_fused": 1}
    want = (ell_act_reduce_plain(*fwd), ell_geq_reduce_plain(*fwd, g),
            *ell_act_reduce_bwd_plain(*fwd, g, tdt),
            ell_src_bwd_plain(eqb, gb, *rest),
            ell_src_bwd_fused_plain(both, *rest))
    gz_tol = BF16_STEP if dt == "bf16" else BWD_TOL
    for a, b, tol in zip(got, want, (FWD_TOL, BWD_TOL, gz_tol, BWD_TOL,
                                     BWD_TOL, BWD_TOL)):
        torch.testing.assert_close(a, b, **tol)
    assert_general_paths(h, dt, tact, fwd + (g,), (eqb, gb) + rest, both,
                         (got[0], got[1], got[4], got[5]), emit=got[2:4])


def _offset(t, aligned):
    """t itself, or a copy that starts one element into its storage (off
    16-byte alignment)."""
    if aligned:
        return t
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def awkward_plan(d):
    """Plans with odd row counts on both sides (a part-full last run of
    rows), rows of 40 to 256 slots (several 32-slot runs), budgets off
    multiples of 8 (10, 12, 28), a fifth of the scales zeroed and one
    multi-slot row with every scale 0: the FastGraph, its (dst, src) sym
    scales so zeroed, and the generator, to draw the tables from."""
    rng = np.random.default_rng(0)
    n = 70
    dst = np.concatenate([np.repeat([0, 1, 2, 3], [250, 40, 27, 45]),
                          rng.integers(4, n, 260)])
    src = rng.integers(0, n, dst.size)
    src[rng.permutation(dst.size)[:160]] = np.repeat([5, 6], [120, 40])
    fg = tell.build_fast_graph(build_graph(src, dst, n, device=d),
                               max_budget=256)
    scales = []
    for side in ("dst", "src"):
        plan = getattr(fg, f"{side}_plan")
        ptr = plan.row_ptr.cpu().numpy()
        budgets = np.diff(ptr)
        assert plan.num_rows % 2 == 1 and budgets.max() >= 128
        assert {b % 8 for b in budgets.tolist()} - {0}
        sc = getattr(fg, f"{side}_slot_scales")["sym"] * _t(
            rng.random(plan.num_slots) > 0.2, device=d)
        r = int(np.argmax(budgets >= 40))  # a row of 40 or more slots
        sc[int(ptr[r]):int(ptr[r + 1])] = 0.0
        scales.append(sc)
    return fg, scales, rng


@pytest.mark.cuda
@pytest.mark.parametrize("h,dt,aligned", [
    (96, "bf16", True), (96, "f32", True), (96, "bf16", False),
    (96, "f32", False), (24, "bf16", True), (128, "f32", True),
    (200, "bf16", True), (256, "bf16", True), (256, "f32", True)])
def test_general_kernels_on_awkward_plans_on_card(cuda_device, h, dt,
                                                  aligned):
    """#1r, #3, #4r and #5 (and #6 beside them) against their plain
    versions on the awkward plans (``awkward_plan``), for centered_relu,
    softmax, tanh sent down the general route and leaky_relu; with
    ``aligned`` False every node table, the [N, 2H] one too, starts one
    element past a 16-byte boundary (the first design)."""
    d, tdt = cuda_device, DTYPES[dt]
    fg, scales, rng = awkward_plan(d)
    eq, ek, g = (rng.normal(size=(fg.n_pad, h)).astype(np.float32)
                 for _ in range(3))
    eqd, gd = (_offset(_t(x, device=d), aligned) for x in (eq, g))
    ekf = _offset(_t(ek, device=d), aligned)
    ekt = _offset(_t(ek, tdt, d), aligned)
    eqt, gt = (_offset(_t(x, tdt, d), aligned) for x in (eq, g))
    plan, splan = fg.dst_plan, fg.src_plan
    both = _offset(torch.cat([eqt, gt], 1), aligned)
    for act in CARD_ACTS.values():
        fwd = (eqd, ekt, fg.dst_slot_srcnode, scales[0], plan.row_key,
               plan.row_ptr, act)
        bwd = (eqt, gt, ekf, fg.src_slot_dstnode, scales[1], splan.row_key,
               splan.row_ptr, act)
        got = (ell_act_reduce_rowwise(*fwd), ell_geq_reduce(*fwd, gd),
               *ell_act_reduce_bwd(*fwd, gd, gz_dtype=tdt),
               ell_src_bwd_rowwise(*bwd), ell_src_bwd_fused(both, *bwd[2:]))
        torch.cuda.synchronize()
        want = (ell_act_reduce_plain(*fwd), ell_geq_reduce_plain(*fwd, gd),
                *ell_act_reduce_bwd_plain(*fwd, gd, tdt),
                ell_src_bwd_plain(*bwd),
                ell_src_bwd_fused_plain(both, *bwd[2:]))
        gz_tol = BF16_STEP if dt == "bf16" else BWD_TOL
        for a, b, tol in zip(got, want, (FWD_TOL, BWD_TOL, gz_tol, BWD_TOL,
                                         BWD_TOL, BWD_TOL)):
            torch.testing.assert_close(a, b, **tol)
        assert_general_paths(h, dt, act, fwd + (gd,), bwd, both,
                             (got[0], got[1], got[4], got[5]), aligned,
                             emit=got[2:4])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", ["centered_relu", "softmax", "leaky_relu"])
def test_general_kernels_are_bitwise_repeatable_on_card(cuda_device, act,
                                                        dt):
    """Two launches of #1r, #3, #4r, #5 and #6 on the same inputs give
    bitwise equal rows (and #6 g_slots) on the lane-group path (for
    leaky_relu #5's; the others' first design): each sum's order is fixed
    by the layout, with no atomics. A graph of 4,000 nodes and 40,000
    edges fills many blocks."""
    rng = np.random.default_rng(7)
    n, e, d = 4000, 40000, cuda_device
    fg = tell.build_fast_graph(
        build_graph(rng.integers(0, n, e), rng.integers(0, n, e), n,
                    device=d), max_budget=64)
    tact, tdt = CARD_ACTS[act], DTYPES[dt]
    eq, ek, g = (_t(rng.normal(size=(fg.n_pad, 96)), device=d)
                 for _ in range(3))
    plan, splan = fg.dst_plan, fg.src_plan
    fwd = (eq, ek.to(tdt), fg.dst_slot_srcnode, fg.dst_slot_scales["sym"],
           plan.row_key, plan.row_ptr, tact)
    bwd = (eq.to(tdt), g.to(tdt), ek, fg.src_slot_dstnode,
           fg.src_slot_scales["sym"], splan.row_key, splan.row_ptr, tact)
    both = torch.cat(bwd[:2], 1)
    runs = [(ell_act_reduce_rowwise(*fwd), ell_geq_reduce(*fwd, g),
             ell_src_bwd_rowwise(*bwd), ell_src_bwd_fused(both, *bwd[2:]),
             *ell_act_reduce_bwd(*fwd, g, gz_dtype=tdt))
            for _ in range(2)]
    torch.cuda.synchronize()
    first, second = runs
    assert_general_paths(96, dt, tact, fwd + (g,), bwd, both, first[:4],
                         emit=first[4:])
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", ["centered_relu", "softmax"])
def test_act_reduce_bwd_rows_are_geq_bits_on_card(cuda_device, act, dt):
    """#6 on its lane-group path walks as #3 does: its g_eq rows are
    ``ell_geq_reduce``'s bits on the same inputs. A zero-scale slot's
    g_slots row is exactly +0 (a select, not a multiply: every bit 0). With
    g_slots in the other type than ek it takes the first design, within
    tolerance of the plain version."""
    rng = np.random.default_rng(11)
    n, e, d = 3000, 30000, cuda_device
    fg = tell.build_fast_graph(
        build_graph(rng.integers(0, n, e), rng.integers(0, n, e), n,
                    device=d), max_budget=64)
    plan, tact, tdt = fg.dst_plan, CARD_ACTS[act], DTYPES[dt]
    sc = fg.dst_slot_scales["sym"] * _t(rng.random(plan.num_slots) > 0.2,
                                        device=d)
    eq, ek, g = (_t(rng.normal(size=(fg.n_pad, 96)), device=d)
                 for _ in range(3))
    fwd = (eq, ek.to(tdt), fg.dst_slot_srcnode, sc, plan.row_key,
           plan.row_ptr, tact)
    gz, geq6 = ell_act_reduce_bwd(*fwd, g, gz_dtype=tdt)
    geq = ell_geq_reduce(*fwd, g)
    torch.cuda.synchronize()
    assert ell_general_layout("ell_act_reduce_bwd", 96, tdt, tact, eq,
                              fwd[1], g, gz, geq6) is not None
    assert torch.equal(geq6, geq)
    zero = sc == 0
    assert zero.any() and (sc != 0).any()
    bits = torch.int16 if dt == "bf16" else torch.int32
    assert (gz[zero].view(bits) == 0).all()
    other = torch.float32 if dt == "bf16" else torch.bfloat16
    gz2, geq2 = ell_act_reduce_bwd(*fwd, g, gz_dtype=other)
    torch.cuda.synchronize()
    assert ell_general_layout("ell_act_reduce_bwd", 96, tdt, tact, eq,
                              fwd[1], g, gz2, geq2) is None
    want = ell_act_reduce_bwd_plain(*fwd, g, other)
    torch.testing.assert_close(gz2, want[0], **(
        BF16_STEP if other == torch.bfloat16 else BWD_TOL))
    torch.testing.assert_close(geq2, want[1], **BWD_TOL)
    assert (gz2[zero].view(torch.int32 if dt == "bf16" else torch.int16)
            == 0).all()


# past H = 256, on whole 16-byte chunks: #1r and #4r on lane groups of the
# whole warp (#1r's bf16 form on groups of 16 to H = 384, where its lane
# still holds at most 24 values), (H, gathered dtype)
FULL_WARP_CASES = [(264, "bf16"), (264, "f32"), (384, "bf16"), (384, "f32"),
                   (512, "bf16"), (512, "f32"), (300, "f32")]


def full_warp_layout(name, h, dt):
    """The ``GeneralLayout`` the source gives ``name`` (#1r, #4r or an edge
    form) at H in (256, 512] on whole chunks: the narrowest group that
    leaves a lane at most 4 chunks and 16 values (24 in #1r without an
    edge term)."""
    c = h * (2 if dt == "bf16" else 4) // 16
    per, most = (8 if dt == "bf16" else 4), (
        24 if name == "ell_act_reduce_rowwise" else 16)
    gw = 16 if -(-c // 16) * per <= most and -(-c // 16) <= 4 else 32
    return GeneralLayout(c, gw, 32 // gw, -(-c // gw), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["centered_relu", "softmax"])
@pytest.mark.parametrize("h,dt", FULL_WARP_CASES)
def test_full_warp_groups_match_plain_on_card(cuda_device, h, dt, act):
    """#1r and #4r past H = 256 on the awkward plans (a part-full last run
    of rows, zero-scale slots and a multi-slot row all zero, budgets off
    multiples of 8, rows longer than 32 slots) against their plain
    versions at FWD_TOL and BWD_TOL, one launch each, on the lane-group
    layout ``full_warp_layout`` names (G = 1 at 512)."""
    d, tdt, tact = cuda_device, DTYPES[dt], ACTS[act]
    fg, scales, rng = awkward_plan(d)
    eq, ek, g = (rng.normal(size=(fg.n_pad, h)).astype(np.float32)
                 for _ in range(3))
    plan, splan = fg.dst_plan, fg.src_plan
    fwd = (_t(eq, device=d), _t(ek, tdt, d), fg.dst_slot_srcnode, scales[0],
           plan.row_key, plan.row_ptr, tact)
    bwd = (_t(eq, tdt, d), _t(g, tdt, d), _t(ek, device=d),
           fg.src_slot_dstnode, scales[1], splan.row_key, splan.row_ptr,
           tact)
    reset_launch_counts()
    rows, out = ell_act_reduce_rowwise(*fwd), ell_src_bwd_rowwise(*bwd)
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {
        "ell_act_reduce_rowwise": 1, "ell_src_bwd_rowwise": 1}
    torch.testing.assert_close(rows, ell_act_reduce_plain(*fwd), **FWD_TOL)
    torch.testing.assert_close(out, ell_src_bwd_plain(*bwd), **BWD_TOL)
    for name, ts in (("ell_act_reduce_rowwise", (fwd[0], fwd[1], rows)),
                     ("ell_src_bwd_rowwise", (*bwd[:3], out))):
        lay = ell_general_layout(name, h, tdt, tact, *ts)
        assert lay == full_warp_layout(name, h, dt), (name, h, dt, lay)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", ["centered_relu", "softmax"])
def test_full_warp_groups_are_bitwise_repeatable_on_card(cuda_device, act,
                                                         dt):
    """Two launches of #1r and #4r at H = 512 (one slot a warp, the row
    stored straight from each lane, no atomics) on a graph of 4,000 nodes
    and 40,000 edges (rows of up to 64 slots) give the same bits."""
    rng = np.random.default_rng(9)
    n, e, d, h = 4000, 40000, cuda_device, 512
    fg = tell.build_fast_graph(
        build_graph(rng.integers(0, n, e), rng.integers(0, n, e), n,
                    device=d), max_budget=64)
    tact, tdt = ACTS[act], DTYPES[dt]
    eq, ek, g = (_t(rng.normal(size=(fg.n_pad, h)), device=d)
                 for _ in range(3))
    plan, splan = fg.dst_plan, fg.src_plan
    fwd = (eq, ek.to(tdt), fg.dst_slot_srcnode, fg.dst_slot_scales["sym"],
           plan.row_key, plan.row_ptr, tact)
    bwd = (eq.to(tdt), g.to(tdt), ek, fg.src_slot_dstnode,
           fg.src_slot_scales["sym"], splan.row_key, splan.row_ptr, tact)
    first, second = [(ell_act_reduce_rowwise(*fwd), ell_src_bwd_rowwise(*bwd))
                     for _ in range(2)]
    torch.cuda.synchronize()
    assert ell_general_layout("ell_act_reduce_rowwise", h, tdt, tact,
                              fwd[0], fwd[1], first[0]) == full_warp_layout(
                                  "ell_act_reduce_rowwise", h, dt)
    assert ell_general_layout("ell_src_bwd_rowwise", h, tdt, tact, *bwd[:3],
                              first[1]) == full_warp_layout(
                                  "ell_src_bwd_rowwise", h, dt)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["centered_relu", "softmax"])
def test_general_layouts_past_256_on_card(cuda_device, act):
    """The path of each general kernel past H = 256 (``ell_general_layout``
    on aligned tables): at 512 #1r, #3 and #4r and their edge forms on
    groups of the whole warp, GeneralLayout(64, 32, 1, 2, 1) in bf16 and
    (128, 32, 1, 4, 1) in f32; #5 and #6 on the first design's wide path,
    WideLayout(16, 1); past 512 every kernel on the
    wide path's passes, WideLayout(8, n); and H = 300 in bf16 (rows that
    are not whole 16-byte chunks) the first design's wide path for all."""
    tact, d = ACTS[act], cuda_device
    group = {"ell_act_reduce_rowwise", "ell_src_bwd_rowwise",
             "ell_act_reduce_rowwise_edge", "ell_src_bwd_rowwise_edge",
             "ell_geq_reduce", "ell_geq_reduce_edge"}
    names = sorted(group | {"ell_src_bwd_fused", "ell_act_reduce_bwd"})
    for h, dt in ((512, "bf16"), (512, "f32"), (520, "bf16"), (520, "f32"),
                  (1024, "f32"), (300, "bf16")):
        tdt = DTYPES[dt]
        f32 = torch.zeros((4, h), device=d)
        gath = torch.zeros((4, h), dtype=tdt, device=d)
        both = torch.zeros((4, 2 * h), dtype=tdt, device=d)
        for name in names:
            ts = ((both, f32, f32) if name == "ell_src_bwd_fused" else
                  (f32, gath, f32, gath, f32) if name == "ell_act_reduce_bwd"
                  else (f32, gath, gath, f32))
            lay = ell_general_layout(name, h, tdt, tact, *ts)
            if h <= 512 and h * tdt.itemsize % 16 == 0 and name in group:
                want = GeneralLayout(h * tdt.itemsize // 16, 32, 1,
                                     h * tdt.itemsize // 512, 1)
            elif h <= 512:
                want = WideLayout(16, 1)
            else:
                want = WideLayout(8, -(-h // 256))
            assert lay == want, (name, h, dt, lay)



# #3 past H = 256: lane groups of the whole warp on whole 16-byte chunks up
# to 512 (G = 1, its two f32 key rows in 64 KB of a block's shared memory
# at 512), the first design's wide path past it, (H, gathered dtype)
GEQ_WIDE_CASES = [(264, "f32"), (384, "bf16"), (384, "f32"), (512, "bf16"),
                  (512, "f32"), (520, "bf16"), (520, "f32")]


def geq_gate_rows(plan, src, eq, ekt, scale, act, e=None):
    """[R] bool: under centered_relu the dst plan's rows holding a valid
    slot whose gate lies near 0 (``near_gate``) at #3's z = eq[key] +
    ek[src] (src the slots' gathered nodes; the edge form's add_cast(ek[src],
    e[edge]), in ek's type), which two orders of the mean's sum may set
    apart; none for another sigma."""
    if act.name != "centered_relu":
        return torch.zeros(plan.num_rows, dtype=torch.bool,
                           device=eq.device)
    kv = ekt.index_select(0, src)
    if e is not None:
        kv = tkernels.add_cast(kv, e.index_select(0, plan.slot_edge))
    z = eq.index_select(0, plan.slot_key) + kv.float()
    return slot_rows(plan, near_gate(z, scale, act).any(1))


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["centered_relu", "softmax"])
@pytest.mark.parametrize("h,dt", GEQ_WIDE_CASES)
def test_geq_full_warp_groups_match_plain_on_card(cuda_device, h, dt, act):
    """#3 past H = 256 on the awkward plans (a part-full last run of rows,
    zero-scale slots and a multi-slot row with no valid slot, budgets off
    multiples of 8, rows longer than 32 slots) against its plain version at
    BWD_TOL, the rows holding a centered_relu near gate left out; two
    launches give the same bits; the layout is ``full_warp_layout``'s up
    to 512 and the wide path's passes at 520."""
    d, tdt, tact = cuda_device, DTYPES[dt], ACTS[act]
    fg, scales, rng = awkward_plan(d)
    eq, ek, g = (rng.normal(size=(fg.n_pad, h)).astype(np.float32)
                 for _ in range(3))
    plan = fg.dst_plan
    fwd = (_t(eq, device=d), _t(ek, tdt, d), fg.dst_slot_srcnode, scales[0],
           plan.row_key, plan.row_ptr, tact)
    gd = _t(g, device=d)
    reset_launch_counts()
    first, second = ell_geq_reduce(*fwd, gd), ell_geq_reduce(*fwd, gd)
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {"ell_geq_reduce": 2}
    assert torch.equal(first, second)
    keep = ~geq_gate_rows(plan, fg.dst_slot_srcnode, fwd[0], fwd[1],
                          scales[0], tact)
    torch.testing.assert_close(first[keep],
                               ell_geq_reduce_plain(*fwd, gd)[keep],
                               **BWD_TOL)
    lay = ell_general_layout("ell_geq_reduce", h, tdt, tact, fwd[0], fwd[1],
                             gd, first)
    want = (full_warp_layout("ell_geq_reduce", h, dt) if h <= 512 else
            WideLayout(8, -(-h // 256)))
    assert lay == want, (h, dt, lay)
    if h <= 512:
        assert lay.group_width == 32, lay
