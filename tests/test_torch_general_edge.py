"""The port's general sigma route whole, against the JAX package's: the edge
term, erf-GELU and rows wider than 256.

* the plain versions of the edge-term forms ``ell_act_reduce_rowwise_edge``
  (#1r·e), ``ell_geq_reduce_edge`` (#3e) and ``ell_src_bwd_rowwise_edge``
  (#4r·e, with its per-edge cotangent g_e) against the Pallas kernels
  ``bucket_bcast_act_reduce``, ``bucket_geq_reduce`` and
  ``bucket_src_bwd(gz_dtype=...)`` in interpret mode, bucket by bucket, on
  the JAX route's ``add_cast`` inputs, with a fifth of the slot scales
  zeroed;
* ``sir_aggregate`` with ``e`` (and with ``e_basis``/``w_edge``) and a
  sigma that is not elementwise (centered_relu, softmax, erf-GELU and tanh
  declared non-elementwise) against the JAX package's ``sir_aggregate``
  on its Pallas routes in interpret mode
  (``make_ell_sir_aggregate_pallas(with_edge=True,
  act_elementwise=False)``): out and the gradients of eq, ek and e (and
  W_E), sum/mean/sym, static and DropEdge scales, f32 and bf16 edges;
* ``SIREConv`` with centered_relu(0.5) on a FastGraph against the JAX
  ``SIREConv`` through the weight bridge: out and every gradient, W_E's
  too;
* a row-wise sigma at H = 300 and H = 520 (the wide path) against the same
  JAX oracle, with and without ``e``;
* erf-GELU declared non-elementwise equal to its elementwise route, with
  and without ``e``; which kernels the edge form reaches.

Tolerances are the JAX suite's: forward atol 2e-4 / rtol 1e-4, gradients
atol 3e-4 / rtol 1e-3; a g_e rounded to bf16 at one bf16 step. JAX is
imported inside the tests that use it.

The ``cuda`` tests hold each new form (the three edge forms, erf-GELU on
#1r, #3, #4r, #5 and #6, and all five past H = 256) against its plain
version on the card, on awkward plans and tables off 16-byte alignment,
and ask two launches for the same bits; they skip where there is no card
(``pytest -m cuda --noconftest tests/test_torch_general_edge.py``).
"""

import dataclasses
import functools
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
    ell_act_reduce_bwd,
    ell_act_reduce_bwd_plain,
    ell_act_reduce_plain,
    ell_act_reduce_rowwise,
    ell_act_reduce_rowwise_edge,
    ell_general_layout,
    ell_geq_reduce,
    ell_geq_reduce_edge,
    ell_geq_reduce_plain,
    ell_src_bwd_fused,
    ell_src_bwd_fused_plain,
    ell_src_bwd_plain,
    ell_src_bwd_rowwise,
    ell_src_bwd_rowwise_edge,
    reset_launch_counts,
)
from sir_gcn_tpu_torch.ops.cuda.checks import near_gate, slot_rows

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
BF16_STEP = dict(atol=3e-4, rtol=2.0 ** -7)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
ALPHA = 0.5
SLOPE = 0.2
# the port's sigma by name: the row-wise entries, and erf-GELU and tanh
# declared non-elementwise (the general route)
ACTS = {"centered_relu": tell.centered_relu(ALPHA), "softmax": tell.softmax,
        "gelu": dataclasses.replace(tell.gelu(), sir_elementwise=False),
        "tanh": dataclasses.replace(tell.tanh, sir_elementwise=False)}


def jax_act(name: str):
    """The JAX sigma of ``name``, a fresh function each call (JAX caches
    its routing by the function's id); erf-GELU and tanh carry
    ``sir_elementwise = False``, as the port's do."""
    import jax
    import jax.numpy as jnp

    fns = {"centered_relu": lambda z: jax.nn.relu(
               z - ALPHA * z.mean(-1, keepdims=True)),
           "softmax": lambda z: jax.nn.softmax(z, axis=-1),
           "gelu": lambda z: jax.nn.gelu(z, approximate=False),
           "tanh": lambda z: jnp.tanh(z),
           "leaky_relu": lambda z: jax.nn.leaky_relu(z, SLOPE)}
    fn = fns[name]
    if name in ("gelu", "tanh"):
        fn.sir_elementwise = False
    return fn


def make_case(h: int, seed: int = 0, n: int = 44, edges: int = 230,
              with_jax: bool = True, device="cpu"):
    """Both packages' FastGraphs of one random graph (budgets 1..16, nodes
    40..43 without an edge), node tables eq/ek/g [N, H], an edge table
    e [E_pad, H], sym slot scales with a fifth of the slots zeroed, and a
    DropEdge mask [E_pad] that keeps four fifths of the edges."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n - 4, edges), rng.integers(0, n - 4, edges)
    tfg = tell.build_fast_graph(build_graph(src, dst, n, device=device),
                                max_budget=16)
    jfg = None
    if with_jax:
        import sir_gcn_tpu.ops.ell as jell
        from sir_gcn_tpu import build_graph as j_build_graph

        jfg = jell.build_fast_graph(j_build_graph(src, dst, n), max_budget=16)
    eq, ek, g = (rng.normal(size=(tfg.n_pad, h)).astype(np.float32)
                 for _ in range(3))
    e = rng.normal(size=(tfg.e_pad, h)).astype(np.float32)
    scales = {}
    for side in ("dst", "src"):
        s = getattr(tfg, f"{side}_slot_scales")["sym"].cpu().numpy()
        scales[side] = (s * (rng.random(s.shape) > 0.2)).astype(np.float32)
    return SimpleNamespace(tfg=tfg, jfg=jfg, eq=eq, ek=ek, g=g, e=e,
                           scales=scales, mask=rng.random(tfg.e_pad) >= 0.2,
                           rng=rng)


def _t(x, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(np.asarray(x)).to(device=device, dtype=dtype)


def _jnp(x):
    import jax.numpy as jnp

    return jnp.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX package's routes as on its accelerator: ``pallas_available``
    True, and the Pallas factories in interpret mode."""
    import sir_gcn_tpu.ops.ell as jell
    import sir_gcn_tpu.ops.pallas as jpallas

    monkeypatch.setattr(jpallas, "pallas_available", lambda: True)
    for name in ("make_ell_sir_aggregate_pallas",
                 "make_ell_sir_aggregate_pallas_fused_edge"):
        monkeypatch.setattr(jell, name, functools.partial(
            getattr(jell, name), interpret=True))


@pytest.fixture
def edge_dtype():
    """Set both packages' edge dtype; back to f32 after the test."""
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.message_passing as jmp

    def use(dt):
        tmp.set_edge_dtype(DTYPES[dt] if dt == "bf16" else None)
        jmp.set_edge_dtype(jnp.bfloat16 if dt == "bf16" else None)
    yield use
    tmp.set_edge_dtype(None)
    jmp.set_edge_dtype(None)


# ----------------------------------------------------------------------
# (a) The plain edge forms against the Pallas kernels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("act,dt,h", [("centered_relu", "bf16", 24),
                                      ("softmax", "f32", 24),
                                      ("gelu", "bf16", 16)])
def test_edge_plains_match_pallas(act, dt, h):
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.ell as jell
    from sir_gcn_tpu.ops import pallas

    tdt = DTYPES[dt]
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    jact = jax_act(act)
    c = make_case(h, seed=1)
    fg = c.tfg
    plan, splan = fg.dst_plan, fg.src_plan
    sd, ss = c.scales["dst"], c.scales["src"]

    def add_cast(a, b):  # the JAX route's, in the edge dtype
        return (a.astype(jnp.float32) + b.astype(jnp.float32)).astype(jdt)

    e_j = jnp.asarray(c.e).astype(jdt)
    ekg = add_cast(jnp.take(jnp.asarray(c.ek).astype(jdt),
                            _jnp(fg.dst_slot_srcnode), axis=0),
                   jnp.take(e_j, _jnp(plan.slot_edge), axis=0))
    eq_rows = jnp.take(jnp.asarray(c.eq), _jnp(plan.row_key), axis=0)
    g_rows = jnp.take(jnp.asarray(c.g), _jnp(plan.row_key), axis=0)
    want1, want3 = [], []
    for b, nr, so, ro in jell._bucket_offsets(plan.buckets1):
        args = (ekg[so:so + b * nr], eq_rows[ro:ro + nr],
                jnp.asarray(sd[so:so + b * nr]).reshape(nr, b))
        want1.append(np.asarray(pallas.bucket_bcast_act_reduce(
            *args, b, jact, interpret=True)))
        want3.append(np.asarray(pallas.bucket_geq_reduce(
            *args, g_rows[ro:ro + nr], b, jact, interpret=True)))

    te = _t(c.e, tdt)
    fwd = (_t(c.eq), _t(c.ek, tdt), fg.dst_slot_srcnode, _t(sd), plan.row_key,
           plan.row_ptr, ACTS[act])
    np.testing.assert_allclose(
        ell_act_reduce_rowwise_edge(*fwd, te, plan.slot_edge).numpy(),
        np.concatenate(want1), **FWD_TOL)
    np.testing.assert_allclose(
        ell_geq_reduce_edge(*fwd, _t(c.g), te, plan.slot_edge).numpy(),
        np.concatenate(want3), **BWD_TOL)

    # the src-major backward with its per-slot g_z in the edge dtype, taken
    # through _edge_cotangent
    idx = _jnp(fg.src_slot_dstnode)
    eqg = add_cast(jnp.take(jnp.asarray(c.eq).astype(jdt), idx, axis=0),
                   jnp.take(e_j, _jnp(splan.slot_edge), axis=0))
    gg = jnp.take(jnp.asarray(c.g).astype(jdt), idx, axis=0)
    ek_rows = jnp.take(jnp.asarray(c.ek), _jnp(splan.row_key), axis=0)
    want4, gzs = [], []
    for b, nr, so, ro in jell._bucket_offsets(splan.buckets1):
        r, gz = pallas.bucket_src_bwd(
            eqg[so:so + b * nr], ek_rows[ro:ro + nr],
            jnp.asarray(ss[so:so + b * nr]).reshape(nr, b),
            gg[so:so + b * nr], b, jact, interpret=True, gz_dtype=jdt)
        want4.append(np.asarray(r))
        gzs.append(gz)
    want_ge = np.asarray(jell._edge_cotangent(
        jnp.concatenate(gzs), _jnp(fg.edge2src_slot), _jnp(fg.edge_mask)))
    rows, g_e = ell_src_bwd_rowwise_edge(
        _t(c.eq, tdt), _t(c.g, tdt), _t(c.ek), fg.src_slot_dstnode, _t(ss),
        splan.row_key, splan.row_ptr, ACTS[act], te, splan.slot_edge,
        fg.edge2src_slot, fg.edge_mask)
    np.testing.assert_allclose(rows.numpy(), np.concatenate(want4),
                               **BWD_TOL)
    assert g_e.dtype == torch.float32 and g_e.shape == (fg.e_pad, h)
    np.testing.assert_allclose(g_e.numpy(), want_ge,
                               **(BF16_STEP if dt == "bf16" else BWD_TOL))


# ----------------------------------------------------------------------
# (b), (d) sir_aggregate with an edge term, and past H = 256
# ----------------------------------------------------------------------

def _port(c, act, agg, via, mask, w, wb=None):
    """out and the gradients of eq, ek and e (W_E with ``via`` "basis")
    of the port's ``sir_aggregate``; ``via`` None: no edge term."""
    ts = [_t(c.eq).requires_grad_(), _t(c.ek).requires_grad_()]
    kw = {}
    if via == "e":
        ts.append(_t(c.e).requires_grad_())
        kw = dict(e=ts[-1])
    elif via == "basis":
        ts.append(_t(wb[1]).requires_grad_())
        kw = dict(e_basis=_t(wb[0]), w_edge=ts[-1])
    out = tmp.sir_aggregate(
        c.tfg, ts[0], ts[1], ACTS[act], agg,
        edge_mask=None if mask is None else torch.from_numpy(mask), **kw)
    (out * _t(w)).sum().backward()
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def _jax(c, act, agg, via, mask, w, wb=None):
    """The same from the JAX package's ``sir_aggregate`` (its Pallas routes
    in interpret mode under the ``jax_pallas`` fixture)."""
    import jax
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.message_passing as jmp

    jact = jax_act(act)
    vals = [jnp.asarray(c.eq), jnp.asarray(c.ek)]
    if via == "e":
        vals.append(jnp.asarray(c.e))
    elif via == "basis":
        vals.append(jnp.asarray(wb[1]))

    def loss(*v):
        kw = {}
        if via == "e":
            kw = dict(e=v[2])
        elif via == "basis":
            kw = dict(e_basis=jnp.asarray(wb[0]), w_edge=v[2])
        y = jmp.sir_aggregate(c.jfg, v[0], v[1], jact, agg,
                              edge_mask=None if mask is None
                              else jnp.asarray(mask), **kw)
        return jnp.sum(y * w), y

    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(vals))), has_aux=True)(*vals)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _assert_same(got, want, names=("out", "eq", "ek", "e")):
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL, err_msg="out")
    for name, a, b in zip(names[1:], got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **BWD_TOL, err_msg=name)


@pytest.mark.parametrize("act,agg,dt,via,dropedge", [
    ("centered_relu", "sum", "f32", "e", False),
    ("centered_relu", "sym", "bf16", "e", True),
    ("softmax", "mean", "bf16", "e", False),
    ("softmax", "sym", "f32", "basis", True),
    ("gelu", "sym", "bf16", "e", False),
    ("gelu", "mean", "f32", "e", True),
    ("tanh", "sum", "bf16", "basis", False),
    ("tanh", "mean", "bf16", "e", True),
])
def test_general_edge_route_matches_jax(act, agg, dt, via, dropedge,
                                        jax_pallas, edge_dtype):
    """``sir_aggregate`` with an edge term and a sigma that is not
    elementwise: the general route's edge forms (#1r·e; #3e and #4r·e in
    the backward), out and every gradient; ``via`` "basis" passes e_basis
    and w_edge, which the port, as JAX, turns into e = e_basis @ w_edge on
    this route. Without a gradient the forward alone gives the same out."""
    edge_dtype(dt)
    c = make_case(16, seed=2)
    w = c.rng.normal(size=c.eq.shape).astype(np.float32)
    wb = (c.rng.normal(size=(c.tfg.e_pad, 5)).astype(np.float32),
          (0.3 * c.rng.normal(size=(5, 16))).astype(np.float32))
    mask = c.mask if dropedge else None
    got = _port(c, act, agg, via, mask, w, wb)
    names = ("out", "eq", "ek", "w_edge" if via == "basis" else "e")
    _assert_same(got, _jax(c, act, agg, via, mask, w, wb), names)
    with torch.no_grad():
        kw = (dict(e=_t(c.e)) if via == "e" else
              dict(e_basis=_t(wb[0]), w_edge=_t(wb[1])))
        out = tmp.sir_aggregate(
            c.tfg, _t(c.eq), _t(c.ek), ACTS[act], agg,
            edge_mask=None if mask is None else torch.from_numpy(mask),
            **kw)
    np.testing.assert_allclose(out.numpy(), got[0], **FWD_TOL)


@pytest.mark.parametrize("h,act,via,dt", [(300, "centered_relu", "e", "bf16"),
                                          (300, "softmax", None, "f32"),
                                          (520, "softmax", "e", "f32"),
                                          (520, "centered_relu", None,
                                           "bf16"),
                                          (512, "centered_relu", None,
                                           "bf16"),
                                          (512, "centered_relu", "e",
                                           "bf16"),
                                          (512, "softmax", None, "f32"),
                                          (512, "softmax", "e", "f32")])
def test_wide_rowwise_matches_jax(h, act, via, dt, jax_pallas, edge_dtype):
    """A row-wise sigma past H = 256 (on the card #1r and #4r take
    full-warp lane groups up to 512 on whole 16-byte chunks, the rest the
    wide path), with and without an edge term, sym scales: out and every
    gradient against the JAX package's general route."""
    edge_dtype(dt)
    c = make_case(h, seed=3, n=24, edges=90)
    w = c.rng.normal(size=c.eq.shape).astype(np.float32)
    got = _port(c, act, "sym", via, None, w)
    _assert_same(got, _jax(c, act, "sym", via, None, w))


@pytest.mark.parametrize("agg,dt,via", [("sym", "bf16", None),
                                        ("mean", "f32", "e"),
                                        ("sum", "bf16", "e")])
def test_gelu_forced_general_equals_elementwise(agg, dt, via):
    """erf-GELU declared non-elementwise (the general route: #1r, #3, #4r,
    or their edge forms) gives the elementwise route's out and gradients
    (#2, #4, or theirs)."""
    tmp.set_edge_dtype(DTYPES[dt] if dt == "bf16" else None)
    try:
        c = make_case(40, seed=5, with_jax=False)
        w = c.rng.normal(size=c.eq.shape).astype(np.float32)
        acts = (ACTS["gelu"], tell.gelu())
        assert not acts[0].elementwise and acts[1].elementwise
        runs = []
        for act in acts:
            ts = [_t(c.eq).requires_grad_(), _t(c.ek).requires_grad_(),
                  _t(c.e).requires_grad_()]
            out = tmp.sir_aggregate(c.tfg, ts[0], ts[1], act, agg,
                                    **(dict(e=ts[2]) if via else {}))
            (out * _t(w)).sum().backward()
            runs.append([out.detach().numpy()] + [
                t.grad.numpy() for t in ts[:3 if via else 2]])
        _assert_same(*runs)
    finally:
        tmp.set_edge_dtype(None)


# ----------------------------------------------------------------------
# (c) SIREConv with a row-wise sigma through the weight bridge
# ----------------------------------------------------------------------

def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items")
                   else {prefix + (k,): np.asarray(v)})
    return out


@pytest.mark.parametrize("agg", ["sym", "mean"])
def test_sireconv_centered_relu_matches_jax(agg, jax_pallas):
    """``SIREConv(act=centered_relu(0.5))`` on a FastGraph with raw edge
    features (the e_basis call, which takes the general route's edge
    forms) against the JAX ``SIREConv``: out, the input's gradient and
    every parameter's, W_E's among them."""
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.models.conv import SIREConv as JSIREConv

    from sir_gcn_tpu_torch.models import SIREConv
    from sir_gcn_tpu_torch.utils import load_jax_variables
    from sir_gcn_tpu_torch.utils.convert import _slots

    de, h = 5, 16
    c = make_case(h, seed=11, with_jax=True)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(c.tfg.n_pad, 12)).astype(np.float32)
    ef = rng.normal(size=(c.tfg.graph.num_edges, de)).astype(np.float32)
    w = rng.normal(size=(c.tfg.n_pad, 8)).astype(np.float32)
    jconv = JSIREConv(hidden_dim=h, output_dim=8,
                      activation=jax_act("centered_relu"), agg_type=agg)
    variables = jax.tree_util.tree_map(np.asarray, jconv.init(
        jax.random.PRNGKey(2), c.jfg, jnp.asarray(x), jnp.asarray(ef)))
    conv = SIREConv(12, de, h, 8, ACTS["centered_relu"], agg_type=agg)
    load_jax_variables(conv, variables)
    slots = _slots(conv)
    assert ("params", "linear_edge", "Dense_0", "kernel") in slots

    tx = _t(x).requires_grad_()
    out = conv(c.tfg, tx, _t(ef))
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


# ----------------------------------------------------------------------
# Which kernels the edge form reaches, and the layout's wide code
# ----------------------------------------------------------------------

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


def test_general_edge_route_reaches_its_kernels(kernel_calls):
    """With e (or e_basis) and a sigma that is not elementwise the route
    runs the edge forms' plain versions on the CPU (#1r·e forward, #3e and
    #4r·e backward), with fuse_bwd_take ignored, and launches nothing; the
    fused-edge kernels are not reached, and their entry refuses such a
    sigma."""
    c = make_case(16, with_jax=False)
    fg, act = c.tfg, ACTS["centered_relu"]
    eq, ek = _t(c.eq).requires_grad_(), _t(c.ek).requires_grad_()
    e = _t(c.e).requires_grad_()
    reset_launch_counts()
    with torch.no_grad():
        tmp.sir_aggregate(fg, eq, ek, act, "sym", e=e)
    assert kernel_calls == ["act_reduce"]
    kernel_calls.clear()
    tell.ell_sir_aggregate(fg, eq, ek, act, "sym", e=e,
                           fuse_bwd_take=True).sum().backward()
    # ell_geq_reduce's plain version runs ell_act_reduce_bwd's
    assert kernel_calls == ["act_reduce", "geq_reduce", "act_reduce_bwd",
                            "src_bwd"]
    assert e.grad is not None and e.grad.shape == (fg.e_pad, 16)
    kernel_calls.clear()
    tmp.sir_aggregate(fg, eq, ek, act, "sym", e_basis=_t(c.e[:, :5]),
                      w_edge=torch.ones(5, 16)).sum().backward()
    assert "edge_act_reduce2" not in kernel_calls
    assert kernel_calls[0] == "act_reduce"
    assert all(v == 0 for v in LAUNCHES.values())  # CPU: no launch
    with pytest.raises(ValueError, match="elementwise sigma"):
        tell.ell_sir_aggregate_fused_edge(fg, eq, ek, _t(c.e[:, :5]),
                                          torch.ones(5, 16), act, "sym")


def test_wide_layout_python_side(monkeypatch):
    """The wide path's layout codes decode to a ``WideLayout`` (16 features
    a lane and one chunk up to H = 512, 8 a lane and chunks of 256 past
    it); the edge forms ask the library's ``ell_general_edge_layout`` with
    six tables by their modes' ids; #6 with g_slots in another type asks
    the library past H = 256 (the wide path takes any types) and answers
    None below."""
    assert decode_general_layout(1 << 30 | 16 << 16 | 1) == WideLayout(16, 1)
    assert decode_general_layout(1 << 30 | 8 << 16 | 3) == WideLayout(8, 3)
    for bad in (1 << 30, 1 << 30 | 8 << 16, 1 << 30 | 1 << 16 | 2,
                1 << 31 | 8 << 16 | 2):
        with pytest.raises(ValueError, match="no lane-group path"):
            decode_general_layout(bad)
    assert tkernels._GENERAL_EDGE_LAYOUT_KERNEL == {
        "ell_geq_reduce_edge": 0, "ell_src_bwd_rowwise_edge": 1,
        "ell_act_reduce_rowwise_edge": 2}
    asked = []

    class Library:
        def ell_general_layout(self, *args):
            asked.append(("plain",) + args)
            return 1 << 30 | 16 << 16 | 1

        def ell_general_edge_layout(self, *args):
            asked.append(("edge",) + args)
            return 12 << 16 | 8 << 8 | 1

    monkeypatch.setattr(tkernels, "_library", lambda name: Library())
    act = ACTS["centered_relu"]
    ts = [torch.zeros((4, 96)) for _ in range(6)]
    assert ell_general_layout("ell_src_bwd_rowwise_edge", 96, torch.bfloat16,
                              act, *ts) == GeneralLayout(12, 8, 4, 2, 1)
    assert asked[-1][:5] == ("edge", 1, 96, 1, act.kernel_id)
    assert len(asked[-1]) == 11
    with pytest.raises(ValueError, match="at most six"):
        ell_general_layout("ell_geq_reduce_edge", 96, torch.float32, act,
                           *ts, ts[0])
    eq, g = torch.zeros((4, 300)), torch.zeros((4, 300))
    ek, gz = torch.zeros((4, 300), dtype=torch.bfloat16), torch.zeros((9, 300))
    assert ell_general_layout("ell_act_reduce_bwd", 300, torch.bfloat16, act,
                              eq, ek, g, gz, eq) == WideLayout(16, 1)
    assert asked[-1][:2] == ("plain", 4)
    n = len(asked)
    assert ell_general_layout("ell_act_reduce_bwd", 96, torch.bfloat16, act,
                              *[t[:, :96] for t in (eq, ek, g, gz, eq)]) \
        is None
    assert len(asked) == n


# ----------------------------------------------------------------------
# On the card: each new form against its plain version
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _offset(t, aligned):
    """t itself, or a copy that starts one element into its storage (off
    16-byte alignment)."""
    if aligned:
        return t
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def awkward_case(h, dt, aligned, device):
    """A plan with odd row counts on both sides (a part-full last run of
    rows), rows of 40 to 256 slots, budgets off multiples of 8, a fifth of
    the scales zeroed and one multi-slot row with every scale 0; node and
    edge tables in the gathered type, optionally off 16-byte alignment."""
    rng = np.random.default_rng(0)
    n, d, tdt = 70, device, DTYPES[dt]
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
        r = int(np.argmax(budgets >= 40))
        sc[int(ptr[r]):int(ptr[r + 1])] = 0.0
        scales.append(sc)
    eq, ek, g = (rng.normal(size=(fg.n_pad, h)).astype(np.float32)
                 for _ in range(3))
    e = rng.normal(size=(fg.e_pad, h)).astype(np.float32)
    off = functools.partial(_offset, aligned=aligned)
    return SimpleNamespace(
        fg=fg, sd=scales[0], ss=scales[1], eqd=off(_t(eq, device=d)),
        gd=off(_t(g, device=d)), ekf=off(_t(ek, device=d)),
        ekt=off(_t(ek, tdt, d)), eqt=off(_t(eq, tdt, d)),
        gt=off(_t(g, tdt, d)), et=off(_t(e, tdt, d)), tdt=tdt,
        aligned=aligned)


def edge_runs(c, act):
    """(kernel, plain, tolerances, layout name and tables) of the three
    edge forms on the case ``c``."""
    fg = c.fg
    plan, splan = fg.dst_plan, fg.src_plan
    fwd = (c.eqd, c.ekt, fg.dst_slot_srcnode, c.sd, plan.row_key,
           plan.row_ptr, act)
    bwd = (c.eqt, c.gt, c.ekf, fg.src_slot_dstnode, c.ss, splan.row_key,
           splan.row_ptr, act)
    fe = (c.et, plan.slot_edge)
    be = (c.et, splan.slot_edge, fg.edge2src_slot, fg.edge_mask)
    ge_tol = BF16_STEP if c.tdt == torch.bfloat16 else BWD_TOL
    return {
        "ell_act_reduce_rowwise_edge": (
            lambda: ell_act_reduce_rowwise_edge(*fwd, *fe),
            lambda: ell_act_reduce_plain(*fwd, e=c.et,
                                         slot_edge=plan.slot_edge),
            (FWD_TOL,), (c.eqd, c.ekt, c.et)),
        "ell_geq_reduce_edge": (
            lambda: ell_geq_reduce_edge(*fwd, c.gd, *fe),
            lambda: ell_geq_reduce_plain(*fwd, c.gd, e=c.et,
                                         slot_edge=plan.slot_edge),
            (BWD_TOL,), (c.eqd, c.ekt, c.et, c.gd)),
        "ell_src_bwd_rowwise_edge": (
            lambda: ell_src_bwd_rowwise_edge(*bwd, *be),
            lambda: ell_src_bwd_plain(*bwd, e=c.et, slot_edge=splan.slot_edge,
                                      edge2slot=fg.edge2src_slot,
                                      edge_mask=fg.edge_mask),
            (BWD_TOL, ge_tol), (c.eqt, c.gt, c.et, c.ekf)),
    }


def general_runs(c, act):
    """The same for #1r, #3, #6, #4r and #5 (``both`` the [N, 2H] table)."""
    fg = c.fg
    plan, splan = fg.dst_plan, fg.src_plan
    fwd = (c.eqd, c.ekt, fg.dst_slot_srcnode, c.sd, plan.row_key,
           plan.row_ptr, act)
    bwd = (c.eqt, c.gt, c.ekf, fg.src_slot_dstnode, c.ss, splan.row_key,
           splan.row_ptr, act)
    both = _offset(torch.cat([c.eqt, c.gt], 1), c.aligned)
    gz_tol = BF16_STEP if c.tdt == torch.bfloat16 else BWD_TOL
    return {
        "ell_act_reduce_rowwise": (
            lambda: ell_act_reduce_rowwise(*fwd),
            lambda: ell_act_reduce_plain(*fwd), (FWD_TOL,),
            (c.eqd, c.ekt)),
        "ell_geq_reduce": (
            lambda: ell_geq_reduce(*fwd, c.gd),
            lambda: ell_geq_reduce_plain(*fwd, c.gd), (BWD_TOL,),
            (c.eqd, c.ekt, c.gd)),
        "ell_act_reduce_bwd": (
            lambda: ell_act_reduce_bwd(*fwd, c.gd, gz_dtype=c.tdt),
            lambda: ell_act_reduce_bwd_plain(*fwd, c.gd, c.tdt),
            (gz_tol, BWD_TOL), (c.eqd, c.ekt, c.gd)),
        "ell_src_bwd_rowwise": (
            lambda: ell_src_bwd_rowwise(*bwd), lambda: ell_src_bwd_plain(*bwd),
            (BWD_TOL,), (c.eqt, c.gt, c.ekf)),
        "ell_src_bwd_fused": (
            lambda: ell_src_bwd_fused(both, *bwd[2:]),
            lambda: ell_src_bwd_fused_plain(both, *bwd[2:]), (BWD_TOL,),
            (both, c.ekf)),
    }


# #1r, #3 and #4r and their edge forms: the kernels whose lane groups
# widen to the whole warp past H = 256, up to 512
FULL_WARP = ("ell_act_reduce_rowwise", "ell_act_reduce_rowwise_edge",
             "ell_geq_reduce", "ell_geq_reduce_edge",
             "ell_src_bwd_rowwise", "ell_src_bwd_rowwise_edge")


def _want_path(name, act, h, dt, aligned):
    """The path the entries choose: "group" for the lane-group path (a
    row-wise sigma, or any in #5, on whole, aligned 16-byte chunks up to H
    = 256, and up to 512 in #1r, #3 and #4r and their edge forms), "wide" for
    a row-wise sigma past 256 that it does not take, None for the first
    design."""
    group = not act.diagonal or name == "ell_src_bwd_fused"
    whole = h * (2 if dt == "bf16" else 4) % 16 == 0
    most = 512 if name in FULL_WARP else 256
    if group and aligned and whole and h <= most:
        return "group"
    return "wide" if not act.diagonal and h > 256 else None


def _run_and_compare(runs, act, h, dt, aligned):
    """Each of ``runs`` launched once against its plain version, on the
    path ``_want_path`` names; returns name -> its layout."""
    lays = {}
    for name, (kernel, plain, tols, tables) in runs.items():
        reset_launch_counts()
        got = kernel()
        torch.cuda.synchronize()
        assert {k: v for k, v in LAUNCHES.items() if v} == {name: 1}
        want = plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b, tol in zip(got, want, tols):
            torch.testing.assert_close(a, b, **tol)
        lay = ell_general_layout(name, h, tables[1].dtype if name not in (
            "ell_src_bwd_rowwise", "ell_src_bwd_rowwise_edge",
            "ell_src_bwd_fused") else tables[0].dtype, act, *tables, *got)
        path = ("wide" if isinstance(lay, WideLayout) else
                "group" if isinstance(lay, GeneralLayout) else None)
        assert path == _want_path(name, act, h, dt, aligned), (
            name, act.name, h, dt, aligned, lay)
        if path == "wide":
            assert lay == (WideLayout(16, 1) if h <= 512 else
                           WideLayout(8, -(-h // 256))), (name, h, lay)
        lays[name] = lay
    return lays


@pytest.mark.cuda
@pytest.mark.parametrize("h,dt,aligned", [
    (96, "bf16", True), (96, "f32", False), (24, "bf16", True),
    (20, "bf16", True), (128, "f32", True), (300, "bf16", True),
    (300, "f32", False), (512, "bf16", True), (512, "f32", True),
    (520, "bf16", True), (700, "f32", False)])
def test_general_new_forms_match_plain_on_card(cuda_device, h, dt, aligned):
    """The three edge forms for centered_relu, softmax, erf-GELU and tanh
    declared non-elementwise and leaky_relu; erf-GELU (declared
    non-elementwise, and elementwise for #5) on #1r, #3, #6, #4r and #5;
    and past H = 256 all five with the row-wise sigma (the row in
    registers up to 512, passes over it past 512): each against its plain
    version on the awkward plans, one launch each, on the path its entry
    names (``ell_general_layout``)."""
    c = awkward_case(h, dt, aligned, cuda_device)
    edge_acts = list(ACTS.values()) + [tell.leaky_relu(SLOPE)]
    for act in edge_acts:
        _run_and_compare(edge_runs(c, act), act, h, dt, aligned)
    gen_acts = [ACTS["gelu"], tell.gelu()]
    if h > 256:
        gen_acts += [ACTS["centered_relu"], ACTS["softmax"]]
    for act in gen_acts:
        runs = general_runs(c, act)
        if act.elementwise:  # only #5 takes an elementwise route's sigma
            runs = {"ell_src_bwd_fused": runs["ell_src_bwd_fused"]}
        _run_and_compare(runs, act, h, dt, aligned)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["centered_relu", "softmax"])
@pytest.mark.parametrize("h,dt", [(264, "bf16"), (264, "f32"), (384, "bf16"),
                                  (384, "f32"), (512, "bf16"), (512, "f32"),
                                  (300, "f32")])
def test_full_warp_edge_forms_match_plain_on_card(cuda_device, h, dt, act):
    """#1r·e and #4r·e past H = 256 on whole 16-byte chunks against their
    plain versions on the awkward plans (a part-full last run of rows,
    zero-scale slots and a multi-slot row all zero, budgets off multiples
    of 8, rows longer than 32 slots; #4r·e's g_e at one bf16 step in
    bf16), one launch each, on lane groups of the whole warp: an edge
    form's lane holds at most 16 values, so past 256 one slot a warp."""
    c = awkward_case(h, dt, True, cuda_device)
    runs = {k: v for k, v in edge_runs(c, ACTS[act]).items()
            if k in FULL_WARP and k != "ell_geq_reduce_edge"}
    lays = _run_and_compare(runs, ACTS[act], h, dt, True)
    chunks = h * c.tdt.itemsize // 16
    assert set(lays) == {"ell_act_reduce_rowwise_edge",
                         "ell_src_bwd_rowwise_edge"}
    for name, lay in lays.items():
        assert lay == GeneralLayout(chunks, 32, 1, -(-chunks // 32), 1), (
            name, h, dt, lay)


@pytest.mark.cuda
@pytest.mark.parametrize("h,dt", [(96, "bf16"), (96, "f32"), (512, "bf16"),
                                  (512, "f32"), (300, "f32"), (520, "bf16")])
@pytest.mark.parametrize("act", ["centered_relu", "softmax", "gelu"])
def test_general_new_forms_are_bitwise_repeatable_on_card(cuda_device, h, dt,
                                                          act):
    """Two launches of each edge form (g_e included), and past H = 256 of
    each of the five kernels, give the same bits: each sum's order is fixed
    by the layout, and each g_e row has one writer. A graph of 4,000 nodes
    and 40,000 edges fills many blocks."""
    rng = np.random.default_rng(7)
    n, e, d = 4000, 40000, cuda_device
    fg = tell.build_fast_graph(
        build_graph(rng.integers(0, n, e), rng.integers(0, n, e), n,
                    device=d), max_budget=64)
    tdt = DTYPES[dt]
    x = lambda rows: _t(rng.normal(size=(rows, h)), device=d)
    eq, ek, g, et = x(fg.n_pad), x(fg.n_pad), x(fg.n_pad), x(fg.e_pad)
    c = SimpleNamespace(fg=fg, sd=fg.dst_slot_scales["sym"],
                        ss=fg.src_slot_scales["sym"], eqd=eq, gd=g, ekf=ek,
                        ekt=ek.to(tdt), eqt=eq.to(tdt), gt=g.to(tdt),
                        et=et.to(tdt), tdt=tdt, aligned=True)
    tact = ACTS[act]
    runs = dict(edge_runs(c, tact))
    if h > 256 or act == "gelu":
        runs.update(general_runs(c, tact))
    for name, (kernel, _, _, _) in runs.items():
        first, second = kernel(), kernel()
        torch.cuda.synchronize()
        first = first if isinstance(first, tuple) else (first,)
        second = second if isinstance(second, tuple) else (second,)
        for a, b in zip(first, second):
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["centered_relu", "softmax"])
@pytest.mark.parametrize("h,dt", [(264, "f32"), (384, "bf16"), (384, "f32"),
                                  (512, "bf16"), (512, "f32"), (520, "bf16"),
                                  (520, "f32")])
def test_full_warp_geq_edge_matches_plain_on_card(cuda_device, h, dt, act):
    """#3·e past H = 256 on the awkward plans (a part-full last run of
    rows, zero-scale slots and a multi-slot row with no valid slot, budgets
    off multiples of 8, rows longer than 32 slots) against its plain
    version at BWD_TOL, the rows holding a centered_relu near gate left out
    (at z = eq[key] + add_cast(ek[src], e[edge]), two orders of the mean's
    sum may set such a gate apart); two launches give the same bits; on
    lane groups of the whole warp up to 512 (one slot a warp), the wide
    path's passes at 520."""
    c = awkward_case(h, dt, True, cuda_device)
    tact, plan = ACTS[act], c.fg.dst_plan
    kernel, plain, _, tables = edge_runs(c, tact)["ell_geq_reduce_edge"]
    reset_launch_counts()
    first, second = kernel(), kernel()
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {
        "ell_geq_reduce_edge": 2}
    assert torch.equal(first, second)
    keep = torch.ones(plan.num_rows, dtype=torch.bool, device=first.device)
    if act == "centered_relu":
        kv = tkernels.add_cast(c.ekt.index_select(0, c.fg.dst_slot_srcnode),
                               c.et.index_select(0, plan.slot_edge))
        z = c.eqd.index_select(0, plan.slot_key) + kv.float()
        keep = ~slot_rows(plan, near_gate(z, c.sd, tact).any(1))
    torch.testing.assert_close(first[keep], plain()[keep], **BWD_TOL)
    lay = ell_general_layout("ell_geq_reduce_edge", h, c.tdt, tact,
                             *tables, first)
    chunks = h * c.tdt.itemsize // 16
    want = (GeneralLayout(chunks, 32, 1, -(-chunks // 32), 1) if h <= 512
            else WideLayout(8, -(-h // 256)))
    assert lay == want, (h, dt, lay)
