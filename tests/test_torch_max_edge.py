"""The max aggregation with an edge term, against the JAX package's.

* the plain versions of the edge forms ``ell_max_fwd_edge`` (#9e),
  ``ell_max_wincount_edge`` (#10e) and ``ell_max_bwd_edge`` (#11e) against
  the Pallas kernels ``bucket_max_gemm_fwd``, ``bucket_max_wincount`` and
  ``bucket_max_gemm_bwd`` in interpret mode, bucket by bucket, on the JAX
  route's ``with_edge`` inputs (``slot_inputs``: ek and e cast to the edge
  dtype and added in it): zero-scale slots, a row with no valid slot,
  budgets that are not multiples of 8, the hub stage 2, exact ties (the
  duplicated edges carry equal edge rows), O != H, the partial last row
  tile of every bucket (JAX masks it with ``where``), H = 24 to 300, f32
  and bf16, elementwise sigmas and the row-wise centered_relu (both forms
  at once);
* ``sir_aggregate(..., "max", e=...)`` under a DropEdge mask: out and the
  gradients of eq, ek, e, W and b against
  ``make_ell_sir_aggregate_max_pallas(with_edge=True, interpret=True)``;
  with centered_relu (edge term and row-wise sigma together) against the
  JAX package's XLA builder ``make_ell_sir_aggregate_max`` at H = 24 and
  against the Pallas builder at H = 128 (JAX's Pallas builder pads H to a
  multiple of 128 before sigma, exact only for an elementwise sigma; the
  port takes a row-wise statistic over the H features, as the XLA builder
  does);
* ``SIREConv(agg_type="max")`` on a FastGraph against the JAX
  ``SIREConv`` through the weight bridge, leaky_relu and centered_relu:
  out, every gradient, one AdamW step;
* which kernels the edge form reaches.

Tolerances are the JAX suite's: forward atol 2e-4 / rtol 1e-4, gradients
atol 3e-4 / rtol 1e-3; a per-slot g_z stored in bf16 at one bf16 step
(rtol 2^-7), and with it the gradients of ek and e that sum and copy it
(two f32 values that agree to 1e-6 can round to neighbouring bf16
values); win counts exactly, each side against its own forward's maxima.

The ``cuda`` tests hold each edge form against its plain version on the
card (rows longer than a tile, W beyond shared memory, H and O off
multiples of 8, a row-wise sigma; near-tie keys, where the two may pick
other winners, and centered_relu's near gates left out, as chip_smoke.py
leaves them), each slot's m to the same bits in any tiling, #10e's
counts to cover every key's max, and two launches of #11e to the same
bits; they skip where there is no card (``pytest -m cuda
--noconftest tests/test_torch_max_edge.py``). JAX is imported inside the
tests that use it.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sir_gcn_tpu_torch.ops.ell as tell
import sir_gcn_tpu_torch.ops.message_passing as tmp
from sir_gcn_tpu_torch import build_graph
from sir_gcn_tpu_torch.ops.cuda import (
    LAUNCHES,
    ell_max_bwd_edge,
    ell_max_fwd_edge,
    ell_max_wincount_edge,
    ell_scaled_reduce,
    reset_launch_counts,
)
from sir_gcn_tpu_torch.ops.cuda import kernels as tk

try:
    from test_torch_max import graph_edges
except ImportError:  # imported as a package module
    from tests.test_torch_max import graph_edges

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
BF16_STEP = dict(atol=3e-4, rtol=2.0 ** -7)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
ALPHA, SLOPE = 0.5, 0.2
ACTS = {"leaky_relu": tell.leaky_relu(SLOPE), "tanh": tell.tanh,
        "gelu": tell.gelu(), "centered_relu": tell.centered_relu(ALPHA),
        "softmax": tell.softmax}


def jax_act(name: str):
    import jax
    import jax.numpy as jnp

    return {"leaky_relu": lambda z: jax.nn.leaky_relu(z, SLOPE),
            "tanh": jnp.tanh,
            "gelu": lambda z: jax.nn.gelu(z, approximate=False),
            "centered_relu": lambda z: jax.nn.relu(
                z - ALPHA * z.mean(-1, keepdims=True)),
            "softmax": lambda z: jax.nn.softmax(z, axis=-1)}[name]


def jax_dtype(dt: str):
    import jax.numpy as jnp

    return {"f32": None, "bf16": jnp.bfloat16}[dt]


def edge_table(fg, h: int, rng) -> np.ndarray:
    """e [E_pad, H] in sorted edge order, one row per (src, dst) pair, so
    that duplicated edges keep their exact ties."""
    src, dst = fg.graph.host["src"], fg.graph.host["dst"]
    pairs = rng.normal(size=(64 * 64, h)).astype(np.float32)
    return pairs[(src % 64) * 64 + dst % 64]


def make_case(graph: str, h: int, o: int, seed: int = 0, device="cpu",
              with_jax: bool = False):
    """A FastGraph (and JAX's), node tables eq/ek [N, H], an edge table e,
    W [H, O], b [O], a cotangent [N, O], a DropEdge mask, and dst scales
    with a fifth of the slots and one whole row invalid."""
    rng = np.random.default_rng(seed)
    src, dst, n, mb = graph_edges(graph, rng)
    fg = tell.build_fast_graph(build_graph(src, dst, n, device=device),
                               max_budget=mb)
    jfg = None
    if with_jax:
        import sir_gcn_tpu.ops.ell as jell
        from sir_gcn_tpu import build_graph as j_build_graph

        jfg = jell.build_fast_graph(j_build_graph(src, dst, n),
                                    max_budget=mb)
    eq, ek = (rng.normal(size=(fg.n_pad, h)).astype(np.float32)
              for _ in range(2))
    e = edge_table(fg, h, rng)
    w = (rng.normal(size=(h, o)) / np.sqrt(h)).astype(np.float32)
    b = rng.normal(size=o).astype(np.float32)
    g = rng.normal(size=(fg.n_pad, o)).astype(np.float32)
    s = fg.dst_slot_scales["sum"].cpu().numpy()
    if graph != "ties":
        s = s * (rng.random(s.shape) > 0.2)
        ptr = fg.dst_plan.host["row_ptr"]
        r = int(np.argmax(np.diff(ptr) > 1))  # a row of two or more slots
        s[ptr[r]:ptr[r + 1]] = 0.0
    return SimpleNamespace(fg=fg, jfg=jfg, eq=eq, ek=ek, e=e, w=w, b=b, g=g,
                           scale=s.astype(np.float32),
                           mask=rng.random(fg.e_pad) >= 0.25)


def _t(x, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(np.asarray(x)).to(device=device, dtype=dtype)


def near_gate_keep(fg, args, act, edge=()):
    """(rows, slots) bool of the dst plan to compare a centered_relu
    backward at: those without a valid slot whose gate lies within
    chip_smoke.py's NEAR_GATE of 0 at some feature (the plain version's
    z), where the kernel's mean, summed in another order, may put the relu
    on the other side; (None, None) for any other sigma."""
    from chip_smoke import near_gates

    if act.name != "centered_relu":
        return None, None
    eq, ek, slot_src, scale = args[:4]
    k = ek.index_select(0, slot_src)
    if edge:
        k = tk.add_cast(k, edge[0].index_select(0, edge[1]))
    z = k.float() + eq.index_select(0, fg.dst_plan.slot_key)
    slots, rows, _ = near_gates(fg.dst_plan, z, scale, act)
    return ~rows, ~slots


def near_ties(fg, args, act, edge=()) -> torch.Tensor:
    """[N, O] bool: chip_smoke.py's near-tie (key, o), whose two largest
    valid slot products lie within its NEAR_TIE, where the card may take
    another winner."""
    from chip_smoke import near_ties as smoke_near_ties

    return smoke_near_ties(fg, args, act, edge[0] if edge else None)[0]


def assert_counts_equal(counts, counts_p, fg, near):
    """#10's counts against the plain version's, exactly, but at the rows
    of near-tie keys."""
    keep = ~near.index_select(0, fg.dst_plan.row_key)
    assert torch.equal(torch.where(keep, counts, 0.0),
                       torch.where(keep, counts_p, 0.0))


def assert_bwd_close(got, want, dt, keep=(None, None)):
    """#11's (geq_rows, g_z, g_W) against the plain version's, the rows
    and slots of ``keep`` only (where given); a bf16 g_z at one step."""
    (geq, gz, gw), (geq_p, gz_p, gw_p) = got, want
    kr, ks = keep
    if kr is not None:
        geq, geq_p, gz, gz_p = geq[kr], geq_p[kr], gz[ks], gz_p[ks]
    torch.testing.assert_close(geq, geq_p, **BWD_TOL)
    torch.testing.assert_close(gz.float(), gz_p.float(),
                               **(BF16_STEP if dt == "bf16" else BWD_TOL))
    torch.testing.assert_close(gw, gw_p, **BWD_TOL)


def _args(c, tdt, device="cpu"):
    """The edge forms' arguments but sigma: eq, ek, slot arrays, W, and
    (after sigma) e and slot_edge."""
    plan = c.fg.dst_plan
    return ((_t(c.eq, device=device), _t(c.ek, tdt, device),
             c.fg.dst_slot_srcnode, _t(c.scale, device=device), plan.row_key,
             plan.row_ptr, _t(c.w, device=device)),
            (_t(c.e, tdt, device), plan.slot_edge))


# ----------------------------------------------------------------------
# The plain edge forms against the Pallas kernels
# ----------------------------------------------------------------------

def _pallas_rows(c, act: str, dt: str, edge: bool = True):
    """The Pallas max kernels bucket by bucket on the port's plan and the
    JAX route's slot inputs (with ``edge`` its with_edge ones), each
    against the JAX side's own key-level max."""
    import jax.numpy as jnp
    from sir_gcn_tpu.ops import pallas
    from sir_gcn_tpu.ops.ell import _bucket_offsets
    from sir_gcn_tpu.ops.pallas.kernels import _SLOT_TILE_MAX, _tile_rows

    jdt, jact = jax_dtype(dt), jax_act(act)
    cast = (lambda x: x) if jdt is None else (lambda x: x.astype(jdt))
    plan = c.fg.dst_plan
    ekg = jnp.take(cast(jnp.asarray(c.ek)),
                   jnp.asarray(c.fg.dst_slot_srcnode.numpy()), axis=0)
    if edge:  # slot_inputs(with_edge=True)
        eg = jnp.take(cast(jnp.asarray(c.e)),
                      jnp.asarray(plan.slot_edge.numpy()), axis=0)
        ekg = ekg + eg.astype(ekg.dtype)
    rk = jnp.asarray(plan.row_key.numpy())
    eq_rows = jnp.take(jnp.asarray(c.eq), rk, axis=0)
    w = jnp.asarray(c.w)
    offs = _bucket_offsets(plan.buckets1)
    # every bucket ends in a partial row tile, which JAX masks
    assert all(nr % _tile_rows(b, _SLOT_TILE_MAX) for b, nr, _, _ in offs)

    def blocks(so, b, nr):
        return (ekg[so:so + b * nr],
                jnp.asarray(c.scale[so:so + b * nr]).reshape(nr, b))

    rows = np.concatenate([np.asarray(pallas.bucket_max_gemm_fwd(
        blocks(so, b, nr)[0], eq_rows[ro:ro + nr], blocks(so, b, nr)[1], w,
        b, jact, interpret=True)) for b, nr, so, ro in offs])
    key_max = plan.finalize_rows_max(torch.from_numpy(rows))
    or_rows = jnp.take(jnp.asarray(key_max.numpy()), rk, axis=0)
    gsc_rows = jnp.take(jnp.asarray(c.g), rk, axis=0)
    counts, geq, gz, gw = [], [], [], 0.0
    for b, nr, so, ro in offs:
        ekb, scb = blocks(so, b, nr)
        counts.append(np.asarray(pallas.bucket_max_wincount(
            ekb, eq_rows[ro:ro + nr], scb, or_rows[ro:ro + nr], w, b, jact,
            interpret=True)))
        ge, gzb, gwb = pallas.bucket_max_gemm_bwd(
            ekb, eq_rows[ro:ro + nr], scb, or_rows[ro:ro + nr],
            gsc_rows[ro:ro + nr], w, b, jact, interpret=True,
            gz_dtype=jdt or jnp.float32)
        geq.append(np.asarray(ge))
        gz.append(np.asarray(gzb.astype(jnp.float32)))
        gw = gw + np.asarray(gwb)
    return (rows, key_max, np.concatenate(counts), np.concatenate(geq),
            np.concatenate(gz), gw)


@pytest.mark.parametrize("graph,h,o,act,dt", [
    ("random", 24, 40, "leaky_relu", "f32"),
    ("random", 24, 40, "tanh", "bf16"),
    ("hub", 16, 16, "gelu", "bf16"),
    ("hub", 16, 16, "leaky_relu", "f32"),
    ("ties", 32, 24, "leaky_relu", "bf16"),
    ("ties", 32, 24, "gelu", "f32"),
    ("isolated", 300, 24, "tanh", "f32"),
    ("random", 24, 40, "centered_relu", "bf16"),
    ("hub", 16, 16, "centered_relu", "f32"),
    ("ties", 32, 24, "softmax", "bf16"),
])
def test_max_edge_plains_match_pallas(graph, h, o, act, dt):
    c = make_case(graph, h, o)
    tact, tdt = ACTS[act], DTYPES[dt]
    args, edge = _args(c, tdt)
    rows_j, key_max_j, counts_j, geq_j, gz_j, gw_j = _pallas_rows(c, act, dt)

    got = ell_max_fwd_edge(*args, tact, *edge)
    np.testing.assert_allclose(got.numpy(), rows_j, **FWD_TOL)
    if graph != "ties":
        assert (got.numpy() == np.finfo(np.float32).min).any()  # empty row
    key_max = c.fg.dst_plan.finalize_rows_max(got)
    np.testing.assert_allclose(key_max.numpy(), key_max_j.numpy(), **FWD_TOL)

    counts = ell_max_wincount_edge(*args, key_max, tact, *edge)
    np.testing.assert_array_equal(counts.numpy(), counts_j)
    if graph == "ties":
        assert counts.max() >= 2

    geq, gz, gw = ell_max_bwd_edge(*args, key_max, _t(c.g), tact, *edge)
    assert gz.dtype == tdt
    np.testing.assert_allclose(geq.numpy(), geq_j, **BWD_TOL)
    np.testing.assert_allclose(gz.float().numpy(), gz_j,
                               **(BF16_STEP if dt == "bf16" else BWD_TOL))
    np.testing.assert_allclose(gw.numpy(), gw_j, **BWD_TOL)


def test_edge_form_with_a_zero_edge_table_is_the_plain_form():
    """With e = 0 the edge forms compute what the forms without an edge
    term do, bit for bit (the add in the edge dtype is exact)."""
    c = make_case("hub", 16, 24, seed=3)
    act = ACTS["gelu"]
    for tdt in DTYPES.values():
        args, (e, slot_edge) = _args(c, tdt)
        zero = torch.zeros_like(e)
        key_max = c.fg.dst_plan.finalize_rows_max(
            tk.ell_max_fwd(*args, act))
        for a, b in zip(
                (tk.ell_max_fwd(*args, act),
                 tk.ell_max_wincount(*args, key_max, act),
                 *tk.ell_max_bwd(*args, key_max, _t(c.g), act)),
                (ell_max_fwd_edge(*args, act, zero, slot_edge),
                 ell_max_wincount_edge(*args, key_max, act, zero, slot_edge),
                 *ell_max_bwd_edge(*args, key_max, _t(c.g), act, zero,
                                   slot_edge))):
            assert torch.equal(a, b)


# ----------------------------------------------------------------------
# The aggregate and its gradients
# ----------------------------------------------------------------------

def _port(c, act, dt, mask):
    tmp.set_edge_dtype(DTYPES[dt] if dt == "bf16" else None)
    try:
        ts = [_t(a).requires_grad_() for a in (c.eq, c.ek, c.e, c.w, c.b)]
        out = tmp.sir_aggregate(
            c.fg, ts[0], ts[1], ACTS[act], "max", e=ts[2], w_relation=ts[3],
            b_relation=ts[4],
            edge_mask=None if mask is None else torch.from_numpy(mask))
        (out * _t(c.g)).sum().backward()
    finally:
        tmp.set_edge_dtype(None)
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def _jax(c, f, mask):
    import jax
    import jax.numpy as jnp

    valid = np.asarray(c.jfg.edge_mask)
    if mask is not None:
        valid = valid & mask
    v = jnp.asarray(valid, jnp.float32)
    args = [jnp.asarray(a) for a in (c.eq, c.ek, c.e, c.w, c.b)]

    def loss(eq, ek, e, w, b):
        return jnp.sum(f(eq, ek, e, v, w, b) * jnp.asarray(c.g))

    out = f(args[0], args[1], args[2], v, args[3], args[4])
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("graph,h,o,act,dt,dropedge,oracle", [
    ("random", 24, 40, "leaky_relu", "f32", True, "pallas"),
    ("random", 24, 40, "leaky_relu", "f32", False, "xla"),
    ("hub", 16, 16, "tanh", "bf16", True, "pallas"),
    ("isolated", 24, 8, "gelu", "f32", True, "pallas"),
    ("ties", 32, 24, "leaky_relu", "f32", False, "pallas"),
    # the two forms together: an edge term and a row-wise sigma
    ("random", 24, 40, "centered_relu", "f32", True, "xla"),
    ("hub", 24, 16, "softmax", "f32", False, "xla"),
    ("random", 128, 24, "centered_relu", "bf16", True, "pallas"),
])
def test_max_edge_aggregate_matches_jax(graph, h, o, act, dt, dropedge,
                                        oracle):
    import sir_gcn_tpu.ops.ell as jell

    c = make_case(graph, h, o, seed=7, with_jax=True)
    mask = c.mask if dropedge else None
    got = _port(c, act, dt, mask)
    if oracle == "pallas":
        f = jell.make_ell_sir_aggregate_max_pallas(
            c.jfg, jax_act(act), with_edge=True, interpret=True,
            edge_dtype=jax_dtype(dt))
    else:  # the XLA builder computes in f32
        assert dt == "f32"
        f = jell.make_ell_sir_aggregate_max(c.jfg, jax_act(act),
                                            with_edge=True)
    want = _jax(c, f, mask)
    for name, a, b in zip(("out", "eq", "ek", "e", "w", "b"), got, want):
        tol = FWD_TOL if name == "out" else BWD_TOL
        if dt == "bf16" and name in ("ek", "e"):
            tol = BF16_STEP  # sums and copies of the bf16 g_z
        np.testing.assert_allclose(a, b, **tol, err_msg=name)
    if graph == "isolated":  # nodes without an in-edge are zero-filled
        assert (got[0][40:] == 0).all()
    if dropedge:  # a dropped edge gets no cotangent
        dropped = ~c.mask & c.fg.edge_mask.numpy()
        assert dropped.any() and (got[3][dropped] == 0).all()


@pytest.fixture
def kernel_calls(monkeypatch):
    calls = []
    for name in ("ell_max_fwd_plain", "ell_max_wincount_plain",
                 "ell_max_bwd_plain", "ell_scaled_reduce_plain"):
        fn = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n[:-6] + ("_edge" if k.get("e") is not None
                                    else "")), _f(*a, **k))[1])
    return calls


def test_max_edge_route_reaches_its_kernels(kernel_calls):
    c = make_case("random", 24, 40)
    e = _t(c.e)
    for act in (ACTS["leaky_relu"], ACTS["centered_relu"]):
        kernel_calls.clear()
        with torch.no_grad():
            tmp.sir_aggregate(c.fg, _t(c.eq), _t(c.ek), act, "max", e=e,
                              w_relation=_t(c.w))
        assert kernel_calls == ["ell_max_fwd_edge"]
        kernel_calls.clear()
        reset_launch_counts()
        ts = [_t(a).requires_grad_() for a in (c.eq, c.ek, c.e, c.w)]
        tmp.sir_aggregate(c.fg, ts[0], ts[1], act, "max", e=ts[2],
                          w_relation=ts[3]).sum().backward()
        assert kernel_calls == ["ell_max_fwd_edge", "ell_max_wincount_edge",
                                "ell_max_bwd_edge", "ell_scaled_reduce"]
        assert all(v == 0 for v in LAUNCHES.values())  # CPU: no launch
        assert all(t.grad is not None for t in ts)


def test_max_edge_wrappers_check_their_edge_inputs():
    c = make_case("random", 24, 40)
    args, (e, slot_edge) = _args(c, torch.float32)
    act = ACTS["tanh"]
    with pytest.raises(ValueError, match="width"):
        ell_max_fwd_edge(*args, act, e[:, :8].contiguous(), slot_edge)
    with pytest.raises(TypeError, match="dtype"):
        ell_max_fwd_edge(*args, act, e.to(torch.bfloat16), slot_edge)
    with pytest.raises(ValueError, match="slot_edge"):
        ell_max_fwd_edge(*args, act, e, slot_edge[:-1].contiguous())


# ----------------------------------------------------------------------
# SIREConv with max on a FastGraph
# ----------------------------------------------------------------------

def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items")
                   else {prefix + (k,): np.asarray(v)})
    return out


@pytest.mark.parametrize("act", ["leaky_relu", "centered_relu"])
def test_sireconv_max_matches_jax(act):
    """``SIREConv(agg_type="max")`` against the JAX ``SIREConv`` (its CPU
    route, the XLA max builder with the edge term): out, the input's
    gradient and every parameter's, then one AdamW step."""
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.models.conv import SIREConv as JSIREConv
    from sir_gcn_tpu.train import make_adamw as j_make_adamw

    from sir_gcn_tpu_torch.models import SIREConv
    from sir_gcn_tpu_torch.train import make_adamw
    from sir_gcn_tpu_torch.utils import load_jax_variables
    from sir_gcn_tpu_torch.utils.convert import _slots

    de, h, o, lr, wd = 5, 16, 12, 1e-2, 1e-3
    c = make_case("hub", h, o, seed=12, with_jax=True)
    rng = np.random.default_rng(13)
    x = rng.normal(size=(c.fg.n_pad, 10)).astype(np.float32)
    ef = rng.normal(size=(c.fg.graph.num_edges, de)).astype(np.float32)
    w = rng.normal(size=(c.fg.n_pad, o)).astype(np.float32)
    jconv = JSIREConv(hidden_dim=h, output_dim=o, activation=jax_act(act),
                      agg_type="max")
    variables = jax.tree_util.tree_map(np.asarray, jconv.init(
        jax.random.PRNGKey(3), c.jfg, jnp.asarray(x), jnp.asarray(ef)))
    conv = SIREConv(10, de, h, o, ACTS[act], agg_type="max")
    load_jax_variables(conv, variables)
    slots = _slots(conv)
    assert ("params", "relation_kernel") in slots

    tx = _t(x).requires_grad_()
    out = conv(c.fg, tx, _t(ef))
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

    # one AdamW step; Adam's first step is about lr * sign(g), so entries
    # with |g| < 1e-6 are left out
    make_adamw(conv.parameters(), lr, wd).step()
    tx_j = j_make_adamw(lr, wd)
    updates, _ = tx_j.update(gp, tx_j.init(variables), variables)
    new = _flat(jax.tree_util.tree_map(lambda p, u: p + u, variables,
                                       updates))
    for key, p in new.items():
        tensor, transpose = slots[key]
        have = tensor.detach().numpy()
        have = have.T if transpose else have
        keep = np.abs(grads[key]) >= 1e-6
        np.testing.assert_allclose(have[keep], p[keep], **FWD_TOL,
                                   err_msg="/".join(key))


# ----------------------------------------------------------------------
# On the card: each edge form against its plain version
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (200, 200) and (512, 512) take the wide path
CARD_CASES = [("hub", 24, 40), ("random", 96, 96), ("random", 200, 200),
              ("ties", 32, 24), ("random", 36, 100), ("hub256", 24, 40),
              ("random", 512, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", ["leaky_relu", "gelu", "centered_relu"])
@pytest.mark.parametrize("graph,h,o", CARD_CASES)
def test_max_edge_kernels_match_plain_on_card(cuda_device, graph, h, o, act,
                                              dt):
    """Every shape on the tensor-core path: H and O off multiples of 8
    (36 x 100), rows longer than a 16-slot tile (hub: budget 64; hub256:
    chunk rows of 256), W too large for one block's shared memory (200 x
    200), exact ties; an elementwise and a row-wise sigma."""
    c = make_case(graph, h, o, device=cuda_device)
    d, tact = cuda_device, ACTS[act]
    args, edge = _args(c, DTYPES[dt], d)
    plan, splan = c.fg.dst_plan, c.fg.src_plan
    # no cotangent at near-tie keys, where the two may pick other winners
    near = near_ties(c.fg, args, tact, edge)
    gsc = torch.where(near, 0.0, _t(c.g, device=d))
    reset_launch_counts()
    rows = ell_max_fwd_edge(*args, tact, *edge)
    key_max = plan.finalize_rows_max(rows)
    counts = ell_max_wincount_edge(*args, key_max, tact, *edge)
    geq, gz, gw = ell_max_bwd_edge(*args, key_max, gsc, tact, *edge)
    red = ell_scaled_reduce(gz, c.fg.src_slot_from_dst_slot,
                            splan.slot_valid, splan.row_ptr)
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {
        "ell_max_fwd_edge": 1, "ell_max_wincount_edge": 1,
        "ell_max_bwd_edge": 1, "ell_scaled_reduce": 1}

    # each side against its own forward's maxima
    kw = dict(e=edge[0], slot_edge=edge[1])
    rows_p = tk.ell_max_fwd_plain(*args, tact, **kw)
    key_max_p = plan.finalize_rows_max(rows_p)
    torch.testing.assert_close(rows, rows_p, **FWD_TOL)
    assert_counts_equal(
        counts, tk.ell_max_wincount_plain(*args, key_max_p, tact, **kw),
        c.fg, near)
    assert_bwd_close((geq, gz, gw),
                     tk.ell_max_bwd_plain(*args, key_max_p, gsc, tact, **kw),
                     dt, near_gate_keep(c.fg, args, tact, edge))
    if graph == "ties":
        assert counts.max() >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", ["leaky_relu", "centered_relu"])
@pytest.mark.parametrize("graph,h,o", [("random", 96, 96),
                                       ("hub256", 24, 40),
                                       ("random", 36, 100)])
def test_max_edge_products_have_the_same_bits_in_any_tiling(
        cuda_device, graph, h, o, act, dt):
    """A slot's m is rounded alike in the full plan's tiles and alone in a
    plan of one-slot rows: the row maxima and the win counts of the full
    plan are those of the one-slot products, bit for bit."""
    c = make_case(graph, h, o, device=cuda_device)
    tact = ACTS[act]
    args, (e, slot_edge) = _args(c, DTYPES[dt], cuda_device)
    eq, ek, slot_src, scale, row_key, row_ptr, w = args
    plan = c.fg.dst_plan
    rows = ell_max_fwd_edge(*args, tact, e, slot_edge)
    key_max = plan.finalize_rows_max(rows)
    counts = ell_max_wincount_edge(*args, key_max, tact, e, slot_edge)
    vs = (scale > 0).nonzero().flatten()
    row = torch.searchsorted(row_ptr[1:].long(), vs, right=True)
    one = ell_max_fwd_edge(
        eq, ek, slot_src[vs].contiguous(),
        torch.ones(vs.numel(), device=cuda_device),
        row_key[row].contiguous(),
        torch.arange(vs.numel() + 1, dtype=torch.int32, device=cuda_device),
        w, tact, e, slot_edge[vs].contiguous())
    want = torch.full_like(rows, float(np.finfo(np.float32).min))
    want.scatter_reduce_(0, row[:, None].expand(-1, o), one, "amax")
    assert torch.equal(rows, want)
    wins = (one == key_max.index_select(0, row_key)[row]).float()
    assert torch.equal(counts, torch.zeros_like(counts).index_add_(0, row,
                                                                   wins))


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["tanh", "softmax"])
@pytest.mark.parametrize("graph,h,o", [("random", 96, 96), ("hub", 24, 40),
                                       ("random", 200, 200)])
def test_max_edge_win_counts_cover_every_key_max_on_card(cuda_device, graph,
                                                         h, o, act):
    """Summed over a key's rows, #10e counts at least one winner at every
    (key, o) of a key with a valid slot: #9e and #10e agree bit for bit."""
    c = make_case(graph, h, o, device=cuda_device)
    tact = ACTS[act]
    args, edge = _args(c, torch.bfloat16, cuda_device)
    plan = c.fg.dst_plan
    key_max = plan.finalize_rows_max(ell_max_fwd_edge(*args, tact, *edge))
    counts = plan.finalize_rows_sum(
        ell_max_wincount_edge(*args, key_max, tact, *edge))
    ptr = plan.row_ptr.long()
    slot_row = torch.repeat_interleave(
        torch.arange(ptr.numel() - 1, device=cuda_device), ptr.diff())
    nvalid = torch.zeros(ptr.numel() - 1, device=cuda_device).index_add_(
        0, slot_row, (args[3] > 0).float())
    has = plan.finalize_rows_sum(nvalid[:, None])[:, 0] > 0
    assert has.any()
    assert (counts[has] >= 1).all()
    assert (counts[~has] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["leaky_relu", "centered_relu"])
@pytest.mark.parametrize("graph,h,o", [("random", 96, 96),
                                       ("random", 200, 200),
                                       ("hub256", 24, 40)])
def test_max_edge_bwd_is_bitwise_repeatable_on_card(cuda_device, graph, h, o,
                                                    act):
    """Two launches of #11e on the same inputs give the same bits."""
    c = make_case(graph, h, o, device=cuda_device)
    tact = ACTS[act]
    args, edge = _args(c, torch.bfloat16, cuda_device)
    key_max = c.fg.dst_plan.finalize_rows_max(
        ell_max_fwd_edge(*args, tact, *edge))
    gsc = _t(c.g, device=cuda_device)
    first = ell_max_bwd_edge(*args, key_max, gsc, tact, *edge)
    second = ell_max_bwd_edge(*args, key_max, gsc, tact, *edge)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
