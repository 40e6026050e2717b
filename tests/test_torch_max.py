"""The port's max aggregation against the JAX package's.

* the plain versions of the four max kernels (``ell_max_fwd``,
  ``ell_max_wincount``, ``ell_max_bwd``, ``ell_scaled_reduce``) against
  the Pallas kernels run in interpret mode bucket by bucket, on the same
  plan: zero-scale slots, a row with no valid slot, budgets that are not
  multiples of 8, the hub stage 2, exact ties, bf16 ek, O != H;
* the plan's src-slot -> dst-slot map and the max finalize, array-equal
  to JAX's;
* ``sir_aggregate(..., "max")`` with its gradients for eq, ek, W and b,
  against ``make_ell_sir_aggregate_max_pallas(interpret=True)`` and the
  XLA builder ``make_ell_sir_aggregate_max``, tie splitting included;
* ``SIRConv(agg_type="max")`` and the arxiv ``SIRModel`` with max through
  the weight bridge, one AdamW step included, and the trainer on the CPU.

Tolerances are the JAX suite's: forward atol 2e-4 / rtol 1e-4, gradients
atol 3e-4 / rtol 1e-3. Win counts are exact: each side's counts are taken
against its own forward's maxima, as the kernels are used. A per-slot g_z
stored in bf16 is held to one bf16 step (rtol 2^-7) besides, since two
f32 values that agree to 1e-6 can round to neighbouring bf16 values.

The kernels compute every product as three TF32 tensor-core products
(hi and lo halves of each operand); ``split_products`` emulates that here
and is held within the forward tolerance of ``slot_products`` and a tenth
of chip_smoke.py's NEAR_TIE of the exact product.

The ``cuda`` tests compare each kernel with its plain version on the card
(any H, O; rows longer than a tile; W beyond shared memory, where the
kernels take their wide path: H = O = 200, 512 and 520, 512 x 200, 264 x
600), hold each slot's product to the same bits in any tiling and #10's
counts to cover every key's max (at 512 too), ask #11 for equal bits
twice, and skip where there is no card. JAX is imported inside the tests that use
it, so that the card's tests run where JAX is not installed
(``pytest -m cuda --noconftest tests/test_torch_max.py``).
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
    MaxLayout,
    ell_max_bwd,
    ell_max_bwd_plain,
    ell_max_fwd,
    ell_max_fwd_plain,
    ell_max_layout,
    ell_max_wincount,
    ell_max_wincount_plain,
    ell_scaled_reduce,
    ell_scaled_reduce_plain,
    reset_launch_counts,
)
from sir_gcn_tpu_torch.ops.cuda.kernels import (
    NEG,
    bucket_products,
    decode_max_layout,
    slot_products,
)

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
BF16_STEP = dict(atol=3e-4, rtol=2.0 ** -7)
# chip_smoke.py's window for (key, o) whose two largest products may round
# apart on the card
NEAR_TIE = 1e-5

ACTS = {"leaky_relu": tell.leaky_relu(0.2), "tanh": tell.tanh,
        "gelu": tell.gelu()}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def jax_side(act: str, dt: str):
    """The JAX package's Pallas kernels, sigma and edge dtype."""
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.ops import pallas

    jact = {"leaky_relu": lambda x: jax.nn.leaky_relu(x, 0.2),
            "tanh": jnp.tanh,
            "gelu": lambda x: jax.nn.gelu(x, approximate=False)}[act]
    return pallas, jact, {"f32": jnp.float32, "bf16": jnp.bfloat16}[dt]


def graph_edges(graph: str, rng):
    """(src, dst, n, max_budget) of the test graphs."""
    if graph == "hub":  # node 0 takes 300 in-edges: the hub stage 2
        n = 40
        return (rng.integers(0, n, 360),
                np.concatenate([np.zeros(300, np.int64),
                                rng.integers(0, n, 60)]), n, 64)
    if graph == "ties":  # duplicated edges: exact ties in m
        return (np.array([0, 0, 1, 2, 2, 2, 3] * 2),
                np.array([5, 5, 6, 7, 7, 7, 8] * 2), 16, 4)
    if graph == "isolated":  # nodes 30..59 have no edge: zero-filled
        return rng.integers(0, 30, 150), rng.integers(0, 30, 150), 60, 16
    if graph == "hub256":  # node 0 takes 600 in-edges: chunk rows of 256
        n = 40
        return (rng.integers(0, n, 700),
                np.concatenate([np.zeros(600, np.int64),
                                rng.integers(0, n, 100)]), n, 256)
    n = 40  # budgets 1..16, with 10, 12, 14
    return rng.integers(0, n, 203), rng.integers(0, n, 203), n, 16


def make_case(graph: str, h: int, o: int, seed: int = 0, device="cpu"):
    """A FastGraph, node tables eq/ek [N, H], W [H, O], a cotangent
    [N, O] and dst scales with a fifth of the slots and one whole row
    invalid."""
    rng = np.random.default_rng(seed)
    src, dst, n, mb = graph_edges(graph, rng)
    fg = tell.build_fast_graph(build_graph(src, dst, n, device=device),
                               max_budget=mb)
    eq, ek = (rng.normal(size=(fg.n_pad, h)).astype(np.float32)
              for _ in range(2))
    w = (rng.normal(size=(h, o)) / np.sqrt(h)).astype(np.float32)
    g = rng.normal(size=(fg.n_pad, o)).astype(np.float32)
    s = fg.dst_slot_scales["sum"].cpu().numpy()
    if graph != "ties":
        s = s * (rng.random(s.shape) > 0.2)
        ptr = fg.dst_plan.host["row_ptr"]
        r = int(np.argmax(np.diff(ptr) > 1))  # a row of two or more slots
        s[ptr[r]:ptr[r + 1]] = 0.0
    return SimpleNamespace(fg=fg, eq=eq, ek=ek, w=w, g=g,
                           scale=s.astype(np.float32))


def _t(x, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(np.asarray(x)).to(device=device, dtype=dtype)


def _port_args(c, tdt, device="cpu"):
    plan = c.fg.dst_plan
    return (_t(c.eq, device=device), _t(c.ek, tdt, device),
            c.fg.dst_slot_srcnode, _t(c.scale, device=device), plan.row_key,
            plan.row_ptr, _t(c.w, device=device))


def _pallas_rows(c, pallas, jact, jdt):
    """Pallas fwd, wincount and bwd bucket by bucket on the port's plan,
    each against the JAX side's own key-level max."""
    import jax.numpy as jnp
    from sir_gcn_tpu.ops.ell import _bucket_offsets

    plan = c.fg.dst_plan
    ekg = jnp.take(jnp.asarray(c.ek).astype(jdt),
                   jnp.asarray(c.fg.dst_slot_srcnode.numpy()), axis=0)
    rk = jnp.asarray(plan.row_key.numpy())
    eq_rows = jnp.take(jnp.asarray(c.eq), rk, axis=0)
    w = jnp.asarray(c.w)
    offs = _bucket_offsets(plan.buckets1)

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
            gsc_rows[ro:ro + nr], w, b, jact, interpret=True, gz_dtype=jdt)
        geq.append(np.asarray(ge))
        gz.append(np.asarray(gzb.astype(jnp.float32)))
        gw = gw + np.asarray(gwb)
    return (rows, key_max, np.concatenate(counts), np.concatenate(geq),
            np.concatenate(gz), gw)


# the small shapes with every sigma and type, and roman-empire's width
# (the kernels' wide path on the card) with erf-GELU, its sigma
PLAIN_CASES = [(graph, h, o, act, dt)
               for graph, h, o in (("random", 24, 40), ("hub", 16, 16),
                                   ("ties", 32, 24))
               for act in sorted(ACTS) for dt in sorted(DTYPES)] + [
    ("random", 512, 512, "gelu", dt) for dt in sorted(DTYPES)]


@pytest.mark.parametrize("graph,h,o,act,dt", PLAIN_CASES)
def test_max_plains_match_pallas(graph, h, o, act, dt):
    c = make_case(graph, h, o)
    pallas, jact, jdt = jax_side(act, dt)
    args = _port_args(c, DTYPES[dt])
    tact = ACTS[act]
    rows, key_max_j, counts_j, geq_j, gz_j, gw_j = _pallas_rows(
        c, pallas, jact, jdt)

    got = ell_max_fwd(*args, tact)
    np.testing.assert_allclose(got.numpy(), rows, **FWD_TOL)
    assert (got.numpy() == np.finfo(np.float32).min).any()  # invalid row
    key_max = c.fg.dst_plan.finalize_rows_max(got)
    np.testing.assert_allclose(key_max.numpy(), key_max_j.numpy(),
                               **FWD_TOL)

    counts = ell_max_wincount(*args, key_max, tact)
    np.testing.assert_array_equal(counts.numpy(), counts_j)
    if graph == "ties":
        assert counts.max() >= 2

    geq, gz, gw = ell_max_bwd(*args, key_max, _t(c.g), tact)
    assert gz.dtype == DTYPES[dt]
    np.testing.assert_allclose(geq.numpy(), geq_j, **BWD_TOL)
    np.testing.assert_allclose(gz.float().numpy(), gz_j,
                               **(BF16_STEP if dt == "bf16" else BWD_TOL))
    np.testing.assert_allclose(gw.numpy(), gw_j, **BWD_TOL)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("graph,h", [("random", 24), ("hub", 40)])
def test_scaled_reduce_plain_matches_pallas(graph, h, dt):
    import jax.numpy as jnp
    from sir_gcn_tpu.ops.ell import _bucket_offsets

    c = make_case(graph, h, 8, seed=2)
    pallas, _, jdt = jax_side("tanh", dt)
    rng = np.random.default_rng(3)
    values = rng.normal(size=(c.fg.dst_plan.num_slots, h)).astype(np.float32)
    splan = c.fg.src_plan
    got = ell_scaled_reduce(_t(values, DTYPES[dt]), c.fg.src_slot_from_dst_slot,
                            splan.slot_valid, splan.row_ptr)

    vsrc = jnp.take(jnp.asarray(values).astype(jdt),
                    jnp.asarray(c.fg.src_slot_from_dst_slot.numpy()), axis=0)
    sv = jnp.asarray(splan.slot_valid.numpy())
    want = np.concatenate([np.asarray(pallas.bucket_scaled_reduce(
        vsrc[so:so + b * nr], sv[so:so + b * nr].reshape(nr, b), b,
        interpret=True)) for b, nr, so, _ in _bucket_offsets(splan.buckets1)])
    np.testing.assert_allclose(got.numpy(), want, **BWD_TOL)


def test_scaled_reduce_never_reads_through_a_zero_scale():
    c = make_case("random", 8, 8)
    splan = c.fg.src_plan
    values = torch.full((c.fg.dst_plan.num_slots, 8), float("nan"))
    got = ell_scaled_reduce(values, c.fg.src_slot_from_dst_slot,
                            torch.zeros_like(splan.slot_valid),
                            splan.row_ptr)
    assert (got == 0).all()


@pytest.mark.parametrize("graph", ["random", "hub", "isolated", "ties"])
def test_slot_map_and_max_finalize_match_jax(graph):
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.ell as jell
    from sir_gcn_tpu import build_graph as j_build_graph

    src, dst, n, mb = graph_edges(graph, np.random.default_rng(5))
    jfg = jell.build_fast_graph(j_build_graph(src, dst, n), max_budget=mb)
    tfg = tell.build_fast_graph(build_graph(src, dst, n), max_budget=mb)
    np.testing.assert_array_equal(tfg.src_slot_from_dst_slot.numpy(),
                                  np.asarray(jfg.src_slot_from_dst_slot))
    neg = float(jnp.finfo(jnp.float32).min)
    for side in ("dst_plan", "src_plan"):
        jp, tp = getattr(jfg, side), getattr(tfg, side)
        rows = np.random.default_rng(6).normal(
            size=(tp.num_rows, 5)).astype(np.float32)
        rows[::3] = neg  # rows with no valid slot
        want = np.asarray(jp._finalize(jnp.asarray(rows), "max", neg))
        np.testing.assert_array_equal(
            tp.finalize_rows_max(torch.from_numpy(rows)).numpy(), want,
            err_msg=side)
    if graph == "hub":
        assert tfg.dst_plan.s2_gather is not None
    if graph == "isolated":  # empty keys read the f32-min row
        out = tfg.dst_plan.finalize_rows_max(torch.zeros(
            tfg.dst_plan.num_rows, 2))
        assert (out[40:] == neg).all()


# ----------------------------------------------------------------------
# The aggregate and its gradients
# ----------------------------------------------------------------------

def _agg_case(graph: str, h: int = 24, o: int = 40):
    import sir_gcn_tpu.ops.ell as jell
    from sir_gcn_tpu import build_graph as j_build_graph

    rng = np.random.default_rng(11)
    src, dst, n, mb = graph_edges(graph, rng)
    pad = dict(n_pad=64, e_pad=512) if graph == "random" else {}
    jfg = jell.build_fast_graph(j_build_graph(src, dst, n, **pad),
                                max_budget=mb)
    tfg = tell.build_fast_graph(build_graph(src, dst, n, **pad),
                                max_budget=mb)
    x = lambda *s: rng.normal(size=s).astype(np.float32)
    return SimpleNamespace(jfg=jfg, tfg=tfg, eq=x(tfg.n_pad, h),
                           ek=x(tfg.n_pad, h),
                           w=(x(h, o) / np.sqrt(h)).astype(np.float32),
                           b=x(o), gw=x(tfg.n_pad, o))


def _port_max(c, dtype):
    tmp.set_edge_dtype(dtype)
    try:
        ts = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (c.eq, c.ek, c.w, c.b)]
        out = tmp.sir_aggregate(c.tfg, ts[0], ts[1], tell.leaky_relu(0.2),
                                "max", w_relation=ts[2], b_relation=ts[3])
        (out * torch.from_numpy(c.gw)).sum().backward()
    finally:
        tmp.set_edge_dtype(None)
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_max(c, f):
    import jax
    import jax.numpy as jnp

    valid = jnp.asarray(np.asarray(c.jfg.edge_mask, np.float32))
    e0 = jnp.zeros((0,), jnp.float32)
    args = [jnp.asarray(a) for a in (c.eq, c.ek, c.w, c.b)]

    def loss(eq, ek, w, b):
        return jnp.sum(f(eq, ek, e0, valid, w, b) * jnp.asarray(c.gw))

    out = f(args[0], args[1], e0, valid, args[2], args[3])
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("graph,dt", [
    ("random", "f32"), ("hub", "f32"), ("isolated", "f32"), ("ties", "f32"),
    ("random", "bf16"), ("hub", "bf16"),
])
def test_max_aggregate_matches_jax(graph, dt):
    import jax
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.ell as jell

    c = _agg_case(graph)
    jact = lambda x: jax.nn.leaky_relu(x, 0.2)
    out, grads = _port_max(c, DTYPES[dt] if dt == "bf16" else None)
    refs = [jell.make_ell_sir_aggregate_max_pallas(
        c.jfg, jact, interpret=True,
        edge_dtype=jnp.bfloat16 if dt == "bf16" else None)]
    if dt == "f32":  # the JAX package's XLA builder, the CPU route there
        refs.append(jell.make_ell_sir_aggregate_max(c.jfg, jact))
    for f in refs:
        jout, jgrads = _jax_max(c, f)
        np.testing.assert_allclose(out, jout, **FWD_TOL)
        for name, a, b in zip(("eq", "ek", "w", "b"), grads, jgrads):
            np.testing.assert_allclose(a, b, **BWD_TOL, err_msg=name)
    if graph == "isolated":  # nodes without an in-edge are zero-filled
        assert (out[40:] == 0).all()


def test_max_backward_splits_ties():
    """Duplicated edges tie exactly, and the counts that split the
    cotangent see every tied winner; the gradients themselves are held to
    JAX's on this graph by ``test_max_aggregate_matches_jax[ties-f32]``
    (the case of tests/test_pallas_edge_max.py)."""
    c = _agg_case("ties", h=32, o=32)
    plan = c.tfg.dst_plan
    args = (torch.from_numpy(c.eq), torch.from_numpy(c.ek),
            c.tfg.dst_slot_srcnode, c.tfg.dst_slot_scales["sum"],
            plan.row_key, plan.row_ptr, torch.from_numpy(c.w))
    key_max = plan.finalize_rows_max(ell_max_fwd(*args, tell.leaky_relu(0.2)))
    counts = plan.finalize_rows_sum(
        ell_max_wincount(*args, key_max, tell.leaky_relu(0.2)))
    # node 5 gets edge (0, 5) four times, node 7 edge (2, 7) six times, over
    # two chunk rows (budget 4) that the hub stage 2 combines
    assert (counts[5] == 4).all() and (counts[7] == 6).all()
    assert (counts[6] == 2).all() and (counts[8] == 2).all()
    assert plan.s2_gather is not None


def test_max_paths_reach_their_kernels(monkeypatch):
    import sir_gcn_tpu_torch.ops.cuda.kernels as tk

    calls = []
    for name in ("ell_max_fwd_plain", "ell_max_wincount_plain",
                 "ell_max_bwd_plain", "ell_scaled_reduce_plain"):
        fn = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n[:-6]), _f(*a, **k))[1])
    c = _agg_case("random")
    with torch.no_grad():
        tmp.sir_aggregate(c.tfg, torch.from_numpy(c.eq),
                          torch.from_numpy(c.ek), tell.tanh, "max",
                          w_relation=torch.from_numpy(c.w))
    assert calls == ["ell_max_fwd"]
    calls.clear()
    _port_max(c, None)
    assert calls == ["ell_max_fwd", "ell_max_wincount", "ell_max_bwd",
                     "ell_scaled_reduce"]


def test_max_unported_branches_raise():
    """What still raises: max without W_R. The branches that raised before
    the port had them now compute, held against the JAX package's: a
    sigma outside the registry (the pure ELL route, JAX's
    ``make_ell_sir_aggregate_max``), a DropEdge mask (the max kernels on
    dynamic validity, JAX's ``make_ell_sir_aggregate_max_pallas`` in
    interpret mode), and an edge term with a registry sigma (the edge forms
    of the max kernels, JAX's builder ``with_edge``), out and every
    gradient."""
    import jax
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.ell as jell

    c = _agg_case("random")
    eq, ek, w = (torch.from_numpy(a) for a in (c.eq, c.ek, c.w))
    act = tell.leaky_relu(0.2)
    with pytest.raises(ValueError, match="w_relation"):
        tmp.sir_aggregate(c.tfg, eq, ek, act, "max")

    mask = np.random.default_rng(5).random(c.tfg.e_pad) >= 0.3
    jact = lambda x: jax.nn.leaky_relu(x, 0.2)
    e = np.random.default_rng(6).normal(
        size=(c.tfg.e_pad, 24)).astype(np.float32)
    for tact, emask, f, valid, edge in (
            (torch.tanh, None, jell.make_ell_sir_aggregate_max(
                c.jfg, jnp.tanh), np.asarray(c.jfg.edge_mask), None),
            (act, mask, jell.make_ell_sir_aggregate_max_pallas(
                c.jfg, jact, interpret=True),
             mask & np.asarray(c.jfg.edge_mask), None),
            (act, mask, jell.make_ell_sir_aggregate_max_pallas(
                c.jfg, jact, with_edge=True, interpret=True),
             mask & np.asarray(c.jfg.edge_mask), e)):
        arrays = (c.eq, c.ek, c.w, c.b) + (() if edge is None else (edge,))
        ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
        out = tmp.sir_aggregate(
            c.tfg, ts[0], ts[1], tact, "max", w_relation=ts[2],
            b_relation=ts[3], e=None if edge is None else ts[4],
            edge_mask=None if emask is None else torch.from_numpy(emask))
        (out * torch.from_numpy(c.gw)).sum().backward()
        v = jnp.asarray(valid, jnp.float32)
        e0 = jnp.zeros((0,), jnp.float32) if edge is None else \
            jnp.asarray(edge)
        args = [jnp.asarray(a) for a in (c.eq, c.ek, c.w, c.b)]
        np.testing.assert_allclose(
            out.detach().numpy(),
            np.asarray(f(args[0], args[1], e0, v, args[2], args[3])),
            **FWD_TOL)
        grads = jax.grad(lambda a, b, ww, bb, ee: jnp.sum(
            f(a, b, ee, v, ww, bb) * jnp.asarray(c.gw)),
            argnums=(0, 1, 2, 3, 4))(*args, e0)
        names = ("eq", "ek", "w", "b") + (() if edge is None else ("e",))
        for name, t, g in zip(names, ts, grads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       **BWD_TOL, err_msg=name)


def test_max_wrappers_check_inputs_and_count_no_cpu_launch():
    c = make_case("random", 24, 40)
    args = list(_port_args(c, torch.float32))
    reset_launch_counts()
    key_max = c.fg.dst_plan.finalize_rows_max(ell_max_fwd(*args, tell.tanh))
    ell_max_wincount(*args, key_max, tell.tanh)
    ell_max_bwd(*args, key_max, _t(c.g), tell.tanh)
    assert all(v == 0 for v in LAUNCHES.values())
    bad = [
        (6, _t(c.w)[:8].contiguous()),            # W rows != H
        (6, _t(c.w, torch.bfloat16)),             # W dtype
        (1, _t(c.ek)[:, :8].contiguous()),        # ek width
    ]
    for pos, value in bad:
        a = list(args)
        a[pos] = value
        with pytest.raises((TypeError, ValueError)):
            ell_max_fwd(*a, tell.tanh)
    with pytest.raises(ValueError, match="key_max"):
        ell_max_wincount(*args, key_max[:, :8].contiguous(), tell.tanh)
    with pytest.raises(ValueError, match="gsc"):
        ell_max_bwd(*args, key_max, _t(c.g)[:-1].contiguous(), tell.tanh)


# ----------------------------------------------------------------------
# The kernels' product: TF32 in three passes
# ----------------------------------------------------------------------

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32`` and the kernels' ``tf32_rna``: half of
    the 13 dropped bits is added to the magnitude's bit pattern, then they
    are cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_products(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [n, H] @ w [H, O] as ``csrc/ell_max_kernels.cu`` computes it: both
    operands split into hi = tf32(x) and lo = tf32(x - hi), k steps of 8
    in increasing h, each step three m16n8k8 products (a_lo w_hi, a_hi
    w_lo, a_hi w_hi) summed from zero and then added to the f32
    accumulator. Each product's eight terms are exact in TF32 x TF32; the
    emulation adds them in f64 and rounds once per product, a model of
    the tensor core's own adder (which on the card rounds with a bias:
    hence the kernels' step-wise sums)."""
    hp = -(-a.shape[1] // 8) * 8
    a = torch.nn.functional.pad(a, (0, hp - a.shape[1]))
    w = torch.nn.functional.pad(w, (0, 0, 0, hp - w.shape[0]))
    ah, wh = tf32_rna(a), tf32_rna(w)
    al, wl = tf32_rna(a - ah), tf32_rna(w - wh)
    acc = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float32)
    for k in range(0, hp, 8):
        part = torch.zeros_like(acc)
        for x, y in ((al, wh), (ah, wl), (ah, wh)):
            part = (part.double() + x[:, k:k + 8].double()
                    @ y[k:k + 8].double()).float()
        acc = acc + part
    return acc


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the TF32 value after 1
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, one + 2.0 ** -11 - 2.0 ** -23,
                      0.0, -0.0], dtype=torch.float32)
    want = [1.0, one, -one, 1.0, one, 0.0, -0.0]
    assert tf32_rna(x).tolist() == want
    assert (tf32_rna(x).view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("h,o", [(96, 96), (24, 40), (200, 200), (512, 512)])
def test_three_pass_tf32_product_is_f32_accurate(h, o, act):
    """The split product of the max kernels stays within the forward
    tolerance of ``slot_products`` (the plain versions' yardstick) and
    within a tenth of NEAR_TIE of the exact product, relative to 1 + |m|,
    at the arxiv width and the test widths; one TF32 pass would not."""
    rng = np.random.default_rng(h + o)
    z = rng.normal(size=(4000, h)) + rng.normal(size=(4000, h))
    a = ACTS[act](torch.from_numpy(z.astype(np.float32)))
    w = torch.from_numpy(
        (rng.uniform(-1, 1, size=(h, o)) / np.sqrt(h)).astype(np.float32))
    exact = a.double() @ w.double()
    got = split_products(a, w)
    torch.testing.assert_close(got, slot_products(a, w), **FWD_TOL)
    rel = ((got.double() - exact).abs() / (1 + exact.abs())).max()
    assert rel <= NEAR_TIE / 10, float(rel)
    one_pass = (tf32_rna(a).double() @ tf32_rna(w).double()).float()
    assert ((one_pass.double() - exact).abs() / (1 + exact.abs())).max() \
        > NEAR_TIE


def test_max_layout_python_side():
    """``ell_max_layout`` checks its widths before it asks the library,
    and its codes decode to the path and the launch shapes."""
    for h, o in ((0, 96), (96, 0), (-1, 8)):
        with pytest.raises(ValueError, match="positive"):
            ell_max_layout(h, o)
    code = 1 | 16 << 1 | 96 << 6 | 8 << 14 | 1 << 19
    assert decode_max_layout(code) == MaxLayout("tensor", 16, 96, 8, True)
    assert decode_max_layout(1 | 4 << 1 | 8 << 6 | 5 << 14) == MaxLayout(
        "tensor", 4, 8, 5, False)
    # the wide path (H = O = 512): sixteen warps in both kernels, slabs of
    # 32 columns, g_W formed apart, tiles of 32 slots
    wide = 1 | 16 << 1 | 32 << 6 | 16 << 14 | 1 << 20 | 2 << 21
    assert decode_max_layout(wide) == MaxLayout("tensor", 16, 32, 16, False,
                                                True, 32)
    # where H and O lie far apart (1700 x 8): one warp, one subtile
    narrow = 1 | 1 << 1 | 8 << 6 | 1 << 14 | 1 << 20 | 1 << 21
    assert decode_max_layout(narrow) == MaxLayout("tensor", 1, 8, 1, False,
                                                  True, 16)
    assert not decode_max_layout(code).wide
    assert decode_max_layout(-1) is None
    with pytest.raises(ValueError, match="no product path"):
        decode_max_layout(code & ~1)


def test_max_ab_takes_the_width(tmp_path):
    """``ell_ab --max --hidden H`` (the wide path's A/B at H = O = 512)
    parses and then needs the card; --hidden is for --max, --edge and
    --general only, --de for --edge only, --define for --max only."""
    from sir_gcn_tpu_torch.tools import ell_ab

    other = str(tmp_path / "other.cu")
    for argv in (["--lab", "--hidden", "512", other],
                 ["--max", "--de", "8", other],
                 ["--edge", "--define", "ELL_MAX_WIDE_ONLY", other]):
        with pytest.raises(SystemExit):
            ell_ab.main(argv)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ell_ab.main(["--max", "--hidden", "512", other])


# ----------------------------------------------------------------------
# SIRConv, the arxiv SIRModel and the trainer with max
# ----------------------------------------------------------------------

def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items")
                   else {prefix + (k,): np.asarray(v)})
    return out


def test_sir_conv_max_matches_jax():
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.models.conv import SIRConv as JSIRConv

    from sir_gcn_tpu_torch.models import SIRConv

    c = _agg_case("hub", h=16, o=12)
    rng = np.random.default_rng(4)
    feat = rng.normal(size=(c.tfg.n_pad, 10)).astype(np.float32)
    jact = lambda x: jax.nn.leaky_relu(x, 0.2)
    jconv = JSIRConv(hidden_dim=16, output_dim=12, activation=jact,
                     agg_type="max")
    params = jconv.init(jax.random.PRNGKey(1), c.jfg, jnp.asarray(feat))
    conv = SIRConv(10, 16, 12, tell.leaky_relu(0.2), agg_type="max",
                   generator=torch.Generator().manual_seed(0))
    assert not hasattr(conv, "linear_relation")
    p = _flat(params["params"])
    torch_of = {
        ("linear_query", "Dense_0", "kernel"): (conv.linear_query.weight, 1),
        ("linear_query", "Dense_0", "bias"): (conv.linear_query.bias, 0),
        ("linear_key", "Dense_0", "kernel"): (conv.linear_key.weight, 1),
        ("relation_kernel",): (conv.relation_kernel, 0),
        ("relation_bias",): (conv.relation_bias, 0),
    }
    assert set(p) == set(torch_of)
    with torch.no_grad():
        for k, (t, tr) in torch_of.items():
            assert tuple(t.shape) == (p[k].T.shape if tr else p[k].shape)
            t.copy_(torch.tensor(p[k].T if tr else p[k]))

    tfeat = torch.from_numpy(feat).requires_grad_()
    out = conv(c.tfg, tfeat)
    (out * torch.from_numpy(c.gw[:, :12])).sum().backward()

    def loss(prm, x):
        y = jconv.apply(prm, c.jfg, x, deterministic=True)
        return jnp.sum(y * jnp.asarray(c.gw[:, :12])), y

    (_, jout), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        params, jnp.asarray(feat))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    np.testing.assert_allclose(tfeat.grad.numpy(), np.asarray(gx), **BWD_TOL)
    for k, g in _flat(gp["params"]).items():
        t, tr = torch_of[k]
        have = t.grad.numpy()
        np.testing.assert_allclose(have.T if tr else have, g, **BWD_TOL,
                                   err_msg="/".join(k))


H, LAYERS, LR, WD = 16, 3, 1e-2, 1e-3


def test_arxiv_model_max_matches_jax():
    """Logits, loss, every gradient, the BN statistics, eval logits and
    one AdamW step, as ``test_torch_model.py`` holds the sym model."""
    import jax
    import jax.numpy as jnp
    from experiments.ogbn_arxiv import model as jmodel
    from experiments.ogbn_arxiv import train as jtrain
    from sir_gcn_tpu.train import init_state
    from sir_gcn_tpu.train import make_adamw as j_make_adamw
    from sir_gcn_tpu.train import set_lr_scale as j_set_lr_scale
    from sir_gcn_tpu.train import warmup_scale as j_warmup_scale

    import sir_gcn_tpu_torch.experiments.ogbn_arxiv.model as tmodel
    import sir_gcn_tpu_torch.experiments.ogbn_arxiv.train as ttrain
    from sir_gcn_tpu_torch.data import synthetic_node_classification
    from sir_gcn_tpu_torch.train import make_adamw, set_lr_scale, warmup_scale
    from sir_gcn_tpu_torch.utils import load_jax_variables
    from sir_gcn_tpu_torch.utils.convert import _sir_model_slots

    tmp.set_edge_dtype(None)
    data = synthetic_node_classification(num_nodes=150, num_edges=600,
                                         feat_dim=20, num_classes=5, seed=0)
    flags = SimpleNamespace(add_reverse_edge=True, add_self_loop=True)
    jfg = jtrain.build_arxiv_graph(data, flags)
    tfg = ttrain.build_arxiv_graph(data, flags, "cpu")
    n_pad = tfg.n_pad
    feats = np.zeros((n_pad, 20), np.float32)
    feats[:150] = data.feat
    labels = np.zeros(n_pad, np.int64)
    labels[:150] = data.labels
    lw = np.zeros(n_pad, np.float32)
    lw[data.train_idx] = 1.0

    kw = dict(num_layers=LAYERS, norm="bn", residual=True, agg_type="max")
    jm = jmodel.SIRModel(hidden_dim=H, output_dim=5, **kw)
    variables = jm.init(jax.random.PRNGKey(0), jfg, jnp.asarray(feats))
    tm = tmodel.SIRModel(20, H, 5, **kw)
    load_jax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))

    def loss_fn(p):
        logits, upd = jm.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, jfg,
            jnp.asarray(feats), deterministic=False, mutable=["batch_stats"])
        loss = jtrain.soft_ce(logits, jnp.asarray(labels, jnp.int32),
                              jnp.asarray(lw))
        return loss, (logits, upd["batch_stats"])

    (loss_j, (logits_j, stats_j)), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])

    opt = make_adamw(tm.parameters(), LR, WD)
    set_lr_scale(opt, warmup_scale(1, ttrain.WARMUP))
    tm.train()
    logits = tm(tfg, torch.from_numpy(feats))
    loss = ttrain.soft_ce(logits, torch.from_numpy(labels),
                          torch.from_numpy(lw))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               **FWD_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               **FWD_TOL)

    slots = _sir_model_slots(tm)
    flat_grads = {("params",) + k: v for k, v in _flat(grads_j).items()}
    flat_stats = {("batch_stats",) + k: v for k, v in _flat(stats_j).items()}
    assert set(flat_grads) | set(flat_stats) == set(slots)
    assert ("params", "conv_0", "relation_kernel") in slots
    for key, g in flat_grads.items():
        tensor, transpose = slots[key]
        have = tensor.grad.numpy()
        np.testing.assert_allclose(have.T if transpose else have, g,
                                   **BWD_TOL, err_msg="/".join(key))
    for key, v in flat_stats.items():
        np.testing.assert_allclose(slots[key][0].numpy(), v, **FWD_TOL,
                                   err_msg="/".join(key))

    tm.eval()
    with torch.no_grad():
        ev = tm(tfg, torch.from_numpy(feats))
    ev_j = jm.apply({"params": variables["params"], "batch_stats": stats_j},
                    jfg, jnp.asarray(feats), deterministic=True)
    np.testing.assert_allclose(ev.numpy(), np.asarray(ev_j), **FWD_TOL)

    # one AdamW step; Adam's first step is about lr * sign(g), so entries
    # with |g| < 1e-6 are left out
    opt.step()
    tx = j_make_adamw(LR, WD)
    state = j_set_lr_scale(init_state(variables, tx), j_warmup_scale(1, 20))
    updates, _ = tx.update(grads_j, state.opt_state, state.params)
    new_params = jax.tree_util.tree_map(lambda p, u: p + u, state.params,
                                        updates)
    for k, p in _flat(new_params).items():
        key = ("params",) + k
        tensor, transpose = slots[key]
        have = tensor.detach().numpy()
        have = have.T if transpose else have
        keep = np.abs(flat_grads[key]) >= 1e-6
        np.testing.assert_allclose(have[keep], p[keep], **FWD_TOL,
                                   err_msg="/".join(key))


def test_trainer_max_on_cpu(capsys):
    import sir_gcn_tpu_torch.experiments.ogbn_arxiv.train as ttrain

    try:
        results = ttrain.main([
            "--cpu", "--nhidden", "16", "--nlayers", "2", "--agg-type",
            "max", "--norm", "bn", "--residual", "--dropout", "0.2",
            "--feat-dropout", "0.2", "--add-reverse-edge", "--add-self-loop",
            "--edge-bf16", "--epochs", "2", "--nruns", "1", "--log-every",
            "1", "--synthetic-nodes", "200", "--synthetic-edges", "800"])
    finally:
        tmp.set_edge_dtype(None)
    (r,) = results
    assert len(r["train_losses"]) == 2
    assert np.isfinite(r["train_losses"]).all()
    assert "Epoch 0002" in capsys.readouterr().out


# ----------------------------------------------------------------------
# On the card: each kernel against its plain version
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def near_ties(c, args, tact):
    """[N, O] True at the (key, o) whose two largest valid slot products
    lie apart by at most NEAR_TIE of 1 + |max| but not 0 (an exact tie,
    from duplicated edges, is the same product on both sides): the card's
    three-pass TF32 product and the plain version's f32 sum may pick
    different winners there (chip_smoke.py's ``near_ties``)."""
    plan = c.fg.dst_plan
    eq, ek, slot_src, scale, row_key, _, w = args
    t1, t2 = [], []
    for _, _, _, _, m, valid in bucket_products(
            eq, ek, slot_src, scale, row_key, w, tact, plan.buckets1):
        mv = torch.where(valid, m, NEG)
        if mv.shape[1] >= 2:
            top = mv.topk(2, dim=1).values
            t1.append(top[:, 0])
            t2.append(top[:, 1])
        else:
            t1.append(mv[:, 0])
            t2.append(torch.full_like(mv[:, 0], NEG))
    t1, t2 = torch.cat(t1), torch.cat(t2)
    k1 = plan.finalize_rows_max(t1)
    k1_rows = k1.index_select(0, plan.row_key)
    k2 = torch.maximum(plan.finalize_rows_max(t2), plan.finalize_rows_max(
        torch.where(t1 < k1_rows, t1, NEG)))
    shared = plan.finalize_rows_sum((t1 == k1_rows).float()) >= 2
    k2 = torch.where(shared, k1, k2)
    gap = k1 - k2
    return (k2 > NEG / 2) & (gap > 0) & (gap <= NEAR_TIE * (1 + k1.abs()))


def _kernels_match_plain(c, dt, tact, device, mask_near_ties=False):
    """#9-#12 on the card against their plain versions on case ``c``, each
    side's counts and backward against its own forward's maxima; one
    launch of each. With ``mask_near_ties`` the cotangent is 0 at the
    near ties, where the two may take different winners (their counts
    agree there all the same: one winner each)."""
    args = _port_args(c, DTYPES[dt], device)
    plan, splan = c.fg.dst_plan, c.fg.src_plan
    gsc = _t(c.g, device=device)
    if mask_near_ties:
        gsc = torch.where(near_ties(c, args, tact), 0.0, gsc).contiguous()
    reset_launch_counts()
    rows = ell_max_fwd(*args, tact)
    key_max = plan.finalize_rows_max(rows)
    counts = ell_max_wincount(*args, key_max, tact)
    geq, gz, gw = ell_max_bwd(*args, key_max, gsc, tact)
    red = ell_scaled_reduce(gz, c.fg.src_slot_from_dst_slot,
                            splan.slot_valid, splan.row_ptr)
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {
        "ell_max_fwd": 1, "ell_max_wincount": 1, "ell_max_bwd": 1,
        "ell_scaled_reduce": 1}

    rows_p = ell_max_fwd_plain(*args, tact)
    key_max_p = plan.finalize_rows_max(rows_p)
    torch.testing.assert_close(rows, rows_p, **FWD_TOL)
    torch.testing.assert_close(
        counts, ell_max_wincount_plain(*args, key_max_p, tact), atol=0,
        rtol=0)
    geq_p, gz_p, gw_p = ell_max_bwd_plain(*args, key_max_p, gsc, tact)
    torch.testing.assert_close(geq, geq_p, **BWD_TOL)
    torch.testing.assert_close(gz.float(), gz_p.float(),
                               **(BF16_STEP if dt == "bf16" else BWD_TOL))
    torch.testing.assert_close(gw, gw_p, **BWD_TOL)
    torch.testing.assert_close(
        red, ell_scaled_reduce_plain(gz, c.fg.src_slot_from_dst_slot,
                                     splan.slot_valid, splan.row_ptr),
        **BWD_TOL)
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("graph,h,o", [("hub", 24, 40), ("random", 96, 96),
                                       ("random", 200, 200),
                                       ("ties", 32, 24), ("random", 36, 100),
                                       ("hub256", 24, 40)])
def test_max_kernels_match_plain_on_card(cuda_device, graph, h, o, act, dt):
    """Every shape on the tensor-core path: H and O off multiples of 8
    (36 x 100), rows longer than a 16-slot tile (hub: budget 64; hub256:
    chunk rows of 256), W too large for one block's shared memory (200 x
    200, the wide path), exact ties."""
    c = make_case(graph, h, o, device=cuda_device)
    assert ell_max_layout(h, o).path == "tensor"
    counts = _kernels_match_plain(c, dt, ACTS[act], cuda_device)
    if graph == "ties":
        assert counts.max() >= 2


# the wide path's shapes: roman-empire's width, 520 (a pass of 65 column
# tiles: two slabs' passes), O != H either way past shared memory, O off
# a multiple of 4 (W's rows copied 4 bytes at a time) with H = 300 (bf16
# rows gathered a feature a lane); rows cut by tiles (hub256), exact ties,
# a graph with isolated nodes; widths far apart, where the tile takes one
# subtile (64 x 1600) and the block eight warps (1400 x 64) or one (1700 x
# 8)
WIDE_CASES = [("random", 512, 512), ("random", 520, 520), ("random", 512, 200),
              ("random", 264, 600), ("random", 300, 203),
              ("hub256", 512, 512), ("ties", 512, 512), ("isolated", 512, 512),
              ("random", 64, 1600), ("random", 1400, 64), ("random", 1700, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", ["leaky_relu", "gelu"])
@pytest.mark.parametrize("graph,h,o", WIDE_CASES)
def test_max_wide_kernels_match_plain_on_card(cuda_device, graph, h, o, act,
                                              dt):
    """The wide path (a block a tile of 16 or 32 slots, W streamed through
    shared memory, g_W by a split-K product) against the plain versions:
    zero-scale slots and a row with none valid, every block's partial last
    tile, counts exact on ties; the cotangent masked at near ties, as
    chip_smoke.py masks it (at 520 x 520 with erf-GELU in f32 two slots'
    products lie 6.8e-8 apart). The (200, 200) case of
    ``test_max_kernels_match_plain_on_card`` runs the wide path unmasked."""
    c = make_case(graph, h, o, device=cuda_device)
    lay = ell_max_layout(h, o)
    assert lay.wide
    assert lay.tile_slots == (32 if max(h, o) <= 600 else 16)
    counts = _kernels_match_plain(c, dt, ACTS[act], cuda_device,
                                  mask_near_ties=True)
    if graph == "ties":
        assert counts.max() >= 2


def _fallback_took(h, o):
    """Whether #9-#11 took widths (h, o) before the wide path: the first
    design's forward, in W column chunks, and its backward, with one warp's
    buffers in a block's shared memory and W read from device memory
    where it did not fit beside them (the rule of ``fwd_config`` and
    ``bwd_config`` in ``csrc/ell_max_kernels.cu`` as the device-memory
    fallback had them)."""
    room, pre = 232448 - 1024, 2

    def r(x, m):
        return (x + m - 1) // m * m

    def stride(x, res):
        return x + ((res - x % 32) + 32) % 32

    hp = r(h, 8)
    fwd = False
    for oc in range(min(96, r(o, 8)), 7, -8):
        per_warp = (16 * max(stride(hp, 4), stride(oc, 8))
                    + (1 + pre) * r(oc, 4))
        if 8 * hp * stride(oc, 8) + 4 * per_warp <= room:
            fwd = True
            break
    op = r(o, 16)
    per_warp = 4 * (32 * stride(hp, 8) + 16 * stride(op, 8) + r(hp, 4)
                    + 2 * pre * r(op, 4))
    return fwd and per_warp <= room


@pytest.mark.cuda
def test_max_layout_takes_every_width_the_fallback_took(cuda_device):
    """The wide path took the place of the first design's device-memory
    fallback for W: every width that fallback took (H up to 1704, O up to
    2843) still has a path, and the widest of them (H and O far apart)
    take the wide path with fewer subtiles or warps."""
    hs = sorted({*range(8, 1760, 24), 1, 1700, 1704, 1705})
    os_ = sorted({*range(8, 2900, 40), 1, 1600, 2843, 2848})
    took = 0
    for h in hs:
        for o in os_:
            if _fallback_took(h, o):
                took += 1
                assert ell_max_layout(h, o) is not None, (h, o)
    assert took > len(hs) * len(os_) // 4
    assert ell_max_layout(64, 1600).tile_slots == 16
    assert ell_max_layout(1400, 64).bwd_warps == 8
    assert ell_max_layout(1700, 8).fwd_warps == 1
    assert ell_max_layout(512, 512) == MaxLayout("tensor", 16, 32, 16, False,
                                                 True, 32)


TILINGS = [("random", 96, 96), ("hub256", 24, 40), ("random", 36, 100),
           ("random", 200, 200), ("random", 512, 512)]


def _one_slot_products(c, args, tact):
    """Each valid slot's m [V, O] by ``ell_max_fwd`` on a plan of one-slot
    rows (what ``winner_flips`` in chip_smoke.py reads), and each valid
    slot's row in the full plan."""
    eq, ek, slot_src, scale, row_key, row_ptr, w = args
    vs = (scale > 0).nonzero().flatten()
    row = torch.searchsorted(row_ptr[1:].long(), vs, right=True)
    one = ell_max_fwd(eq, ek, slot_src[vs].contiguous(),
                      torch.ones(vs.numel(), device=eq.device),
                      row_key[row].contiguous(),
                      torch.arange(vs.numel() + 1, dtype=torch.int32,
                                   device=eq.device), w, tact)
    return one, row


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("graph,h,o", TILINGS)
def test_max_products_have_the_same_bits_in_any_tiling(cuda_device, graph, h,
                                                       o, dt):
    """A slot's m is rounded alike in the full plan's tiles (rows packed
    into 16-slot tiles or walked in chunks) and alone in a plan of
    one-slot rows: the row maxima and the win counts of the full plan are
    those of the one-slot products, bit for bit."""
    c = make_case(graph, h, o, device=cuda_device)
    tact = ACTS["leaky_relu"]
    args = _port_args(c, DTYPES[dt], cuda_device)
    plan = c.fg.dst_plan
    rows = ell_max_fwd(*args, tact)
    key_max = plan.finalize_rows_max(rows)
    counts = ell_max_wincount(*args, key_max, tact)
    one, row = _one_slot_products(c, args, tact)
    idx = row[:, None].expand(-1, o)
    want = torch.full_like(rows, float(np.finfo(np.float32).min))
    want.scatter_reduce_(0, idx, one, "amax")
    assert torch.equal(rows, want)
    wins = (one == key_max.index_select(0, plan.row_key)[row]).float()
    assert torch.equal(counts, torch.zeros_like(counts).index_add_(0, row,
                                                                   wins))


@pytest.mark.cuda
@pytest.mark.parametrize("graph,h,o", TILINGS + [("hub", 24, 40)])
def test_win_counts_cover_every_key_max_on_card(cuda_device, graph, h, o):
    """Summed over a key's rows, #10 counts at least one winner at every
    (key, o) of a key with a valid slot: #9 and #10 agree bit for bit."""
    c = make_case(graph, h, o, device=cuda_device)
    tact = ACTS["tanh"]
    args = _port_args(c, torch.bfloat16, cuda_device)
    plan = c.fg.dst_plan
    key_max = plan.finalize_rows_max(ell_max_fwd(*args, tact))
    counts = plan.finalize_rows_sum(ell_max_wincount(*args, key_max, tact))
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
@pytest.mark.parametrize("graph,h,o", [("random", 96, 96),
                                       ("random", 200, 200),
                                       ("hub256", 24, 40),
                                       ("hub256", 512, 512)])
def test_max_bwd_is_bitwise_repeatable_on_card(cuda_device, graph, h, o):
    """Two launches of #11 on the same inputs give the same bits: g_W's
    partials are summed in block order, with no atomics."""
    c = make_case(graph, h, o, device=cuda_device)
    tact = ACTS["leaky_relu"]
    args = _port_args(c, torch.bfloat16, cuda_device)
    key_max = c.fg.dst_plan.finalize_rows_max(ell_max_fwd(*args, tact))
    gsc = _t(c.g, device=cuda_device)
    first = ell_max_bwd(*args, key_max, gsc, tact)
    second = ell_max_bwd(*args, key_max, gsc, tact)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
