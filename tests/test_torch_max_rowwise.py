"""The max aggregation with a row-wise sigma, against the JAX package's.

* the plain versions of #9-#11 (``ell_max_fwd``, ``ell_max_wincount``,
  ``ell_max_bwd``) with centered_relu and softmax against the Pallas
  kernels ``bucket_max_gemm_fwd``, ``bucket_max_wincount`` and
  ``bucket_max_gemm_bwd`` (sigma over the row, ``jax.vjp`` of it) in
  interpret mode, bucket by bucket: zero-scale slots, a row with no valid
  slot, budgets that are not multiples of 8, the hub stage 2, exact ties,
  O != H, the partial last row tile of every bucket, H = 24, 300 and 520,
  f32 and bf16;
* ``sir_aggregate(..., "max")`` with centered_relu and softmax, and with
  erf-GELU and tanh declared non-elementwise (``sir_elementwise=False``,
  which the max kernels take by their id, as JAX's max route does), under
  a DropEdge mask or not: out and the gradients of eq, ek, W and b against
  ``make_ell_sir_aggregate_max_pallas(interpret=True)`` and the XLA builder
  ``make_ell_sir_aggregate_max``. JAX's Pallas builder pads H to a multiple
  of 128 before sigma, which is exact only for an elementwise sigma, so a
  row-wise sigma is held against it at H = 128 and against the XLA builder
  (the statistic over the H features, as the port takes it) at H = 24;
* ``SIRConv(agg_type="max")`` with centered_relu and softmax against the
  JAX ``SIRConv`` (its CPU route, the XLA builder) through the weight
  bridge: out, every gradient, one AdamW step;
* which kernels the max route reaches for every registry sigma.

Tolerances are the JAX suite's: forward atol 2e-4 / rtol 1e-4, gradients
atol 3e-4 / rtol 1e-3; a per-slot g_z stored in bf16, and the ek gradient
that sums it, at one bf16 step (rtol 2^-7); win counts exactly.

The ``cuda`` tests hold the row-wise forms against their plain versions
on the card (rows longer than a tile, W beyond shared memory, H = 300 and
520; near-tie keys and centered_relu's near gates left out, as
chip_smoke.py leaves them), each slot's m to the same bits in any
tiling, #10's counts to cover every key's max, two launches of #11 to
the same bits, and erf-GELU declared non-elementwise to erf-GELU's bits;
they skip where there is no card (``pytest -m cuda --noconftest
tests/test_torch_max_rowwise.py``). JAX is imported inside the tests that
use it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sir_gcn_tpu_torch.ops.ell as tell
import sir_gcn_tpu_torch.ops.message_passing as tmp
from sir_gcn_tpu_torch.ops.cuda import (
    LAUNCHES,
    ell_max_bwd,
    ell_max_fwd,
    ell_max_layout,
    ell_max_wincount,
    reset_launch_counts,
)
from sir_gcn_tpu_torch.ops.cuda import kernels as tk

try:
    import test_torch_max_edge as base
except ImportError:  # imported as a package module
    from tests import test_torch_max_edge as base

FWD_TOL, BWD_TOL, BF16_STEP = base.FWD_TOL, base.BWD_TOL, base.BF16_STEP
DTYPES = base.DTYPES
# the port's sigma by name: the row-wise entries, and erf-GELU and tanh
# declared non-elementwise
ACTS = {"centered_relu": base.ACTS["centered_relu"],
        "softmax": base.ACTS["softmax"],
        "gelu_forced": dataclasses.replace(tell.gelu(),
                                           sir_elementwise=False),
        "tanh_forced": dataclasses.replace(tell.tanh, sir_elementwise=False)}


def jax_act(name: str):
    fn = base.jax_act(name.replace("_forced", ""))
    if name.endswith("_forced"):
        wrapped = lambda z: fn(z)  # noqa: E731  (a fresh function)
        wrapped.sir_elementwise = False
        return wrapped
    return fn


def _args(c, tdt, device="cpu"):
    return base._args(c, tdt, device)[0]


# ----------------------------------------------------------------------
# The plain row-wise forms against the Pallas kernels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("graph,h,o,act,dt", [
    ("random", 24, 40, "centered_relu", "f32"),
    ("random", 24, 40, "softmax", "bf16"),
    ("hub", 16, 16, "softmax", "f32"),
    ("hub", 16, 16, "centered_relu", "bf16"),
    ("ties", 32, 24, "centered_relu", "f32"),
    ("ties", 32, 24, "softmax", "bf16"),
    ("isolated", 300, 24, "centered_relu", "bf16"),
    ("random", 520, 16, "softmax", "f32"),
    ("isolated", 520, 12, "centered_relu", "f32"),
])
def test_max_rowwise_plains_match_pallas(graph, h, o, act, dt):
    c = base.make_case(graph, h, o, seed=1)
    tact, tdt = ACTS[act], DTYPES[dt]
    args = _args(c, tdt)
    rows_j, key_max_j, counts_j, geq_j, gz_j, gw_j = base._pallas_rows(
        c, act, dt, edge=False)

    got = ell_max_fwd(*args, tact)
    np.testing.assert_allclose(got.numpy(), rows_j, **FWD_TOL)
    if graph != "ties":
        assert (got.numpy() == np.finfo(np.float32).min).any()  # empty row
    key_max = c.fg.dst_plan.finalize_rows_max(got)
    np.testing.assert_allclose(key_max.numpy(), key_max_j.numpy(), **FWD_TOL)

    counts = ell_max_wincount(*args, key_max, tact)
    np.testing.assert_array_equal(counts.numpy(), counts_j)
    if graph == "ties":
        assert counts.max() >= 2

    geq, gz, gw = ell_max_bwd(*args, key_max, base._t(c.g), tact)
    assert gz.dtype == tdt
    np.testing.assert_allclose(geq.numpy(), geq_j, **BWD_TOL)
    np.testing.assert_allclose(gz.float().numpy(), gz_j,
                               **(BF16_STEP if dt == "bf16" else BWD_TOL))
    np.testing.assert_allclose(gw.numpy(), gw_j, **BWD_TOL)


# ----------------------------------------------------------------------
# The aggregate and its gradients
# ----------------------------------------------------------------------

def _port(c, act, dt, mask):
    tmp.set_edge_dtype(DTYPES[dt] if dt == "bf16" else None)
    try:
        ts = [base._t(a).requires_grad_() for a in (c.eq, c.ek, c.w, c.b)]
        out = tmp.sir_aggregate(
            c.fg, ts[0], ts[1], ACTS[act], "max", w_relation=ts[2],
            b_relation=ts[3],
            edge_mask=None if mask is None else torch.from_numpy(mask))
        (out * base._t(c.g)).sum().backward()
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
    e0 = jnp.zeros((0,), jnp.float32)
    args = [jnp.asarray(a) for a in (c.eq, c.ek, c.w, c.b)]

    def loss(eq, ek, w, b):
        return jnp.sum(f(eq, ek, e0, v, w, b) * jnp.asarray(c.g))

    out = f(args[0], args[1], e0, v, args[2], args[3])
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("graph,h,o,act,dt,dropedge,oracle", [
    ("random", 24, 40, "centered_relu", "f32", True, "xla"),
    ("hub", 24, 16, "softmax", "f32", False, "xla"),
    ("ties", 32, 24, "centered_relu", "f32", False, "xla"),
    ("random", 128, 24, "centered_relu", "f32", True, "pallas"),
    ("random", 128, 40, "softmax", "bf16", False, "pallas"),
    ("isolated", 24, 8, "gelu_forced", "f32", True, "pallas"),
    ("random", 24, 40, "tanh_forced", "bf16", True, "pallas"),
])
def test_max_rowwise_aggregate_matches_jax(graph, h, o, act, dt, dropedge,
                                           oracle):
    import sir_gcn_tpu.ops.ell as jell

    c = base.make_case(graph, h, o, seed=8, with_jax=True)
    mask = c.mask if dropedge else None
    got = _port(c, act, dt, mask)
    if oracle == "pallas":
        f = jell.make_ell_sir_aggregate_max_pallas(
            c.jfg, jax_act(act), interpret=True,
            edge_dtype=base.jax_dtype(dt))
    else:  # the XLA builder computes in f32
        assert dt == "f32"
        f = jell.make_ell_sir_aggregate_max(c.jfg, jax_act(act))
    want = _jax(c, f, mask)
    for name, a, b in zip(("out", "eq", "ek", "w", "b"), got, want):
        tol = FWD_TOL if name == "out" else BWD_TOL
        if dt == "bf16" and name == "ek":
            tol = BF16_STEP  # sums of the bf16 g_z
        np.testing.assert_allclose(a, b, **tol, err_msg=name)
    if graph == "isolated":  # nodes without an in-edge are zero-filled
        assert (got[0][40:] == 0).all()


def test_diagonal_sigma_declared_general_takes_its_elementwise_forms():
    """erf-GELU and tanh declared non-elementwise take the max kernels'
    elementwise forms (the kernels take sigma by its id): the same bits as
    the undeclared entries, out and every gradient."""
    c = base.make_case("hub", 24, 16, seed=4)
    for name, plain in (("gelu_forced", tell.gelu()),
                        ("tanh_forced", tell.tanh)):
        forced = ACTS[name]
        assert not forced.elementwise and forced.diagonal
        runs = []
        for act in (forced, plain):
            ts = [base._t(a).requires_grad_()
                  for a in (c.eq, c.ek, c.w, c.b)]
            out = tmp.sir_aggregate(c.fg, ts[0], ts[1], act, "max",
                                    w_relation=ts[2], b_relation=ts[3])
            (out * base._t(c.g)).sum().backward()
            runs.append([out.detach()] + [t.grad for t in ts])
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.fixture
def kernel_calls(monkeypatch):
    calls = []
    for name in ("ell_max_fwd_plain", "ell_max_wincount_plain",
                 "ell_max_bwd_plain", "ell_scaled_reduce_plain",
                 "ell_act_reduce_plain", "ell_geq_reduce_plain",
                 "ell_src_bwd_plain"):
        fn = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n[:-6]), _f(*a, **k))[1])
    return calls


@pytest.mark.parametrize("act", sorted(ACTS))
def test_max_route_takes_every_registry_sigma(kernel_calls, act):
    """Max with any registry sigma runs #9-#12 and nothing else; on the
    CPU their plain versions, with no launch."""
    c = base.make_case("random", 24, 40)
    reset_launch_counts()
    ts = [base._t(a).requires_grad_() for a in (c.eq, c.ek, c.w)]
    tmp.sir_aggregate(c.fg, ts[0], ts[1], ACTS[act], "max",
                      w_relation=ts[2]).sum().backward()
    assert kernel_calls == ["ell_max_fwd", "ell_max_wincount", "ell_max_bwd",
                            "ell_scaled_reduce"]
    assert all(v == 0 for v in LAUNCHES.values())


# ----------------------------------------------------------------------
# SIRConv with max and a row-wise sigma
# ----------------------------------------------------------------------

@pytest.mark.parametrize("act", ["centered_relu", "softmax"])
def test_sirconv_max_rowwise_matches_jax(act):
    """``SIRConv(agg_type="max")`` with a row-wise sigma against the JAX
    ``SIRConv``: out, the input's gradient and every parameter's, then one
    AdamW step."""
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.models.conv import SIRConv as JSIRConv
    from sir_gcn_tpu.train import make_adamw as j_make_adamw

    from sir_gcn_tpu_torch.models import SIRConv
    from sir_gcn_tpu_torch.train import make_adamw
    from sir_gcn_tpu_torch.utils import load_jax_variables
    from sir_gcn_tpu_torch.utils.convert import _slots

    h, o, lr, wd = 16, 12, 1e-2, 1e-3
    c = base.make_case("hub", h, o, seed=14, with_jax=True)
    rng = np.random.default_rng(15)
    x = rng.normal(size=(c.fg.n_pad, 10)).astype(np.float32)
    w = rng.normal(size=(c.fg.n_pad, o)).astype(np.float32)
    jconv = JSIRConv(hidden_dim=h, output_dim=o, activation=jax_act(act),
                     agg_type="max")
    variables = jax.tree_util.tree_map(np.asarray, jconv.init(
        jax.random.PRNGKey(4), c.jfg, jnp.asarray(x)))
    conv = SIRConv(10, h, o, ACTS[act], agg_type="max")
    load_jax_variables(conv, variables)
    slots = _slots(conv)
    assert ("params", "relation_kernel") in slots

    tx = base._t(x).requires_grad_()
    out = conv(c.fg, tx)
    (out * base._t(w)).sum().backward()

    def loss(p, xx):
        y = jconv.apply(p, c.jfg, xx, deterministic=True)
        return jnp.sum(y * w), y

    (_, jout), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        variables, jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **BWD_TOL)
    grads = base._flat(gp)
    assert set(grads) == set(slots)
    for key, g in grads.items():
        tensor, transpose = slots[key]
        have = tensor.grad.numpy()
        np.testing.assert_allclose(have.T if transpose else have, g,
                                   **BWD_TOL, err_msg="/".join(key))

    make_adamw(conv.parameters(), lr, wd).step()
    tx_j = j_make_adamw(lr, wd)
    updates, _ = tx_j.update(gp, tx_j.init(variables), variables)
    new = base._flat(jax.tree_util.tree_map(lambda p, u: p + u, variables,
                                            updates))
    for key, p in new.items():
        tensor, transpose = slots[key]
        have = tensor.detach().numpy()
        have = have.T if transpose else have
        keep = np.abs(grads[key]) >= 1e-6
        np.testing.assert_allclose(have[keep], p[keep], **FWD_TOL,
                                   err_msg="/".join(key))


# ----------------------------------------------------------------------
# On the card: the row-wise forms against their plain versions
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", ["centered_relu", "softmax"])
@pytest.mark.parametrize("graph,h,o", base.CARD_CASES + [
    ("hub", 300, 24), ("random", 520, 520), ("isolated", 513, 40)])
def test_max_rowwise_kernels_match_plain_on_card(cuda_device, graph, h, o,
                                                 act, dt):
    """Every shape on the tensor-core path, with the statistic over H:
    rows longer than a tile, W beyond shared memory (200 x 200, 520 x
    520), H and O off multiples of 8 (36 x 100, 513 x 40)."""
    c = base.make_case(graph, h, o, device=cuda_device)
    d, tact = cuda_device, ACTS[act]
    args = _args(c, DTYPES[dt], d)
    plan = c.fg.dst_plan
    # no cotangent at near-tie keys, where the two may pick other winners
    near = base.near_ties(c.fg, args, tact)
    gsc = torch.where(near, 0.0, base._t(c.g, device=d))
    assert ell_max_layout(h, o).path == "tensor"
    reset_launch_counts()
    rows = ell_max_fwd(*args, tact)
    key_max = plan.finalize_rows_max(rows)
    counts = ell_max_wincount(*args, key_max, tact)
    geq, gz, gw = ell_max_bwd(*args, key_max, gsc, tact)
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {
        "ell_max_fwd": 1, "ell_max_wincount": 1, "ell_max_bwd": 1}

    rows_p = tk.ell_max_fwd_plain(*args, tact)
    key_max_p = plan.finalize_rows_max(rows_p)
    torch.testing.assert_close(rows, rows_p, **FWD_TOL)
    base.assert_counts_equal(
        counts, tk.ell_max_wincount_plain(*args, key_max_p, tact), c.fg,
        near)
    base.assert_bwd_close(
        (geq, gz, gw), tk.ell_max_bwd_plain(*args, key_max_p, gsc, tact),
        dt, base.near_gate_keep(c.fg, args, tact))


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["centered_relu", "softmax"])
@pytest.mark.parametrize("graph,h,o", [("random", 96, 96), ("hub256", 24, 40),
                                       ("random", 520, 520)])
def test_max_rowwise_products_have_the_same_bits_in_any_tiling(
        cuda_device, graph, h, o, act):
    """A slot's a (and so m) is formed alike in the full plan's tiles and
    alone in a plan of one-slot rows: the row maxima and the win counts of
    the full plan are those of the one-slot products, bit for bit."""
    c = base.make_case(graph, h, o, device=cuda_device)
    tact = ACTS[act]
    eq, ek, slot_src, scale, row_key, row_ptr, w = args = _args(
        c, torch.bfloat16, cuda_device)
    plan = c.fg.dst_plan
    rows = ell_max_fwd(*args, tact)
    key_max = plan.finalize_rows_max(rows)
    counts = ell_max_wincount(*args, key_max, tact)
    vs = (scale > 0).nonzero().flatten()
    row = torch.searchsorted(row_ptr[1:].long(), vs, right=True)
    one = ell_max_fwd(
        eq, ek, slot_src[vs].contiguous(),
        torch.ones(vs.numel(), device=cuda_device),
        row_key[row].contiguous(),
        torch.arange(vs.numel() + 1, dtype=torch.int32, device=cuda_device),
        w, tact)
    want = torch.full_like(rows, float(np.finfo(np.float32).min))
    want.scatter_reduce_(0, row[:, None].expand(-1, o), one, "amax")
    assert torch.equal(rows, want)
    wins = (one == key_max.index_select(0, row_key)[row]).float()
    assert torch.equal(counts, torch.zeros_like(counts).index_add_(0, row,
                                                                   wins))


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["centered_relu", "softmax"])
@pytest.mark.parametrize("graph,h,o", [("random", 96, 96), ("hub", 24, 40),
                                       ("random", 520, 520)])
def test_max_rowwise_win_counts_cover_every_key_max_on_card(
        cuda_device, graph, h, o, act):
    """Summed over a key's rows, #10 counts at least one winner at every
    (key, o) of a key with a valid slot: #9 and #10 agree bit for bit."""
    c = base.make_case(graph, h, o, device=cuda_device)
    tact = ACTS[act]
    args = _args(c, torch.float32, cuda_device)
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
@pytest.mark.parametrize("act", ["centered_relu", "softmax"])
@pytest.mark.parametrize("graph,h,o", [("random", 96, 96),
                                       ("random", 520, 520),
                                       ("hub256", 24, 40)])
def test_max_rowwise_bwd_is_bitwise_repeatable_on_card(cuda_device, graph, h,
                                                       o, act):
    """Two launches of #11 with a row-wise sigma give the same bits."""
    c = base.make_case(graph, h, o, device=cuda_device)
    tact = ACTS[act]
    args = _args(c, torch.bfloat16, cuda_device)
    key_max = c.fg.dst_plan.finalize_rows_max(ell_max_fwd(*args, tact))
    gsc = base._t(c.g, device=cuda_device)
    first = ell_max_bwd(*args, key_max, gsc, tact)
    second = ell_max_bwd(*args, key_max, gsc, tact)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_forced_gelu_takes_gelus_bits_on_card(cuda_device, dt):
    """erf-GELU declared non-elementwise launches erf-GELU's forms of #9,
    #10 and #11: the same bits."""
    c = base.make_case("random", 96, 96, device=cuda_device)
    args = _args(c, DTYPES[dt], cuda_device)
    gsc = base._t(c.g, device=cuda_device)
    runs = []
    for act in (ACTS["gelu_forced"], tell.gelu()):
        key_max = c.fg.dst_plan.finalize_rows_max(ell_max_fwd(*args, act))
        runs.append((key_max, ell_max_wincount(*args, key_max, act),
                     *ell_max_bwd(*args, key_max, gsc, act)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
