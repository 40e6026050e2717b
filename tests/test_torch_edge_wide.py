"""#7 and #8 past a block's shared memory: the fused edge route at any De
and H, against the JAX package's.

JAX's fused edge route takes every De and H (its Pallas kernels hold W_E
and the g_WE accumulator whole in VMEM). The port's kernels take the
shapes whose W_E, or in #8 whose W_E and eight warps' g_WE partials, pass
a block's shared memory on their columns path (chunks of W_E's columns a
block, or W_E and the partials in device memory). Covered here, on the
CPU, at (H, De) = (512, 16), (160, 48), (100, 600), (40, 1024) and the odd
(56, 301):

* the plain versions of ``ell_edge_act_reduce2`` and ``ell_edge_src_bwd``
  against ``bucket_edge_act_reduce2`` / ``bucket_edge_src_bwd`` in
  interpret mode, bucket by bucket;
* ``sir_aggregate(e_basis=, w_edge=)`` against the JAX package's
  ``sir_aggregate`` on its fused edge route
  (``make_ell_sir_aggregate_pallas_fused_edge(interpret=True)``): sum,
  mean and sym, static and DropEdge scales, f32 and bf16 edges,
  leaky_relu, tanh and erf-GELU; out, g_eq, g_ek and g_WE;
* a 512-wide ``SIREConv`` (512 -> 512, De = 16, sym, leaky_relu(0.2))
  against the JAX ``SIREConv`` through the weight bridge: out, every
  gradient, then one AdamW step.

Tolerances are the JAX suite's: forward atol 2e-4 / rtol 1e-4, gradients
atol 3e-4 / rtol 1e-3; g_WE, a sum over every slot, at atol 3e-4 plus
1e-5 of its largest entry. JAX is imported inside the tests.

The ``cuda`` tests hold the columns path against the plain versions on
awkward plans (a part-full last row tile, zero-scale slots, budgets off
multiples of 8, a basis off 16-byte alignment, bf16), ask two launches for
the same bits, and check that the layout names the columns path exactly
where the shared-memory path ends; they skip where there is no card
(``pytest -m cuda --noconftest tests/test_torch_edge_wide.py``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sir_gcn_tpu_torch.ops.ell as tell
import sir_gcn_tpu_torch.ops.message_passing as tmp
from sir_gcn_tpu_torch import build_graph
from sir_gcn_tpu_torch.ops.cuda import (
    LAUNCHES,
    ell_edge_act_reduce2,
    ell_edge_act_reduce2_plain,
    ell_edge_layout,
    ell_edge_src_bwd,
    ell_edge_src_bwd_plain,
    reset_launch_counts,
)

# the edge suite's helpers: pytest puts this directory on sys.path; an
# import of this file as tests.test_torch_edge_wide does not
if str(Path(__file__).resolve().parent) not in sys.path:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_edge import (  # noqa: E402
    BWD_TOL,
    DTYPES,
    FWD_TOL,
    _t,
    check_fused_plains,
    fused_args,
    gw_tol,
    make_case,
)

ACTS = {"leaky_relu": tell.leaky_relu(0.2), "tanh": tell.tanh,
        "gelu": tell.gelu()}
# a block's dynamic shared memory on an H100 (csrc/ell_edge_kernels.cu's
# kMaxSmem), the warps of the shared-memory loop, and the widest chunk
SMEM, WARPS, CHUNK = 232448 - 1024, 8, 128


def jax_act(act: str):
    import jax
    import jax.numpy as jnp

    return {"leaky_relu": lambda z: jax.nn.leaky_relu(z, 0.2),
            "tanh": jnp.tanh,
            "gelu": lambda z: jax.nn.gelu(z, approximate=False)}[act]


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX package's routes as on its accelerator (``pallas_available``
    True, the fused-edge factory in interpret mode); the list of the
    factory's calls, to show that JAX took the fused route."""
    import sir_gcn_tpu.ops.ell as jell
    import sir_gcn_tpu.ops.pallas as jpallas

    calls = []
    factory = jell.make_ell_sir_aggregate_pallas_fused_edge

    def fused(*a, **k):
        calls.append(a[2])
        return factory(*a, **{**k, "interpret": True})

    monkeypatch.setattr(jpallas, "pallas_available", lambda: True)
    monkeypatch.setattr(jell, "make_ell_sir_aggregate_pallas_fused_edge",
                        fused)
    return calls


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
# The plain versions against the Pallas kernels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("graph,h,de,dt,act", [
    ("random", 512, 16, "bf16", "leaky_relu"),
    ("hub", 160, 48, "f32", "tanh"),
    ("random", 100, 600, "bf16", "gelu"),
    ("isolated", 40, 1024, "f32", "leaky_relu"),
    ("random", 56, 301, "bf16", "tanh"),
])
def test_wide_fused_plains_match_pallas(graph, h, de, dt, act):
    check_fused_plains(make_case(graph, de=de, h=h, seed=de), dt, act,
                       ACTS[act])


# ----------------------------------------------------------------------
# sir_aggregate's fused route against JAX's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("graph,h,de,agg,dt,act,drop", [
    ("random", 512, 16, "sym", "bf16", "leaky_relu", False),
    ("hub", 512, 16, "mean", "f32", "gelu", True),
    ("random", 160, 48, "sum", "bf16", "tanh", True),
    ("random", 100, 600, "sym", "f32", "tanh", False),
    ("hub", 100, 600, "mean", "bf16", "leaky_relu", True),
    ("isolated", 40, 1024, "mean", "f32", "gelu", False),
    ("random", 56, 301, "sym", "bf16", "gelu", True),
])
def test_wide_fused_route_matches_jax(graph, h, de, agg, dt, act, drop,
                                      jax_fused, edge_dtype):
    import jax
    import jax.numpy as jnp
    import sir_gcn_tpu.ops.message_passing as jmp

    edge_dtype(dt)
    c = make_case(graph, de=de, h=h, seed=h + de)
    rng = np.random.default_rng(de)
    w = rng.normal(size=c.eq.shape).astype(np.float32)
    mask = rng.random(c.tfg.e_pad) >= 0.3 if drop else None

    ts = [_t(a).requires_grad_() for a in (c.eq, c.ek, c.we)]
    out = tmp.sir_aggregate(
        c.tfg, ts[0], ts[1], ACTS[act], agg, e_basis=_t(c.eb),
        w_edge=ts[2],
        edge_mask=None if mask is None else torch.from_numpy(mask))
    (out * _t(w)).sum().backward()

    eb, jmask = jnp.asarray(c.eb), None if mask is None else jnp.asarray(mask)

    def loss(eq, ek, we):
        y = jmp.sir_aggregate(c.jfg, eq, ek, jax_act(act), agg, e_basis=eb,
                              w_edge=we, edge_mask=jmask)
        return jnp.sum(y * w), y

    # eagerly: under jit XLA rounds bf16 at other points than the kernels
    (_, jout), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True)(c.eq, c.ek, c.we)
    assert jax_fused == [agg]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    for name, t, want in zip(("eq", "ek"), ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   **BWD_TOL, err_msg=name)
    want = np.asarray(grads[2])
    np.testing.assert_allclose(ts[2].grad.numpy(), want, **gw_tol(want),
                               err_msg="we")


# ----------------------------------------------------------------------
# A 512-wide SIREConv through the weight bridge
# ----------------------------------------------------------------------

def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items")
                   else {prefix + (k,): np.asarray(v)})
    return out


def test_wide_sireconv_matches_jax_and_steps(jax_fused):
    """SIREConv 512 -> 512, De = 16, sym, leaky_relu(0.2): the
    heterophilous default width with bench lane (d)'s basis. Out, the
    input's gradient and every parameter's (W_E's too) against the JAX
    SIREConv on its fused route, then one AdamW step; Adam's first step is
    about lr * sign(g), so entries with |g| < 1e-6 are left out. f32
    edges: in bf16 the aggregate's cotangent, which the two frameworks'
    output layers round differently in its last f32 bits, may round to
    neighbouring bf16 values, and W_K's gradient sums those steps over
    nodes."""
    import jax
    import jax.numpy as jnp
    from sir_gcn_tpu.models.conv import SIREConv as JSIREConv
    from sir_gcn_tpu.train import make_adamw as j_make_adamw

    from sir_gcn_tpu_torch.models import SIREConv
    from sir_gcn_tpu_torch.train import make_adamw
    from sir_gcn_tpu_torch.utils import load_jax_variables
    from sir_gcn_tpu_torch.utils.convert import _slots

    h, de, lr, wd = 512, 16, 1e-3, 1e-2
    c = make_case("random", de=de, h=8, seed=21)
    rng = np.random.default_rng(22)
    x = rng.normal(size=(c.tfg.n_pad, h)).astype(np.float32)
    ef = rng.normal(size=(c.tfg.graph.num_edges, de)).astype(np.float32)
    w = rng.normal(size=(c.tfg.n_pad, h)).astype(np.float32)
    jconv = JSIREConv(hidden_dim=h, output_dim=h,
                      activation=jax_act("leaky_relu"), agg_type="sym")
    variables = jax.tree_util.tree_map(np.asarray, jconv.init(
        jax.random.PRNGKey(5), c.jfg, jnp.asarray(x), jnp.asarray(ef)))
    jax_fused.clear()  # init ran the layer once
    conv = SIREConv(h, de, h, h, ACTS["leaky_relu"], agg_type="sym")
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
    assert jax_fused == ["sym"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **BWD_TOL)
    grads = _flat(gp)
    assert set(grads) == set(slots)
    for key, g in grads.items():
        tensor, transpose = slots[key]
        have = tensor.grad.numpy()
        tol = gw_tol(g) if "linear_edge" in key else BWD_TOL
        np.testing.assert_allclose(have.T if transpose else have, g, **tol,
                                   err_msg="/".join(key))

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
# On the card: the columns path against the plain versions
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def shared_paths(h: int, de: int) -> tuple:
    """The paths #7 and #8 took before the columns path: registers for H
    <= 128 and De <= 16 (in the backward only while ceil(H / 32) features
    a lane times De padded to 8 or 16 stay <= 48), the shared-memory loop
    while its tables fit a block's shared memory, else None (they
    raised)."""
    regs = h <= 128 and de <= 16
    nf, db = min(-(-h // 32), 4), 8 if de <= 8 else 16
    fwd = "registers" if regs else "shared" if 4 * de * h <= SMEM else None
    bwd = ("registers" if regs and nf * db <= 48 else
           "shared" if 4 * (1 + WARPS) * de * h <= SMEM else None)
    return fwd, bwd


def wide_paths(h: int, de: int) -> tuple:
    """The paths the entries take: ``shared_paths`` where those ran, else
    the columns path, but #8 with De <= 16 the tiles path."""
    fwd, bwd = shared_paths(h, de)
    return (fwd or "columns",
            bwd or ("tiles" if de <= 16 else "columns"))


def check_chunk(h: int, de: int, tables: int, chunk: int,
                device: bool) -> None:
    """A columns-path chunk: a multiple of 32 of at most 128, spread over
    the chunks H needs; its ``tables`` [De, chunk] f32 tables fit a
    block's shared memory unless they stay in device memory, which they
    do exactly where not even 32 columns' tables fit."""
    assert chunk % 32 == 0 and 32 <= chunk <= CHUNK, chunk
    assert device == (4 * tables * de * 32 > SMEM)
    if not device:
        assert 4 * tables * de * chunk <= SMEM
    n = -(-h // chunk)
    assert chunk - 32 < -(-h // n) <= chunk  # the chunks are even


def awkward_graph(device):
    """Plans with odd row counts on both sides (a part-full last tile of
    rows), rows of 40 to 104 slots (several 32-slot chunks) and budgets
    off multiples of 8 (10, 12, 28)."""
    rng = np.random.default_rng(0)
    n = 70
    dst = np.concatenate([np.repeat([0, 1, 2, 3], [100, 37, 27, 45]),
                          rng.integers(4, n, 260)])
    src = rng.integers(0, n, dst.size)
    src[rng.permutation(dst.size)[:110]] = np.repeat([5, 6], [70, 40])
    fg = tell.build_fast_graph(build_graph(src, dst, n, device=device),
                               max_budget=256)
    for plan in (fg.dst_plan, fg.src_plan):
        budgets = set(np.diff(plan.row_ptr.cpu().numpy()).tolist())
        assert plan.num_rows % 2 == 1
        assert max(budgets) > 32 and {b % 8 for b in budgets} - {0}
    return fg


# (H, De): the backward past shared memory (512, 16; 160, 48), both
# (100, 600), the backward's tables in device memory (40, 1024; 56, 301 at
# an odd De), and the forward's too (40, 2000)
CARD_SHAPES = [(512, 16), (160, 48), (100, 600), (40, 1024), (56, 301),
               (40, 2000)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("h,de", CARD_SHAPES)
def test_columns_path_matches_plain_on_card(cuda_device, h, de, dt):
    """#7 and #8 against their plain versions on the awkward plans, with a
    fifth of the scales zeroed, all three sigmas, and a basis 4 bytes past
    a 16-byte boundary; one launch each, on the path the layout names."""
    d = cuda_device
    fg = awkward_graph(d)
    rng = np.random.default_rng(h + de)
    eq, ek, g = (_t(rng.normal(size=(fg.n_pad, h)), device=d)
                 for _ in range(3))
    basis = _t(rng.normal(size=(fg.e_pad, de)), device=d)
    eb = torch.empty(fg.e_pad * de + 1, device=d)[1:].view(fg.e_pad, de)
    eb.copy_(basis)
    we = _t(rng.normal(size=(de, h)) * de ** -0.5, device=d)
    sd, ss = (getattr(fg, f"{side}_slot_scales")["sym"] * _t(
        rng.random(getattr(fg, f"{side}_plan").num_slots) > 0.2, device=d)
        for side in ("dst", "src"))
    assert bool((sd == 0).any()) and bool((ss == 0).any())
    for act in ACTS.values():
        fwd, bwd = fused_args(fg, eq, ek, g, eb, we, sd, ss, act, DTYPES[dt])
        reset_launch_counts()
        got = ell_edge_act_reduce2(*fwd) + ell_edge_src_bwd(*bwd)
        torch.cuda.synchronize()
        assert {k: v for k, v in LAUNCHES.items() if v} == {
            "ell_edge_act_reduce2": 1, "ell_edge_src_bwd": 1}
        want = ell_edge_act_reduce2_plain(*fwd) + ell_edge_src_bwd_plain(*bwd)
        for a, b, tol in zip(got, want, (FWD_TOL, FWD_TOL, BWD_TOL)):
            torch.testing.assert_close(a, b, **tol)
        torch.testing.assert_close(got[3], want[3],
                                   **gw_tol(want[3].cpu().numpy()))
        lay = ell_edge_layout(h, de, act, DTYPES[dt])
        assert (lay.fwd, lay.bwd) == wide_paths(h, de), lay
        assert lay.bwd == ("tiles" if de <= 16 else "columns"), lay


@pytest.mark.cuda
@pytest.mark.parametrize("h,de,dt,act", [
    (512, 16, "bf16", "leaky_relu"), (100, 600, "f32", "tanh"),
    (40, 2000, "bf16", "gelu")])
def test_columns_path_is_bitwise_repeatable_on_card(cuda_device, h, de, dt,
                                                    act):
    """Two launches of #7 and #8 on the columns path give bitwise equal
    rows, srows, g_ek rows and g_WE, with the partials in shared memory
    (512, 16) and in device memory (the others): each sum's order is fixed
    by the grid, with no atomics. A graph of 4,000 nodes and 40,000 edges
    fills many blocks."""
    rng = np.random.default_rng(7)
    n, e, d = 4000, 40000, cuda_device
    fg = tell.build_fast_graph(
        build_graph(rng.integers(0, n, e), rng.integers(0, n, e), n,
                    device=d), max_budget=64)
    eq, ek, g = (_t(rng.normal(size=(fg.n_pad, h)), device=d)
                 for _ in range(3))
    eb = _t(rng.normal(size=(fg.e_pad, de)), device=d)
    we = _t(rng.normal(size=(de, h)) * de ** -0.5, device=d)
    fwd, bwd = fused_args(fg, eq, ek, g, eb, we, fg.dst_slot_scales["sym"],
                          fg.src_slot_scales["sym"], ACTS[act], DTYPES[dt])
    first = ell_edge_act_reduce2(*fwd) + ell_edge_src_bwd(*bwd)
    second = ell_edge_act_reduce2(*fwd) + ell_edge_src_bwd(*bwd)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert ell_edge_layout(h, de, ACTS[act], DTYPES[dt]).bwd == wide_paths(
        h, de)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("act", sorted(ACTS))
def test_layout_takes_columns_where_shared_memory_ends_on_card(cuda_device,
                                                               act):
    """Over widths on both sides of each limit, for both edge types: the
    register and shared paths exactly where they were chosen before, the
    columns path exactly where the kernels raised, with its chunk, but #8
    with De <= 16 on the tiles path (chunks of 128 columns, its basis
    padded to 8 or 16, 8 slots a batch in bf16 and 4 in f32)."""
    del cuda_device
    for dt in DTYPES.values():
        for h in (1, 20, 96, 128, 129, 200, 256, 512, 1000, 4096):
            for de in (1, 5, 16, 17, 48, 60, 200, 201, 500, 1024, 1808,
                       1809, 4000):
                lay = ell_edge_layout(h, de, ACTS[act], dt)
                assert (lay.fwd, lay.bwd) == wide_paths(h, de), (h, de, lay)
                for side, tables in (("fwd", 1), ("bwd", 1 + WARPS)):
                    chunk = getattr(lay, f"{side}_chunk")
                    device = getattr(lay, f"{side}_device")
                    if getattr(lay, side) == "columns":
                        check_chunk(h, de, tables, chunk, device)
                    elif getattr(lay, side) == "tiles":
                        assert (chunk, device) == (CHUNK, False), lay
                        assert lay.basis_width == (8 if de <= 8 else 16)
                        assert lay.bwd_inflight == (
                            8 if dt == torch.bfloat16 else 4), lay
                    else:
                        assert (chunk, device) == (0, False), (h, de, lay)


# The tiles path (#8 past a block's shared memory with De <= 16), (H, De):
# four chunks of 128 columns (512, 16); a last chunk of 8 columns (520,
# 16); De padded to 8 (1000, 8); an odd De, whose basis rows are copied 4
# bytes at a time, and a last chunk of 92 columns (1500, 5); H not a
# multiple of 4, whose rows take single-value loads, and a last chunk of 90
# columns (602, 12)
TILES_SHAPES = [(512, 16), (520, 16), (1000, 8), (1500, 5), (602, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("h,de", TILES_SHAPES)
def test_tiles_path_matches_plain_on_card(cuda_device, h, de, dt):
    """#8 on the tiles path against its plain version on the awkward plans
    (a part-full last row tile, rows of several 32-slot runs, budgets off
    multiples of 8), with a fifth of the scales zeroed and a multi-slot row
    with no valid slot, all three sigmas, the basis 4 bytes past a 16-byte
    boundary, and at 512 eq, g and ek too (the single-value loads): g_ek
    rows at BWD_TOL, g_WE at atol 3e-4 plus 1e-5 of its largest entry; two
    launches give the same bits; the layout names the tiles path."""
    d = cuda_device
    fg = awkward_graph(d)
    rng = np.random.default_rng(h + de)
    splan = fg.src_plan
    eq, ek, g = (_t(rng.normal(size=(fg.n_pad, h)), device=d)
                 for _ in range(3))
    eb = torch.empty(fg.e_pad * de + 1, device=d)[1:].view(fg.e_pad, de)
    eb.copy_(_t(rng.normal(size=(fg.e_pad, de)), device=d))
    we = _t(rng.normal(size=(de, h)) * de ** -0.5, device=d)
    ss = fg.src_slot_scales["sym"] * _t(
        rng.random(splan.num_slots) > 0.2, device=d)
    ptr = splan.row_ptr.cpu().numpy()
    r = int(np.argmax(np.diff(ptr) >= 8))  # a row of 8 or more slots
    ss[int(ptr[r]):int(ptr[r + 1])] = 0.0
    tables = [(eq, g, ek)]
    if h == 512:  # each row 4 bytes past a 16-byte boundary
        tables.append(tuple(
            torch.empty(t.numel() + 1, device=d)[1:].view(t.shape).copy_(t)
            for t in (eq, g, ek)))
    for eq_, g_, ek_ in tables:
        for act in ACTS.values():
            _, bwd = fused_args(fg, eq_, ek_, g_, eb, we,
                                fg.dst_slot_scales["sym"], ss, act,
                                DTYPES[dt])
            reset_launch_counts()
            first, second = ell_edge_src_bwd(*bwd), ell_edge_src_bwd(*bwd)
            torch.cuda.synchronize()
            assert LAUNCHES["ell_edge_src_bwd"] == 2
            want = ell_edge_src_bwd_plain(*bwd)
            torch.testing.assert_close(first[0], want[0], **BWD_TOL)
            torch.testing.assert_close(first[1], want[1],
                                       **gw_tol(want[1].cpu().numpy()))
            for a, b in zip(first, second):
                assert torch.equal(a, b)
            lay = ell_edge_layout(h, de, act, DTYPES[dt])
            assert lay.bwd == "tiles" and lay.bwd_chunk == CHUNK, lay
