"""The three ELL kernels of the port against the JAX package's Pallas
kernels.

On the CPU each wrapper runs its plain PyTorch version; that version is
held against the Pallas kernel run in interpret mode bucket by bucket,
with the buckets' outputs concatenated. Tolerances are the JAX suite's
own (tests/test_pallas_kernels.py): forward atol 2e-4 / rtol 1e-4,
gradients atol 3e-4 / rtol 1e-3. bf16 is rounded at the same points in
both packages, so the same tolerances hold.

The ``cuda`` test compares each kernel with its plain version on the
card and skips where there is none. The JAX package is imported inside
the tests that use it, so that the card's tests run where JAX is not
installed (``pytest -m cuda --noconftest tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

import sir_gcn_tpu_torch.ops.ell as tell
from sir_gcn_tpu_torch import build_graph
from sir_gcn_tpu_torch.ops.cuda import (
    LAUNCHES,
    ell_act_reduce,
    ell_act_reduce2,
    ell_act_reduce_plain,
    ell_layout,
    ell_src_bwd,
    ell_src_bwd_plain,
    reset_launch_counts,
)

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)

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


def make_case(graph: str, h: int, seed: int = 0, device="cpu"):
    """A FastGraph plus node tables and slot scales with extra zeros."""
    rng = np.random.default_rng(seed)
    if graph == "hub":
        n = 40
        src = rng.integers(0, n, 360)
        dst = np.concatenate([np.zeros(300, np.int64),
                              rng.integers(0, n, 60)])
        fg = tell.build_fast_graph(build_graph(src, dst, n, device=device),
                                   max_budget=64)
    else:
        n, e = 40, 203
        fg = tell.build_fast_graph(
            build_graph(rng.integers(0, n, e), rng.integers(0, n, e), n,
                        device=device), max_budget=16)
    eq, ek, g = (rng.normal(size=(fg.n_pad, h)).astype(np.float32)
                 for _ in range(3))
    scales = {}
    for side, plan in (("dst", fg.dst_plan), ("src", fg.src_plan)):
        s = getattr(fg, f"{side}_slot_scales")["sym"].cpu().numpy()
        scales[side] = (s * (rng.random(s.shape) > 0.2)).astype(np.float32)
    return fg, eq, ek, g, scales


def _t(x, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _jax_fwd(kernel, fg, eq, ek, scale, jact, jdt):
    import jax.numpy as jnp
    from sir_gcn_tpu.ops.ell import _bucket_offsets

    plan = fg.dst_plan
    ekg = jnp.take(jnp.asarray(ek).astype(jdt),
                   jnp.asarray(fg.dst_slot_srcnode.cpu().numpy()), axis=0)
    eq_rows = jnp.take(jnp.asarray(eq),
                       jnp.asarray(plan.row_key.cpu().numpy()), axis=0)
    outs = []
    for b, nr, so, ro in _bucket_offsets(plan.buckets1):
        outs.append(kernel(ekg[so:so + b * nr], eq_rows[ro:ro + nr],
                           jnp.asarray(scale[so:so + b * nr]).reshape(nr, b),
                           b, jact, interpret=True))
    return outs


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("graph,h", [("hub", 24), ("random", 96),
                                     ("random", 20)])
def test_act_reduce_plain_matches_pallas(graph, h, act, dt):
    fg, eq, ek, _, scales = make_case(graph, h)
    pallas, jact, jdt = jax_side(act, dt)
    tact, tdt = ACTS[act], DTYPES[dt]
    plan = fg.dst_plan
    args = (_t(eq), _t(ek, tdt), fg.dst_slot_srcnode, _t(scales["dst"]),
            plan.row_key, plan.row_ptr, tact)

    want = np.concatenate([np.asarray(o) for o in _jax_fwd(
        pallas.bucket_bcast_act_reduce, fg, eq, ek, scales["dst"], jact,
        jdt)])
    np.testing.assert_allclose(ell_act_reduce(*args).numpy(), want,
                               **FWD_TOL)

    pairs = _jax_fwd(pallas.bucket_bcast_act_reduce2, fg, eq, ek,
                     scales["dst"], jact, jdt)
    rows, srows = ell_act_reduce2(*args)
    np.testing.assert_allclose(
        rows.numpy(), np.concatenate([np.asarray(r) for r, _ in pairs]),
        **FWD_TOL)
    np.testing.assert_allclose(
        srows.numpy(), np.concatenate([np.asarray(s) for _, s in pairs]),
        **FWD_TOL)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("graph,h", [("hub", 24), ("random", 96),
                                     ("random", 20)])
def test_src_bwd_plain_matches_pallas(graph, h, act, dt):
    import jax.numpy as jnp
    from sir_gcn_tpu.ops.ell import _bucket_offsets

    fg, eq, ek, g, scales = make_case(graph, h, seed=1)
    pallas, jact, jdt = jax_side(act, dt)
    tact, tdt = ACTS[act], DTYPES[dt]
    plan = fg.src_plan
    got = ell_src_bwd(_t(eq, tdt), _t(g, tdt), _t(ek), fg.src_slot_dstnode,
                      _t(scales["src"]), plan.row_key, plan.row_ptr, tact)

    idx = jnp.asarray(fg.src_slot_dstnode.numpy())
    eqg = jnp.take(jnp.asarray(eq).astype(jdt), idx, axis=0)
    gg = jnp.take(jnp.asarray(g).astype(jdt), idx, axis=0)
    ek_rows = jnp.take(jnp.asarray(ek), jnp.asarray(plan.row_key.numpy()),
                       axis=0)
    s = scales["src"]
    want = []
    for b, nr, so, ro in _bucket_offsets(plan.buckets1):
        r, _ = pallas.bucket_src_bwd(
            eqg[so:so + b * nr], ek_rows[ro:ro + nr],
            jnp.asarray(s[so:so + b * nr]).reshape(nr, b),
            gg[so:so + b * nr], b, jact, interpret=True)
        want.append(np.asarray(r))
    np.testing.assert_allclose(got.numpy(), np.concatenate(want), **BWD_TOL)


def test_plans_cover_the_awkward_cases():
    fg, *_ = make_case("hub", 24)
    assert fg.dst_plan.s2_gather is not None       # hub second stage
    assert fg.dst_plan.buckets1[-1][0] == 1        # budget-1 pad bucket
    fg, *_ = make_case("random", 96)
    assert any(b == 1 for b, _ in fg.dst_plan.buckets1)


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    fg, eq, ek, g, scales = make_case("random", 24)
    plan = fg.dst_plan
    good = [_t(eq), _t(ek), fg.dst_slot_srcnode, _t(scales["dst"]),
            plan.row_key, plan.row_ptr, tell.tanh]
    reset_launch_counts()
    ell_act_reduce(*good)
    assert all(v == 0 for v in LAUNCHES.values())
    bad = [
        (0, _t(eq, torch.float64)),                 # eq dtype
        (1, _t(ek)[:, :8].contiguous()),            # width mismatch
        (2, fg.dst_slot_srcnode.long()),            # index dtype
        (3, _t(scales["dst"])[:-1]),                # scale length
        (5, plan.row_ptr[:-1]),                     # row_ptr length
        (0, _t(eq).t().contiguous().t()),           # not contiguous
    ]
    for pos, value in bad:
        args = list(good)
        args[pos] = value
        with pytest.raises((TypeError, ValueError)):
            ell_act_reduce(*args)
    with pytest.raises(NotImplementedError):
        tell.Activation("swish")


def test_gelu_matches_jax_on_a_grid():
    """The registry's erf-GELU and its derivative against
    jax.nn.gelu(approximate=False) and its jax.grad, in f32 on [-12, 12]
    with +-0 (the kernels' plain versions and the CPU use these)."""
    import jax
    import jax.numpy as jnp

    z = np.concatenate([np.linspace(-12, 12, 24_001), [0.0, -0.0, 1e-30,
                                                       -1e-30]])
    z = z.astype(np.float32)
    f = lambda x: jax.nn.gelu(x, approximate=False)
    act, t = tell.gelu(), torch.from_numpy(z)
    assert act.kernel_id == 4 and act.elementwise and act.diagonal
    assert not act.general_kernels
    np.testing.assert_allclose(act(t).numpy(), np.asarray(f(jnp.asarray(z))),
                               **FWD_TOL)
    np.testing.assert_allclose(
        act.grad(t).numpy(),
        np.asarray(jax.vmap(jax.grad(f))(jnp.asarray(z))), **BWD_TOL)
    g = torch.from_numpy(z[::-1].copy())
    torch.testing.assert_close(act.vjp(t, g), act.grad(t) * g)
    assert act(torch.tensor([-0.0])).item() == 0.0
    assert float(act(torch.tensor([-12.0]))) <= 0.0


def test_gelu_general_route_raises_on_card_before_a_launch():
    """erf-GELU declared non-elementwise takes the general route, whose
    kernels do not take it: on a CUDA tensor the aggregate raises before
    any launch, naming the ROADMAP item; on the CPU the plain versions
    compute it. Checked here through the device check alone (no card):
    the route's check asks ``on_cuda`` of the tensors' device."""
    import dataclasses

    fg, eq, ek, g, scales = make_case("random", 24)
    act = dataclasses.replace(tell.gelu(), sir_elementwise=False)
    assert not act.elementwise
    out = tell.ell_sir_aggregate(fg, _t(eq), _t(ek), act, "sym")
    want = tell.ell_sir_aggregate(fg, _t(eq), _t(ek), tell.gelu(), "sym")
    torch.testing.assert_close(out, want, **FWD_TOL)
    import sir_gcn_tpu_torch.ops.cuda.kernels as tk

    with pytest.raises(NotImplementedError, match="Queue B part 1 item 1"):
        tk._check_general("ell_act_reduce_rowwise", act, 24,
                          torch.device("cuda"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a contiguous view that starts one element into
    its storage, so its data_ptr is not 16-byte aligned."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("graph,h", [("hub", 24), ("random", 96),
                                     ("random", 200), ("random", 20),
                                     ("random", 128), ("misaligned", 96)])
def test_kernels_match_plain_on_card(cuda_device, graph, h, act, dt):
    """Every kernel against its plain version, on the path its entry
    chooses: the 16-byte vector path where H * sizeof(T) is a multiple of
    16 and the tables are 16-byte aligned, else the scalar loop (H = 20 in
    bf16; tables that start one element into their storage). The plans
    have budgets that are not multiples of 8 (1, 2, 4, 10, ...), rows of
    more than 32 slots (the hub) and zero-scale padding slots."""
    fg, eq, ek, g, scales = make_case(
        "random" if graph == "misaligned" else graph, h, device=cuda_device)
    tact, tdt = ACTS[act], DTYPES[dt]
    d = cuda_device
    plan, splan = fg.dst_plan, fg.src_plan
    assert any(b % 8 for b, _ in plan.buckets1)
    assert (scales["dst"] == 0).any() and (scales["src"] == 0).any()
    place = _misaligned if graph == "misaligned" else (lambda t: t)
    fwd = (place(_t(eq, device=d)), place(_t(ek, tdt, d)),
           fg.dst_slot_srcnode, _t(scales["dst"], device=d), plan.row_key,
           plan.row_ptr, tact)
    reset_launch_counts()
    rows = ell_act_reduce(*fwd)
    rows2, srows = ell_act_reduce2(*fwd)
    bwd = (place(_t(eq, tdt, d)), place(_t(g, tdt, d)),
           place(_t(ek, device=d)), fg.src_slot_dstnode,
           _t(scales["src"], device=d), splan.row_key, splan.row_ptr, tact)
    gek = ell_src_bwd(*bwd)
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {
        "ell_act_reduce": 1, "ell_act_reduce2": 1, "ell_src_bwd": 1}
    vector = graph != "misaligned" and h * tdt.itemsize % 16 == 0
    layouts = (ell_layout("ell_act_reduce", h, tdt, *fwd[:2], rows),
               ell_layout("ell_act_reduce2", h, tdt, *fwd[:2], rows2, srows),
               ell_layout("ell_src_bwd", h, tdt, *bwd[:3], gek))
    assert all((lay is not None) == vector for lay in layouts), layouts
    want = ell_act_reduce_plain(*fwd)
    want2 = ell_act_reduce_plain(*fwd, derivative=True)
    torch.testing.assert_close(rows, want, **FWD_TOL)
    torch.testing.assert_close(rows2, want2[0], **FWD_TOL)
    torch.testing.assert_close(srows, want2[1], **FWD_TOL)
    torch.testing.assert_close(gek, ell_src_bwd_plain(*bwd), **BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", sorted(ACTS))
def test_kernels_are_bitwise_repeatable_on_card(cuda_device, act, dt):
    """Two launches of #2 and #4 on the same inputs give bitwise equal
    outputs: each sum's order is fixed by the layout, with no atomics. A
    graph of 4,000 nodes and 40,000 edges fills many blocks."""
    rng = np.random.default_rng(7)
    n, e = 4000, 40000
    fg = tell.build_fast_graph(
        build_graph(rng.integers(0, n, e), rng.integers(0, n, e), n,
                    device=cuda_device), max_budget=64)
    tact, tdt, d = ACTS[act], DTYPES[dt], cuda_device
    eq, ek, g = (_t(rng.normal(size=(fg.n_pad, 96)).astype(np.float32),
                    device=d) for _ in range(3))
    plan, splan = fg.dst_plan, fg.src_plan
    fwd = (eq, ek.to(tdt), fg.dst_slot_srcnode, fg.dst_slot_scales["sym"],
           plan.row_key, plan.row_ptr, tact)
    bwd = (eq.to(tdt), g.to(tdt), ek, fg.src_slot_dstnode,
           fg.src_slot_scales["sym"], splan.row_key, splan.row_ptr, tact)
    first = ell_act_reduce2(*fwd) + (ell_src_bwd(*bwd),)
    second = ell_act_reduce2(*fwd) + (ell_src_bwd(*bwd),)
    torch.cuda.synchronize()
    assert ell_layout("ell_act_reduce2", 96, tdt, *fwd[:2], *first[:2])
    assert ell_layout("ell_src_bwd", 96, tdt, *bwd[:3], first[2])
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_ell_ab_needs_a_card(tmp_path):
    """The A/B tool of two ell_kernels.cu builds runs on the card only."""
    from sir_gcn_tpu_torch.tools import ell_ab

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ell_ab.main([str(tmp_path / "other.cu")])
