"""The timing lab's kernels (#13-#24) against the JAX tools' own Pallas
kernels, and the two lab tools on the CPU.

The Pallas kernels are closures inside ``main()`` of ``tools/kernel_lab.py``
and ``tools/gather_dma.py``. They are taken from the unmodified files with
``ast`` (the nested ``make_*`` and kernel ``def``s, and the ``pallas_call``
assignments of gather_dma.py) and run at small sizes in a namespace that
holds the sizes, the activation and a ``pl`` whose ``pallas_call`` runs in
interpret mode. On the CPU each wrapper of ``ops/cuda/lab.py`` runs its
plain version, which is held against them.

Tolerances: the f32 variants sum B = 16 terms in f32 in another order,
so the JAX suite's forward tolerance (atol 2e-4 / rtol 1e-4) holds. v4
rounds to bf16 at the same points on both sides. XLA on the CPU could
keep a fused intermediate in f32 where the plain version rounds; it does
not here (v4 agrees exactly at these inputs), so v4 is held to the same
forward tolerance. The stream passthrough is exact. The gather and
the tile sums add 64 rows in another order: SUM_TOL bounds their error by
2^-24 * 1024 of the sum of the terms' magnitudes (a chain of at most 1024
rounded f32 adds on either side).

The ``cuda`` tests compare each kernel with its plain version on the card
and skip where there is none; they need no JAX
(``pytest -m cuda --noconftest tests/test_torch_lab.py``).
"""

import ast
import functools
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from sir_gcn_tpu_torch.ops.cuda import LAUNCHES, lab, reset_launch_counts
from sir_gcn_tpu_torch.ops.cuda.kernels import ell_act_reduce_plain
from sir_gcn_tpu_torch.ops.ell import leaky_relu
from sir_gcn_tpu_torch.tools import gather_dma, kernel_lab

ROOT = Path(__file__).resolve().parents[1]
FWD_TOL = dict(atol=2e-4, rtol=1e-4)
SUM_TOL = 2.0 ** -24 * 1024
R, B, H = 28, 16, 128        # 28 rows: a partial last tile of 8 rows
N, T, TSUM = 200, 64, 64     # N a multiple of 8, as the TPU gather needs
S_GATHER = 4 * T
INFLIGHT = 16


def _main_body(path: Path, defs, assigns=()):
    """The nested ``def``s named ``defs`` and the assignments to
    ``assigns`` in ``main()`` of ``path``, as a module to exec."""
    tree = ast.parse(path.read_text(), str(path))
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = [n for n in main.body
            if (isinstance(n, ast.FunctionDef) and n.name in defs)
            or (isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) in assigns
                        for t in n.targets))]
    assert {getattr(n, "name", None) for n in body} >= set(defs)
    return compile(ast.Module(body=body, type_ignores=[]), str(path), "exec")


def _pallas_namespace(**sizes):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                    if not k.startswith("_")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return dict(jax=jax, jnp=jnp, pl=shim, pltpu=pltpu,
                act=lambda x: jax.nn.leaky_relu(x, 0.2),
                cdiv=lambda a, b: -(-a // b), **sizes)


@functools.lru_cache(maxsize=None)
def kernel_lab_jax():
    """The ``make_*`` factories of tools/kernel_lab.py at R, B, H."""
    names = ("make_v1", "make_v2", "make_v3", "make_v4", "make_v5",
             "make_v6", "make_copy", "make_copy32", "make_pass",
             "make_pass2")
    ns = _pallas_namespace(R=R, B=B, H=H, S=R * B)
    exec(_main_body(ROOT / "tools" / "kernel_lab.py", names), ns)
    return ns


@functools.lru_cache(maxsize=None)
def gather_dma_jax():
    """``gather_dma_p`` and ``sum_rows`` of tools/gather_dma.py at N,
    S_GATHER, H, T, TSUM."""
    ns = _pallas_namespace(N=N, S=S_GATHER, H=H, T=T, INFLIGHT=INFLIGHT,
                           G=S_GATHER // T, TSUM=TSUM)
    exec(_main_body(ROOT / "tools" / "gather_dma.py",
                    ("kernel", "copy_kernel"), ("gather_dma_p", "sum_rows")),
         ns)
    return ns


def lab_inputs(seed=0):
    """numpy inputs, the bf16 ones already on the bf16 grid, and the same
    as torch tensors."""
    rng = np.random.default_rng(seed)

    def bf16_grid(a):
        return torch.from_numpy(a.astype(np.float32)).to(
            torch.bfloat16).float().numpy()

    arrays = dict(ekg=bf16_grid(rng.normal(size=(R * B, H))),
                  eq=rng.normal(size=(R, H)).astype(np.float32),
                  sc=rng.random((R * B, 1)).astype(np.float32),
                  ekg3=bf16_grid(rng.normal(size=(B, R, H))),
                  sc3=rng.random((B, R, 1)).astype(np.float32))
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tensors = dict(ekg=t["ekg"].to(torch.bfloat16), eq=t["eq"],
                   sc=t["sc"].reshape(-1),
                   ekg3=t["ekg3"].to(torch.bfloat16),
                   sc3=t["sc3"].reshape(B, R))
    tensors["ekg32"] = tensors["ekg"].float()
    return arrays, tensors


def _jnp(a, bf16=False):
    import jax.numpy as jnp

    return jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)


# (kernel, Pallas factory call, the wrapper on the lab inputs)
ACT_CASES = {
    "lab_v1": (lambda ns: ns["make_v1"](128), "flat",
               lambda t: lab.lab_v1(t["ekg"], t["eq"], t["sc"])),
    "lab_v2": (lambda ns: ns["make_v2"](128, 4), "flat",
               lambda t: lab.lab_v2(t["ekg"], t["eq"], t["sc"])),
    "lab_v3": (lambda ns: ns["make_v3"](128), "flat",
               lambda t: lab.lab_v3(t["ekg"], t["eq"], t["sc"])),
    "lab_v4": (lambda ns: ns["make_v4"](128), "flat",
               lambda t: lab.lab_v4(t["ekg"], t["eq"], t["sc"])),
    "lab_v5": (lambda ns: ns["make_v5"](8), "plane3",
               lambda t: lab.lab_v5(t["ekg3"], t["eq"], t["sc3"])),
    "lab_v6": (lambda ns: ns["make_v6"](8), "plane2",
               lambda t: lab.lab_v6(t["ekg3"], t["eq"], t["sc3"])),
}


@pytest.mark.parametrize("kernel", sorted(ACT_CASES))
def test_act_reduce_variants_match_pallas(kernel):
    make, layout, port = ACT_CASES[kernel]
    a, t = lab_inputs()
    fn = make(kernel_lab_jax())
    if layout == "flat":
        want = fn(_jnp(a["ekg"], True), _jnp(a["eq"]), _jnp(a["sc"]))
    elif layout == "plane3":
        want = fn(_jnp(a["ekg3"], True), _jnp(a["eq"]), _jnp(a["sc3"]))
    else:
        want = fn(_jnp(a["ekg3"], True), _jnp(a["eq"]),
                  _jnp(a["sc3"][..., 0]))
    want = np.asarray(want)
    got = port(t).numpy()
    assert got.shape == want.shape == (R, H)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    if kernel == "lab_v4":
        # it is the bf16 computation: away from the f32 variants
        f32 = lab.act_reduce_plain(t["ekg"], t["eq"], t["sc"]).numpy()
        assert np.abs(got - f32).max() > 1e-3


@pytest.mark.parametrize("kernel,dtype", [("lab_copy", "bf16"),
                                          ("lab_copy32", "f32")])
def test_sum_only_streams_match_pallas(kernel, dtype):
    a, t = lab_inputs(seed=1)
    ns = kernel_lab_jax()
    bf = dtype == "bf16"
    want = np.asarray(ns["make_copy" if bf else "make_copy32"](128)(
        _jnp(a["ekg"], bf)))
    got = getattr(lab, kernel)(t["ekg"] if bf else t["ekg32"], R).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("case", ["pass", "pass2 parallel",
                                  "pass2 arbitrary"])
def test_passthrough_matches_pallas_exactly(case):
    a, t = lab_inputs(seed=2)
    ns = kernel_lab_jax()
    x = _jnp(a["ekg"], True)
    if case == "pass":
        want, got = ns["make_pass"](64)(x), lab.lab_pass(t["ekg"])
    else:
        sem = case.split()[1]
        want = ns["make_pass2"](64, sem)(x)
        got = lab.lab_pass2(t["ekg"], persistent=sem == "arbitrary")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def _sum_close(got, want, magnitude):
    diff = np.abs(got - want)
    assert (diff <= SUM_TOL * magnitude).all(), (
        f"max err {diff.max()}, allowed {SUM_TOL * magnitude.max()}")


def gather_inputs(seed=3):
    rng = np.random.default_rng(seed)
    tbl = torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32)).to(
        torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, N, S_GATHER).astype(np.int32))
    return tbl, idx


def test_gather_matches_pallas():
    import jax.numpy as jnp

    tbl, idx = gather_inputs()
    ns = gather_dma_jax()
    want = np.asarray(ns["gather_dma_p"](
        jnp.asarray(idx.numpy()), _jnp(tbl.float().numpy(), True)))
    got = lab.lab_gather(tbl, idx, T).numpy()
    assert got.shape == want.shape == (S_GATHER // T, 8, H)
    mag = lab.gather_sum_plain(tbl.abs(), idx, T).numpy()
    _sum_close(got, want, mag)
    # the 8 rows of a tile carry one sum
    assert (got == got[:, :1]).all()


@pytest.mark.parametrize("tile", [T, 5])
def test_gather_variants_take_the_plain_version_on_the_cpu(tile):
    """On the CPU lab_gather is the plain version, and launches nothing,
    for the lab's tiles and for short ones."""
    tbl, idx = gather_inputs(seed=5)
    idx = idx[:idx.shape[0] // tile * tile]
    reset_launch_counts()
    got = lab.lab_gather(tbl, idx, tile)
    assert LAUNCHES["lab_gather"] == 0
    torch.testing.assert_close(got, lab.gather_sum_plain(tbl, idx, tile),
                               rtol=0, atol=0)


def test_tile_sum_matches_pallas():
    tbl, idx = gather_inputs(seed=4)
    v = tbl.index_select(0, idx)
    want = np.asarray(gather_dma_jax()["sum_rows"](
        _jnp(v.float().numpy(), True)))
    got = lab.lab_tile_sum(v, TSUM).numpy()
    assert got.shape == want.shape == (S_GATHER // TSUM * 8, H)
    _sum_close(got, want, lab.tile_sum_plain(v.abs(), TSUM).numpy())


def test_v0_runs_ell_act_reduce_on_the_identity_plan():
    a, t = lab_inputs(seed=5)
    slot_src, row_key, row_ptr = kernel_lab.identity_plan(R, B, "cpu")
    args = (t["eq"], t["ekg"], slot_src, t["sc"], row_key, row_ptr,
            leaky_relu(0.2))
    want = np.asarray(kernel_lab_jax()["make_v1"](128)(
        _jnp(a["ekg"], True), _jnp(a["eq"]), _jnp(a["sc"])))
    (v0,) = [fn for tag, _, _, fn, _, _ in kernel_lab.variants(
        dict(t), ("v0",)) if tag == "v0"]
    got = v0()
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    torch.testing.assert_close(got, ell_act_reduce_plain(*args), rtol=0,
                               atol=0)


def test_kernel_lab_runs_on_the_cpu(capsys):
    reset_launch_counts()
    recs = kernel_lab.run(torch.device("cpu"), kernel_lab.TAGS, R=24, B=16,
                          H=128)
    assert all(v == 0 for v in LAUNCHES.values())   # CPU: no launch
    assert {r["tag"] for r in recs} == set(kernel_lab.TAGS)
    assert len(recs) == 23
    assert all(r["device"] == "cpu" and r["gbps"] is None for r in recs)
    assert {r["kernel"] for r in recs} - {None, "ell_act_reduce"} == set(
        k for k in lab.PLAIN if k not in ("lab_gather", "lab_tile_sum"))
    out = capsys.readouterr().out
    assert out.count("not a device time") == 23


def test_gather_dma_runs_on_the_cpu(capsys):
    recs = gather_dma.run(torch.device("cpu"), N=N, S=S_GATHER, H=H, T=T,
                          TSUM=TSUM)
    assert [r["kernel"] for r in recs] == ["lab_gather", None, None,
                                           "lab_tile_sum"]
    captured = capsys.readouterr()
    assert captured.out.count("not a device time") == 4
    assert "[start]" in captured.err and "[start]" not in captured.out


@pytest.mark.parametrize("tool", [kernel_lab, gather_dma])
def test_lab_without_cpu_flag_needs_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])


def test_kernel_lab_rejects_unknown_tags():
    with pytest.raises(SystemExit):
        kernel_lab.main(["--cpu", "v9"])


def test_wrappers_check_inputs():
    _, t = lab_inputs()
    ekg, eq, sc = t["ekg"], t["eq"], t["sc"]
    bad = [
        lambda: lab.lab_v2(ekg.float(), eq, sc),          # ekg dtype
        lambda: lab.lab_v2(ekg, eq, sc[:-1]),             # scale length
        lambda: lab.lab_v2(ekg[:-3], eq, sc[:-3]),        # not R*B rows
        lambda: lab.lab_v2(ekg, eq, sc, inflight=3),      # knob
        lambda: lab.lab_v1(ekg, eq, sc, tile_rows=64),    # knob
        lambda: lab.lab_v3(ekg[:, :96].contiguous(), eq[:, :96].contiguous(),
                           sc),                           # width not 2^k
        lambda: lab.lab_v5(t["ekg3"], eq, t["sc3"].t().contiguous()),
        lambda: lab.lab_copy(ekg, 5),                     # rows
        lambda: lab.lab_pass(ekg.t()),                    # not contiguous
        lambda: lab.lab_gather(ekg, torch.zeros(100, dtype=torch.int32), 64),
        lambda: lab.lab_tile_sum(ekg, 100),               # whole tiles
    ]
    for fn in bad:
        with pytest.raises((TypeError, ValueError)):
            fn()


@pytest.mark.parametrize("case", ["inflight", "24 chunks", "8 bytes",
                                  "too many slots"])
def test_copy32_wrapper_refuses(case):
    """lab_copy32's knob, width and shared-memory checks hold on the CPU
    as on the card: 3 in flight, a row of 24 or of half a 16-byte chunk,
    and 100 slots a row (50 KB slabs: two stages of four pass 227 KB, of
    two do not)."""
    bad = {"inflight": (torch.zeros((64, 128)), 4, 3),
           "24 chunks": (torch.zeros((64, 96)), 4, 4),
           "8 bytes": (torch.zeros((64, 2)), 4, 4),
           "too many slots": (torch.zeros((200, 128)), 2, 4)}[case]
    with pytest.raises(ValueError):
        lab.lab_copy32(*bad)
    # the same input at a good knob, width and slot count is taken
    assert lab.lab_copy32(torch.zeros((64, 128)), 4, 8).shape == (4, 128)
    assert lab.lab_copy32(torch.zeros((200, 128)), 2, 2).shape == (2, 128)


def test_alternating_turns(monkeypatch):
    """The A/B's turns alternate (a, b, c, c, b, a, ...) and the verdict
    reads the spread of both sides."""
    from sir_gcn_tpu_torch import tools

    order = []
    monkeypatch.setattr(tools, "cuda_ms",
                        lambda fn, iters: order.append(fn()) or len(order))
    ms = tools.alternating_ms({k: (lambda k=k: k) for k in "abc"}, 20, 4)
    assert "".join(order) == "abccbaabccba"
    assert ms == {"a": [1, 6, 7, 12], "b": [2, 5, 8, 11], "c": [3, 4, 9, 10]}
    assert tools.verdict([1.0, 1.1], [1.2, 1.3]) == "win"
    assert tools.verdict([1.0, 1.25], [1.2, 1.3]) == "tie"
    assert tools.verdict([1.4, 1.5], [1.2, 1.3]) == "loss"


def test_lab_ab_needs_a_card_and_a_known_source(tmp_path):
    from sir_gcn_tpu_torch.tools import ell_ab

    with pytest.raises(ValueError, match="no source"):
        ell_ab.build_other(tmp_path / "other.cu", "lab_kernel")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ell_ab.main(["--lab", str(tmp_path / "other.cu")])


def test_max_ab_needs_a_card_and_a_known_source(tmp_path):
    """``ell_ab --max`` (#9-#11 of two ell_max_kernels.cu builds) refuses
    an unknown source name and runs on the card only."""
    from sir_gcn_tpu_torch.tools import ell_ab

    with pytest.raises(ValueError, match="no source"):
        ell_ab.build_other(tmp_path / "other.cu", "ell_max_kernel")
    with pytest.raises(SystemExit):  # one mode at a time
        ell_ab.main(["--max", "--lab", str(tmp_path / "other.cu")])
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ell_ab.main(["--max", str(tmp_path / "other.cu")])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_case(name, d):
    """(inputs, knobs) of one kernel on the card: the wrapper takes both,
    its plain version the inputs."""
    _, t = lab_inputs(seed=6)
    t = {k: v.to(d) for k, v in t.items()}
    tbl, idx = (x.to(d) for x in gather_inputs(seed=7))
    v = tbl.index_select(0, idx)
    calls = {
        "lab_v1": ((t["ekg"], t["eq"], t["sc"]), (8,)),
        "lab_v2": ((t["ekg"], t["eq"], t["sc"]), (2,)),
        "lab_v3": ((t["ekg"], t["eq"], t["sc"]), ()),
        "lab_v4": ((t["ekg"], t["eq"], t["sc"]), (8,)),
        "lab_v5": ((t["ekg3"], t["eq"], t["sc3"]), (8,)),
        "lab_v6": ((t["ekg3"], t["eq"], t["sc3"]), (32,)),
        "lab_copy": ((t["ekg"], R), (4,)),
        "lab_copy32": ((t["ekg32"], R), (8,)),
        "lab_pass": ((t["ekg"],), ()),
        "lab_pass2": ((t["ekg"],), (True,)),
        "lab_gather": ((tbl, idx, T), ()),
        "lab_tile_sum": ((v, TSUM), ()),
    }
    return calls[name]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(lab.PLAIN))
def test_lab_kernel_matches_plain_on_card(cuda_device, name):
    args, knobs = _card_case(name, cuda_device)
    reset_launch_counts()
    got = getattr(lab, name)(*args, *knobs)
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {name: 1}
    want = lab.PLAIN[name](*args)
    if name in ("lab_pass", "lab_pass2"):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    elif name in ("lab_gather", "lab_tile_sum"):
        mag = lab.PLAIN[name](args[0].abs(), *args[1:])
        assert ((got - want).abs() <= SUM_TOL * mag).all()
    else:
        torch.testing.assert_close(got, want, **FWD_TOL)


# lab_copy32's shapes (R, B, H) on the card: a unit of a block's ring is
# 32 / (H / 4) rows, so H = 32 makes units of 4 rows and R = 29 a short
# last one; B = 1 and B = 12 (not a multiple of 8) make 512 B and 6 KB
# units
COPY32_SHAPES = {"lab": (R, B, H), "short last unit": (29, 16, 32),
                 "one slot": (37, 1, 128), "twelve slots": (30, 12, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("inflight", lab.INFLIGHT)
@pytest.mark.parametrize("shape", sorted(COPY32_SHAPES))
def test_copy32_bulk_cases_on_card(cuda_device, shape, inflight):
    r, b, h = COPY32_SHAPES[shape]
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(r * b, h)).astype(np.float32))
    x = x.to(cuda_device)
    got = lab.lab_copy32(x, r, inflight)
    again = lab.lab_copy32(x, r, inflight)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, lab.row_sum_plain(x, r), **FWD_TOL)
    assert torch.equal(got, again)  # slot order: the same bits each launch


@pytest.mark.cuda
@pytest.mark.parametrize("persistent", [False, True])
@pytest.mark.parametrize("rows", [R * B, 5, 256 * 997 + 37])
def test_pass2_cases_on_card(cuda_device, rows, persistent):
    """n not a whole number of 256-row tiles (1.75 tiles; 5 rows, fewer
    16-byte chunks than a block has threads; 997 tiles and 37 rows, many
    tiles a persistent block), and a table off 16-byte alignment, which
    the launch refuses."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(rows, H)).astype(np.float32))
    x = x.to(torch.bfloat16).to(cuda_device)
    got = lab.lab_pass2(x, persistent)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, lab.pass_plain(x), rtol=0, atol=0)
    off = x.view(-1)[4:4 + (rows - 1) * H].view(rows - 1, H)
    with pytest.raises(RuntimeError, match="launch failed"):
        lab.lab_pass2(off, persistent)


# lab_gather on the card, (tiles G, tile T, width H): G below the card's
# 132 SMs and not a multiple of them; T off the 32-index batch (a short
# last batch a tile); tiles of 5 indices (one short batch each, many tiles
# a warp); one tile (few warps, each with a long share); every width 8 ..
# 256 of the wrapper
GATHER_CASES = {"G below the SMs": (100, 4096, 128),
                "T off the batch": (300, 1000, 128),
                "short tiles": (1000, 5, 64),
                "one tile": (1, 4096, 128),
                "one tile of one row": (1, 1, 32),
                **{f"H {h}": (37, 300, h) for h in (8, 16, 32, 64, 256)}}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_cases_on_card(cuda_device, case):
    """lab_gather against gather_sum_plain, the 8 rows of a tile equal,
    and a second launch with the same bits."""
    g, t, h = GATHER_CASES[case]
    rng = np.random.default_rng(10)
    n = 3000
    tbl = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32)).to(
        torch.bfloat16).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, n, g * t).astype(np.int32)).to(
        cuda_device)
    warps = lab.lab_gather_warps(h, g, t)
    assert 1 <= warps <= g * -(-t // 32)
    got = lab.lab_gather(tbl, idx, t)
    again = lab.lab_gather(tbl, idx, t)
    torch.cuda.synchronize()
    assert got.shape == (g, 8, h)
    mag = lab.gather_sum_plain(tbl.abs(), idx, t)
    diff = (got - lab.gather_sum_plain(tbl, idx, t)).abs()
    assert (diff <= SUM_TOL * mag).all(), (case, float(diff.max()))
    assert (got == got[:, :1]).all()
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_gather_is_bitwise_repeatable_on_card(cuda_device):
    """At the lab's size (672 tiles of 4096 indices into a 43.5 MB table)
    two launches give the same bits: the split and every sum's order are
    fixed, with no atomics."""
    sizes = gather_dma.SIZES
    inp = gather_dma.make_inputs(cuda_device)
    runs = [lab.lab_gather(inp["tbl"], inp["idx"], sizes["T"])
            for _ in range(2)]
    torch.cuda.synchronize()
    assert runs[0].shape == (sizes["S"] // sizes["T"], 8, sizes["H"])
    assert torch.equal(*runs)
