"""Same-card A/B of two builds of one of the port's CUDA sources: another
source with the same C interface (an earlier revision of the file, for
example) against the package's own.

    git show <rev>:sir_gcn_tpu_torch/csrc/ell_kernels.cu > other.cu
    python -m sir_gcn_tpu_torch.tools.ell_ab other.cu [--probes]
    git show <rev>:sir_gcn_tpu_torch/csrc/lab_kernels.cu > other.cu
    python -m sir_gcn_tpu_torch.tools.ell_ab --lab other.cu
    git show <rev>:sir_gcn_tpu_torch/csrc/ell_max_kernels.cu > other.cu
    python -m sir_gcn_tpu_torch.tools.ell_ab --max other.cu [--hidden 512]
    python -m sir_gcn_tpu_torch.tools.ell_ab --max \
        --define ELL_MAX_WIDE_ONLY sir_gcn_tpu_torch/csrc/ell_max_kernels.cu
    git show <rev>:sir_gcn_tpu_torch/csrc/ell_edge_kernels.cu > other.cu
    python -m sir_gcn_tpu_torch.tools.ell_ab --edge other.cu [--hidden H --de De]
    git show <rev>:sir_gcn_tpu_torch/csrc/ell_general_kernels.cu > other.cu
    python -m sir_gcn_tpu_torch.tools.ell_ab --general other.cu [--hidden 512]

The other source is built with the package's nvcc flags for its source
(and ``-D`` of each ``--define``) into a library of its own
(``build/kernels/ab-<hash>/``), which the package never loads. The
package's own max source built with ``--define ELL_MAX_WIDE_ONLY`` takes
the wide path wherever it fits: at H = 96 the A/B of the wide path (the
other) against the first design (this).

The ELL mode (``csrc/ell_kernels.cu``) runs each of #1, #2, #4 and their
edge-term forms (leaky_relu(0.2) and erf-GELU; #2 and #4 also with tanh)
from both libraries on the same inputs at the ogbn-arxiv plan with bf16
edges: ms per launch by CUDA events over 50 warm launches in four turns
(other, this, this, other), and the largest difference of the two
outputs.
``--probes`` adds #2 and #4 with every gathered index folded into 1/2,
1/4 and 1/8 of the node table and into 16,384 rows: the same gathers from
a smaller table, which the 50 MB L2 holds. The plan is the trainer's
synthetic stand-in for ogbn-arxiv (169,343 nodes, 1,166,243 edges, seed
0, bidirected with self-loops), H = 96.

The lab mode (``--lab``, ``csrc/lab_kernels.cu``) runs the streams #19
``lab_copy``, #20 ``lab_copy32`` (at each ``inflight``), #21 ``lab_pass``,
#22 ``lab_pass2`` (both modes), #24 ``lab_tile_sum`` and the gather #23
``lab_gather`` (below) from both
libraries and the PyTorch call that computes the same function, at the
lab tools' sizes (``kernel_lab.SIZES``, ``gather_dma.SIZES``), on random
inputs from seed 0 made on the card: ms per launch over 20 warm launches
in eight turns (other, this, library, library, this, other, ...), the
median and the spread of each, the kernel's verdict against the library
call (win: its slowest turn beats the call's fastest; loss: the other
way round; else tie), and the largest difference of the two kernels'
outputs, which must be 0 for the passthroughs.

The max mode (``--max``, ``csrc/ell_max_kernels.cu``) runs #9
``ell_max_fwd``, #10 ``ell_max_wincount`` and #11 ``ell_max_bwd`` from
both libraries with bf16 edges, W ~ U(-1, 1)/sqrt(H) and a cotangent from
seed 0 made on the card: at the ogbn-arxiv plan, H = O = 96,
leaky_relu(0.2) (#11 also with tanh); with ``--hidden H`` (H = O, e.g.
512, the wide path) on a graph of roman-empire's size (22,662 nodes,
65,854 edges, the heterophilous trainer's stand-in) with erf-GELU and
leaky_relu(0.2). ms per launch over 10 warm launches in eight turns
(other, this, this, other, ...), the median and the spread of each. Each
library's counts and backward are taken against its own forward's
maxima, as the aggregate uses them; the tool prints the largest
difference of the maxima, the (row, o) whose counts differ (near ties
that the two products round apart), the largest difference of geq_rows,
g_z and g_W, g_W against GW_TOL, and which outputs are the other
build's bits.

The edge mode (``--edge``, ``csrc/ell_edge_kernels.cu``) runs #7
``ell_edge_act_reduce2`` and #8 ``ell_edge_src_bwd`` from both libraries
at the ogbn-arxiv plan, H = 96, De = 16 (or ``--hidden H --de De``, e.g.
``--hidden 512`` for the columns path), with bf16 and with f32 edges,
leaky_relu(0.2), tanh and erf-GELU, the basis and W_E from seed 0 made
on the card (as chip_smoke.py's ``edge_tables``): ms per launch over 20
warm launches in eight turns (other, this, this, other, ...), the median
and the spread of each; the largest difference of rows, srows, the g_ek rows and g_WE
between the two libraries, and whether each is bitwise equal; and the
paths this library's ``ell_edge_layout`` reports.

The general mode (``--general``, ``csrc/ell_general_kernels.cu``) runs
#1r ``ell_act_reduce_rowwise``, #3 ``ell_geq_reduce``, #4r
``ell_src_bwd_rowwise``, #5 ``ell_src_bwd_fused`` and #6
``ell_act_reduce_bwd`` (g_z in the gathered type), and for a row-wise
sigma the edge forms #1r·e, #3·e and #4r·e, from both libraries at the
ogbn-arxiv plan, H = 96 (or ``--hidden H``, e.g. 512), with the gathered
tables in bf16 and in f32, the node and edge tables and the cotangent
from seed 0 made on the card, for centered_relu(0.5), softmax,
leaky_relu(0.2) and tanh. The kernels of ``GENERAL_AB`` (all eight for a
row-wise sigma, #5 for an elementwise one) are timed: ms per launch over
20 warm launches in eight turns (other, this, this, other, ...), the
median and the spread of each, and where one gathered node table holds
more than twice the L2 (as at H = 512) each kernel's no-L2-reuse
estimate (each valid slot's gathered rows, its key rows, its outputs and
its slot arrays once at 3.35 TB/s; not a floor: what the L2 still holds
costs less). Every output is held to the other library's as
``GENERAL_HELD`` says: to its bits where the two libraries'
``ell_general_layout`` report the same path for the kernel, else within
a tolerance, with how many entries lie beyond it (centered_relu's gate
may take the other side of the relu where the two sum a row's mean in
another order); and where #3 and #6 take the lane-group path, #6's rows
to #3's bits. Both libraries' layouts are printed for each kernel. Needs
a CUDA card.

The lab mode runs #23 ``lab_gather`` from gather_dma's 43.5 MB table and
from one of ``gather_dma.BIG_N`` rows (174 MB, beyond the L2), with
``F.embedding_bag`` as its library call.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import statistics
import subprocess
import time
from pathlib import Path

import torch

from ..data import synthetic_node_classification
from ..experiments.ogbn_arxiv.train import build_arxiv_graph, get_args
from ..ops.cuda import build
from ..ops.cuda.checks import near_gate, slot_rows
from ..ops.cuda.kernels import (
    _ARGTYPES,
    _QUERIES,
    _RESTYPE,
    GeneralLayout,
    _library,
    add_cast,
    decode_max_layout,
    ell_edge_layout,
    ell_general_layout,
    ell_max_layout,
)
from ..ops.cuda.lab import INFLIGHT, PASS2_TILE_ROWS
from ..ops.ell import centered_relu, gelu, leaky_relu, softmax, tanh
from . import (
    alternating_ms,
    card_line,
    gather_dma,
    kernel_lab,
    resolve_device,
    verdict,
)

ARXIV = dict(nodes=169_343, edges=1_166_243, seed=0)
# the heterophilous roman-empire's size (Platonov et al. 2023, Table 1:
# 22,662 nodes, 32,927 undirected edges), the max mode's graph past H
ROMAN = dict(nodes=22_662, edges=65_854)
H = 96
ITERS = 50
FOLDS = (2, 4, 8)
FOLD_ROWS = 16_384
LAB_ITERS = 20
LAB_ROUNDS = 8  # turns of (other, this, library), alternating in order
MAX_ITERS, MAX_ROUNDS = 10, 8
EDGE_DE = 16  # the edge basis width of the SIREConv configuration
EDGE_ITERS, EDGE_ROUNDS = 20, 8
# g_WE sums a product over every slot: two grids sum it in another order,
# held to chip_smoke.py's GW_TOL (atol grows by 1e-5 of the largest entry)
GW_TOL = dict(atol=3e-4, rtol=1e-3, amax=1e-5)
GENERAL_ITERS, GENERAL_ROUNDS = 20, 8
FWD_TOL = dict(atol=2e-4, rtol=1e-4)
BWD_TOL = dict(atol=3e-4, rtol=1e-3)
# a g_z stored in bf16: one bf16 step apart where the two round f32 values
# that differ in their last bits
BF16_STEP = dict(atol=3e-4, rtol=2.0 ** -7)
# the general kernels: tag -> label, and the output each is timed by
GENERAL_KERNELS = {"#1r": ("#1r ell_act_reduce_rowwise", "rows"),
                   "#1r·e": ("#1r·e ell_act_reduce_rowwise_edge", "rows_e"),
                   "#3": ("#3 ell_geq_reduce", "geq"),
                   "#3·e": ("#3·e ell_geq_reduce_edge", "geq_e"),
                   "#4r": ("#4r ell_src_bwd_rowwise", "out"),
                   "#4r·e": ("#4r·e ell_src_bwd_rowwise_edge", "out_e"),
                   "#5": ("#5 ell_src_bwd_fused", "fused"),
                   "#6": ("#6 ell_act_reduce_bwd", "gz")}
# the kernels timed, by sigma kind (the others run once in each setting;
# the edge forms only for a row-wise sigma)
GENERAL_AB = {"rowwise": ("#1r", "#1r·e", "#3", "#3·e", "#4r", "#4r·e", "#5",
                          "#6"),
              "elementwise": ("#5",)}
# general_launches' outputs against the other build's: the kernel that
# writes each, and its tolerance where the two builds' paths differ (else
# its bits), "step" for a value rounded to the gathered type (one bf16 step
# in bf16, BWD_TOL in f32)
GENERAL_HELD = {"rows": ("#1r", FWD_TOL), "rows_e": ("#1r·e", FWD_TOL),
                "geq": ("#3", BWD_TOL), "geq_e": ("#3·e", BWD_TOL),
                "out": ("#4r", BWD_TOL),
                "out_e": ("#4r·e", BWD_TOL), "g_e": ("#4r·e", "step"),
                "fused": ("#5", BWD_TOL), "gz": ("#6", "step"),
                "geq6": ("#6", BWD_TOL)}
# the outputs whose rows holding a near centered_relu gate
# (``checks.near_gate``: the two builds sum a slot's mean in another order)
# are left out of the tolerance and counted: (row mask, the edge form's)
GATE_ROWS = {"out": ("rows", False), "out_e": ("rows", True),
             "g_e": ("edges", True), "geq": ("dst_rows", False),
             "geq_e": ("dst_rows", True)}
# the entries #1r, #3 and #4r take past H = 256 for a row-wise sigma (ids
# 2, 3): the first design's register form (NF = 16, rows to 512; #3's
# without EMIT) and the lane groups of the whole warp (GW = 32; MODE 0 #3,
# 1 #4r, 2 #1r; EDGE); ``wide_build_report`` raises where a build's report
# names none of them
WIDE_ENTRIES = re.compile(
    r"(?P<first>act_reduce_rw_kernelILi[23]ELi16ELb0E(?:13__nv_bfloat16|f)E"
    r"|src_bwd_rw_kernelILi[23]ELi16ELb0E(?:13__nv_bfloat16|f)Lb0E"
    r"|geq_kernelILi[23]ELi16ELb0E(?:13__nv_bfloat16|f)fLb0E)"
    r"|(?P<group>group_kernelILi[23]E(?:13__nv_bfloat16|f)Li32ELi\dELi(?P<mode>"
    r"[012])ELb[01]E)")
# the tiles path's entries of csrc/ell_edge_kernels.cu (#8 past a block's
# shared memory with De <= 16)
TILES_ENTRIES = re.compile(r"edge_src_bwd_tiles_kernelILi\dELi\d+ELb[01]E"
                           r"(?:13__nv_bfloat16|f)E")
# the node rows each kernel gathers a valid slot (and for #3 and #6 the
# f32 key rows a row, two), for its no-L2-reuse estimate
GENERAL_ROWS = {"#1r": 1, "#1r·e": 2, "#3": 1, "#3·e": 2, "#4r": 2,
                "#4r·e": 3, "#5": 2, "#6": 1}

# the H100's L2 (bytes); the no-L2-reuse estimate is printed where one
# gathered node table holds more than twice this
L2_BYTES = 50 * 2 ** 20


def other_target(source: Path, name: str = "ell_kernels",
                 defines=()) -> tuple:
    """(the library ``build_other`` builds ``source`` into, with the
    compiler's output in ``build.log`` beside it; its nvcc flags)."""
    if name not in build.SOURCES:
        raise ValueError(f"no source {name!r}; the sources are "
                         f"{sorted(build.SOURCES)}")
    flags = build._flags(name) + [f"-D{d}" for d in defines]
    tag = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    return build.BUILD_DIR / f"ab-{tag.hexdigest()[:16]}" / "libab.so", flags



def build_other(source: Path, name: str = "ell_kernels",
                defines=()) -> ctypes.CDLL:
    """``source`` built whole (one ``nvcc``, with no part macro, so a
    source in ``build.PARTS`` must build as one file) with the package's
    flags of its source ``name`` (a key of ``build.SOURCES``), with ``-D``
    of each of ``defines``, and the
    package's argument types of ``name`` on its entries; an entry the other
    source does not have (one added since) is left unbound. Prints the
    seconds nvcc took, where it built the library (nothing else builds
    meanwhile)."""
    lib, flags = other_target(source, name, defines)
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        out = subprocess.run(
            [build._nvcc(), *flags, "-o", str(lib), str(source)],
            capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed for {source}:\n{out.stdout}"
                               f"{out.stderr}")
        print(f"built {source} alone in {time.perf_counter() - t0:.1f} s",
              flush=True)
        (lib.parent / "build.log").write_text(out.stdout + out.stderr)
    other = ctypes.CDLL(str(lib))
    entries = {**_ARGTYPES[name], **_QUERIES.get(name, {})}
    for entry, argtypes in entries.items():
        if not hasattr(other, entry):
            continue
        fn = getattr(other, entry)
        fn.argtypes = argtypes
        fn.restype = _RESTYPE.get(entry, ctypes.c_int)
    return other


def arxiv_inputs(device, h: int = H) -> dict:
    """The plan and random node and edge tables of width ``h``, from seed
    0."""
    data = synthetic_node_classification(
        ARXIV["nodes"], ARXIV["edges"], feat_dim=128, num_classes=40,
        seed=ARXIV["seed"])
    fg = build_arxiv_graph(
        data, get_args(["--add-reverse-edge", "--add-self-loop"]), device)
    gen = torch.Generator(device=device).manual_seed(0)
    eq, ek, g = (torch.randn((fg.n_pad, h), generator=gen, device=device)
                 for _ in range(3))
    e = torch.randn((fg.e_pad, h), generator=gen, device=device)
    return dict(fg=fg, eq=eq, ek=ek, g=g, e=e)


def launches(inp: dict, act, fold: int | None = None) -> dict:
    """label -> (entry, ctypes arguments less the stream, outputs) of each
    kernel on ``inp``; with ``fold`` the gathered indices are taken modulo
    ``fold`` rows (only #2 and #4)."""
    fg, bf = inp["fg"], torch.bfloat16
    plan, splan = fg.dst_plan, fg.src_plan
    src, dst = fg.dst_slot_srcnode, fg.src_slot_dstnode
    if fold is not None:
        src, dst = (src % fold).int(), (dst % fold).int()
    eq, ek, g = inp["eq"], inp["ek"], inp["g"]
    ekb, eqb, gb, eb = (t.to(bf) for t in (ek, eq, g, inp["e"]))
    sd, ss = fg.dst_slot_scales["sym"], fg.src_slot_scales["sym"]
    r, rs = plan.row_key.numel(), splan.row_key.numel()
    f32 = dict(dtype=torch.float32, device=eq.device)
    rows, srows = torch.empty((r, H), **f32), torch.empty((r, H), **f32)
    out = torch.empty((rs, H), **f32)
    g_e = torch.zeros((fg.e_pad, H), **f32)
    p = torch.Tensor.data_ptr
    a, sl = act.kernel_id, float(act.param)
    fwd = (p(eq), p(ekb), 1, p(src), p(sd), p(plan.row_key), p(plan.row_ptr),
           r, H, a, sl)
    bwd = (p(eqb), p(gb), 1, p(ek), p(dst), p(ss), p(splan.row_key),
           p(splan.row_ptr), rs, H, a, sl)
    fwde = (p(eq), p(ekb), p(eb), 1, p(src), p(plan.slot_edge), p(sd),
            p(plan.row_key), p(plan.row_ptr), r, H, a, sl)
    bwde = (p(eqb), p(gb), p(eb), 1, p(ek), p(dst), p(splan.slot_edge),
            p(ss), p(splan.row_key), p(splan.row_ptr), rs, H, a, sl)
    runs = {
        "#2 ell_act_reduce2": ("ell_act_reduce2", fwd + (p(rows), p(srows)),
                               (rows, srows)),
        "#4 ell_src_bwd": ("ell_src_bwd", bwd + (p(out),), (out,)),
    }
    if fold is None and act.name in ("leaky_relu", "gelu"):
        runs = {
            "#1 ell_act_reduce": ("ell_act_reduce", fwd + (p(rows),),
                                  (rows,)),
            **runs,
            "#1e ell_act_reduce_edge": ("ell_act_reduce_edge",
                                        fwde + (p(rows),), (rows,)),
            "#2e ell_act_reduce2_edge": ("ell_act_reduce2_edge",
                                         fwde + (p(rows), p(srows)),
                                         (rows, srows)),
            "#4e ell_src_bwd_edge": ("ell_src_bwd_edge",
                                     bwde + (p(out), p(g_e)), (out, g_e)),
        }
    # keep the tensors the pointers point into alive with the arguments
    return {k: (e, args, outs, (src, dst, ekb, eqb, gb, eb))
            for k, (e, args, outs) in runs.items()}


def lab_launches(device) -> tuple:
    """label -> (entry, ctypes arguments less the stream, outputs, library
    call) of #19-#24 at the lab tools' sizes (#23 from gather_dma's table
    and from one of gather_dma.BIG_N rows), on random inputs from seed 0
    made on the card; and the inputs, to keep alive."""
    R, B, H = (kernel_lab.SIZES[k] for k in "RBH")
    S, TSUM = gather_dma.SIZES["S"], gather_dma.SIZES["TSUM"]
    T = gather_dma.SIZES["T"]
    gen = torch.Generator(device=device).manual_seed(0)
    ekg32 = torch.randn((R * B, H), generator=gen, device=device)
    ekg = ekg32.to(torch.bfloat16)
    v = torch.randn((S, H), generator=gen, device=device).to(torch.bfloat16)
    f32 = dict(dtype=torch.float32, device=device)
    rows, rows32 = torch.empty((R, H), **f32), torch.empty((R, H), **f32)
    passed = torch.empty_like(ekg)
    sums = torch.empty((S // TSUM * 8, H), **f32)
    p, n = torch.Tensor.data_ptr, ekg.numel()

    def add():
        return torch.add(ekg, 1.0)

    runs = {
        "#19 lab_copy (4 in flight)": (
            "lab_copy", (p(ekg), R, B, H, 4, p(rows)), (rows,),
            lambda: torch.sum(ekg.view(R, B, H), 1, dtype=torch.float32)),
        **{f"#20 lab_copy32 ({u} in flight)": (
            "lab_copy32", (p(ekg32), R, B, H, u, p(rows32)), (rows32,),
            lambda: ekg32.view(R, B, H).sum(1)) for u in INFLIGHT},
        "#21 lab_pass": ("lab_pass", (p(ekg), n, p(passed)), (passed,), add),
        **{f"#22 lab_pass2 ({sem})": (
            "lab_pass2", (p(ekg), n, PASS2_TILE_ROWS * H, persistent,
                          p(passed)), (passed,), add)
           for sem, persistent in (("parallel", 0), ("persistent", 1))},
        "#24 lab_tile_sum": (
            "lab_tile_sum", (p(v), S // TSUM, TSUM, H, p(sums)), (sums,),
            lambda: torch.sum(v.view(-1, TSUM, H), 1, dtype=torch.float32)),
    }
    keep = [ekg32, ekg, v]
    gathered = torch.empty((S // T, 8, H), **f32)
    for n in (gather_dma.SIZES["N"], gather_dma.BIG_N):
        tbl = torch.randn((n, H), generator=gen, device=device).to(
            torch.bfloat16)
        idx = torch.randint(0, n, (S,), generator=gen, device=device,
                            dtype=torch.int32)
        keep += [tbl, idx]
        runs[f"#23 lab_gather ({n * H * 2 / 1e6:.1f} MB table)"] = (
            "lab_gather", (p(tbl), p(idx), S // T, T, H, p(gathered)),
            (gathered,), _embedding_bag(idx.view(-1, T), tbl))
    return runs, keep


def _embedding_bag(bags, weight):
    """One ``F.embedding_bag`` sum over each row of ``bags`` (in f32 where
    the build has no bf16 embedding_bag)."""
    import torch.nn.functional as F

    def call(w):
        return lambda: F.embedding_bag(bags, w, mode="sum")

    try:
        call(weight)()
        return call(weight)
    except RuntimeError:
        return call(weight.float())


def _fmt(ms: list) -> str:
    """The turns' ms, with their median and spread past two turns."""
    turns = " / ".join(f"{x:.4f}" for x in ms)
    if len(ms) <= 2:
        return f"{turns} ms"
    return (f"median {statistics.median(ms):.4f} [{min(ms):.4f}-"
            f"{max(ms):.4f}] ms ({turns})")


def ab(label: str, entry: str, args, outs, libs: dict, library=None,
       rounds: int = 2, iters: int = ITERS) -> dict:
    """Run ``entry`` from both libraries, and ``library`` (a PyTorch call)
    if given, in ``rounds`` alternating turns; print and return the ms of
    each turn and the largest difference of the two libraries' outputs."""
    stream = torch.cuda.current_stream().cuda_stream
    calls = {k: (lambda fn=getattr(lib, entry): fn(*args, stream))
             for k, lib in libs.items()}
    got = {}
    for k, call in calls.items():
        code = call()
        if code:
            raise RuntimeError(f"{k} {entry}: CUDA error {code}")
        torch.cuda.synchronize()
        got[k] = [o.clone() for o in outs]
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got["other"], got["this"]))
    if library is not None:
        calls["library"] = library
    ms = alternating_ms(calls, iters, rounds)
    line = ", ".join(f"{k} {_fmt(v)}" for k, v in ms.items())
    if library is not None:
        line += ", " + ", ".join(
            f"{k} {verdict(ms[k], ms['library'])}" for k in libs)
    print(f"{label}: {line}, max |diff| {diff:.3e}", flush=True)
    return dict(ms=ms, diff=diff)


def run(device, other: Path, probes: bool = False) -> dict:
    """Every A/B line of the ELL kernels (and with ``probes`` the folded
    ones); returns label -> record."""
    libs = {"other": build_other(other, "ell_kernels"),
            "this": _library("ell_kernels")}
    inp = arxiv_inputs(device)
    recs = {}
    for act in (leaky_relu(0.2), tanh, gelu()):
        for label, (entry, args, outs, _) in launches(inp, act).items():
            recs[f"{label} ({act.name})"] = ab(f"{label} ({act.name}, bf16)",
                                               entry, args, outs, libs)
    if probes:
        n = inp["fg"].n_pad
        for fold in [n // k for k in FOLDS] + [FOLD_ROWS]:
            tag = f"gathers folded into {fold} rows"
            for label, (entry, args, outs, _) in launches(
                    inp, leaky_relu(0.2), fold).items():
                recs[f"{label} ({tag})"] = ab(f"{label} ({tag})", entry,
                                              args, outs, libs)
    return recs


def run_lab(device, other: Path) -> dict:
    """Every A/B line of the lab's streams; returns label -> record. Raises
    if the passthroughs of the two libraries differ."""
    libs = {"other": build_other(other, "lab_kernels"),
            "this": _library("lab_kernels")}
    runs, _inputs = lab_launches(device)
    recs = {}
    for label, (entry, args, outs, library) in runs.items():
        recs[label] = ab(label, entry, args, outs, libs, library,
                         LAB_ROUNDS, LAB_ITERS)
        if "pass" in entry and recs[label]["diff"] != 0:
            raise AssertionError(f"{label}: the two builds' outputs differ")
    return recs


def max_tiles(row_ptr, valid, warps: int) -> dict:
    """The 16-slot tiles the max kernels walk on a plan with ``warps``
    warps in the grid (host mirror of ``warp_rows`` and ``next_tile`` in
    csrc/ell_max_kernels.cu): each warp takes the rows that start in its
    share of the slots and walks their slots 16 at a time. Returns the
    tile count and the shares of the tiles' 16 rows that hold a slot and
    a valid slot."""
    import numpy as np

    ptr = np.asarray(row_ptr, np.int64)
    total = int(ptr[-1])
    cuts = total * np.arange(warps + 1, dtype=np.int64) // warps
    first = np.minimum(np.searchsorted(ptr, cuts, side="left"), ptr.size - 1)
    first[-1] = ptr.size - 1
    slots = np.diff(ptr[first])
    tiles = int((-(-slots // 16)).sum())
    rows = 16 * max(tiles, 1)
    return dict(tiles=tiles, slot_share=total / rows,
                valid_share=int(np.count_nonzero(valid)) / rows)


def roman_inputs(device, h: int) -> dict:
    """A graph of roman-empire's size (the heterophilous trainer's synthetic
    stand-in, ``ROMAN``) and random node and edge tables of width ``h``,
    from seed 0, as ``arxiv_inputs``."""
    from ..experiments.heterophilous import train as het

    args = het._parser().parse_args([
        "--dataset", "roman-empire", "--synthetic-nodes",
        str(ROMAN["nodes"]), "--synthetic-edges", str(ROMAN["edges"])])
    fg = het.prepare(args, 0, 0, device)["graph"]
    gen = torch.Generator(device=device).manual_seed(0)
    eq, ek, g = (torch.randn((fg.n_pad, h), generator=gen, device=device)
                 for _ in range(3))
    e = torch.randn((fg.e_pad, h), generator=gen, device=device)
    return dict(fg=fg, eq=eq, ek=ek, g=g, e=e)


def max_launches(lib, inp: dict, w, gsc, act, part) -> dict:
    """#9, #10 and #11 of one library on ``inp`` (edges of ``inp["dtype"]``,
    bf16 by default; the dst scales ``inp["scale"]``, by default the plan's
    sum scales): name -> a call that launches it; and the outputs, #10 and
    #11 against the library's own forward's maxima. ``part``: #11's
    scratch, large enough for either library."""
    fg = inp["fg"]
    plan = fg.dst_plan
    h, o = w.shape
    dtype = inp.get("dtype", torch.bfloat16)
    bf = int(dtype == torch.bfloat16)
    eq, ekb = inp["eq"], inp["ek"].to(dtype)
    scale = inp.get("scale", fg.dst_slot_scales["sum"])
    r, s = plan.row_key.numel(), plan.slot_edge.numel()
    p = torch.Tensor.data_ptr
    f32 = dict(dtype=torch.float32, device=eq.device)
    a, sl = act.kernel_id, float(act.param)
    stream = torch.cuda.current_stream().cuda_stream
    base = (p(eq), p(ekb), bf, p(fg.dst_slot_srcnode), p(scale),
            p(plan.row_key), p(plan.row_ptr), p(w))
    rows, counts = torch.empty((r, o), **f32), torch.empty((r, o), **f32)
    blocks = lib.ell_max_bwd_blocks(r, h, o, a, bf, 0)  # no edge term
    if blocks <= 0:
        raise RuntimeError(f"ell_max_bwd cannot take H = {h}, O = {o}")
    geq = torch.empty((r, h), **f32)
    gz = torch.empty((s, h), dtype=dtype, device=eq.device)
    gw = torch.empty((h, o), **f32)

    def check(code, entry):
        if code:
            raise RuntimeError(f"{entry}: CUDA error {code}")

    def fwd():
        check(lib.ell_max_fwd(*base, r, h, o, a, sl, p(rows), stream),
              "ell_max_fwd")

    fwd()
    key_max = plan.finalize_rows_max(rows).contiguous()

    def count():
        check(lib.ell_max_wincount(*base, p(key_max), r, h, o, a, sl,
                                   p(counts), stream), "ell_max_wincount")

    def bwd():
        check(lib.ell_max_bwd(*base, p(key_max), p(gsc), r, h, o, a, sl,
                              blocks, p(geq), p(gz), p(part), p(gw), stream),
              "ell_max_bwd")

    count()
    bwd()
    torch.cuda.synchronize()
    outs = dict(rows=rows.clone(), counts=counts.clone(), geq=geq.clone(),
                gz=gz.float(), gw=gw.clone(), key_max=key_max.clone(),
                keep=(ekb, key_max, scale))
    return dict(fwd=fwd, count=count, bwd=bwd), outs


def max_scratch(libs: dict, inp: dict, h: int, o: int, act) -> torch.Tensor:
    """#11's scratch for every library: the most floats any needs, each
    library's g_W partials ([blocks][H * O]) and, on this library's wide
    path, its slots' rows (``ell_max_bwd_scratch``; a library without that
    entry needs its partials only)."""
    plan = inp["fg"].dst_plan
    r, s = plan.row_key.numel(), plan.slot_edge.numel()
    bf = int(inp.get("dtype", torch.bfloat16) == torch.bfloat16)
    need = 0
    for lib in libs.values():
        blocks = lib.ell_max_bwd_blocks(r, h, o, act.kernel_id, bf, 0)
        if blocks <= 0:
            raise RuntimeError(f"ell_max_bwd cannot take H = {h}, O = {o}")
        floats = (lib.ell_max_bwd_scratch(s, blocks, h, o)
                  if hasattr(lib, "ell_max_bwd_scratch") else blocks * h * o)
        need = max(need, floats)
    return torch.empty(need, dtype=torch.float32, device=inp["eq"].device)


def run_max(device, other: Path, h: int = H, defines=()) -> dict:
    """Every A/B line of #9-#11 at W [h, h]; returns label -> record."""
    libs = {"other": build_other(other, "ell_max_kernels", defines),
            "this": _library("ell_max_kernels")}
    # the arxiv plan at its width; the heterophilous width on a graph of
    # roman-empire's size (#11 at the arxiv plan's 2.6M slots would take
    # seconds a launch there on the first design)
    inp = arxiv_inputs(device, h) if h == H else roman_inputs(device, h)
    gen = torch.Generator(device=device).manual_seed(1)
    w = ((torch.rand((h, h), generator=gen, device=device) * 2 - 1)
         / h ** 0.5)
    gsc = torch.randn((inp["fg"].n_pad, h), generator=gen, device=device)
    plan = inp["fg"].dst_plan
    lay = ell_max_layout(h, h)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    # the wide path walks a block's share of the rows, the first design a
    # warp's, in subtiles of 16 slots either way
    st = max_tiles(plan.host["row_ptr"], plan.host["slot_valid"],
                   sms * (1 if lay.wide else lay.fwd_warps))
    print(f"layout at H = O = {h}: {lay}", flush=True)
    if defines:  # the other build is this source: its codes decode alike
        print(f"the other build's layout: "
              f"{decode_max_layout(libs['other'].ell_max_layout(h, h))}",
              flush=True)
    print(f"plan: S {plan.num_slots}, R {plan.num_rows}, valid slots "
          f"{int(plan.host['slot_valid'].sum())}; tiles: {st['tiles']} of "
          f"16 slots; slots fill {100 * st['slot_share']:.1f}% of their "
          f"rows, valid slots {100 * st['valid_share']:.1f}%", flush=True)
    recs = {"tiles": st}
    # the arxiv width times leaky_relu (and #11 with tanh); the wide
    # width erf-GELU, the heterophilous sigma, and leaky_relu
    acts = (leaky_relu(0.2), tanh) if h == H else (gelu(), leaky_relu(0.2))
    for act in acts:
        part = max_scratch(libs, inp, h, h, act)
        runs = {k: max_launches(lib, inp, w, gsc, act, part)
                for k, lib in libs.items()}
        o, t = runs["other"][1], runs["this"][1]
        differ = int((o["counts"] != t["counts"]).sum())
        diffs = {k: float((o[k] - t[k]).abs().max())
                 for k in ("rows", "geq", "gz", "gw")}
        same = {k: torch.equal(o[k], t[k])
                for k in ("rows", "counts", "geq", "gz", "gw")}
        ref = o["gw"].abs()
        gw_ok = bool(((o["gw"] - t["gw"]).abs()
                      <= GW_TOL["atol"] + GW_TOL["rtol"] * ref
                      + GW_TOL["amax"] * float(ref.max())).all())
        print(f"{act.name}: max |diff| of the maxima {diffs['rows']:.3e}; "
              f"counts differ at {differ} of {t['counts'].numel()} (row, o); "
              f"max |diff| geq_rows {diffs['geq']:.3e}, g_z {diffs['gz']:.3e},"
              f" g_W {diffs['gw']:.3e} ({'within' if gw_ok else 'BEYOND'} "
              f"GW_TOL)", flush=True)
        print(f"{act.name}: the other build's bits: " + ", ".join(
            f"{k} {'same' if v else 'differ'}" for k, v in same.items()),
            flush=True)
        names = {"fwd": "#9 ell_max_fwd", "count": "#10 ell_max_wincount",
                 "bwd": "#11 ell_max_bwd"}
        for key, label in names.items():
            if h == H and act.name != "leaky_relu" and key != "bwd":
                continue
            ms = alternating_ms({k: r[0][key] for k, r in runs.items()},
                                MAX_ITERS, MAX_ROUNDS)
            line = ", ".join(f"{k} {_fmt(v)}" for k, v in ms.items())
            gain = statistics.median(ms["other"]) / statistics.median(
                ms["this"])
            print(f"{label} ({act.name}, bf16, H = O = {h}): {line}, "
                  f"this/other {gain:.2f}x faster", flush=True)
            recs[f"{label} ({act.name}, {h})"] = dict(
                ms=ms, counts_differ=differ, same_bits=same, gw_within=gw_ok,
                **diffs)
        del runs, part
    return recs


def edge_launches(lib, inp: dict, eb, we, act, dtype) -> tuple:
    """#7 and #8 of one library on ``inp`` with edges of ``dtype``: name
    -> a call that launches it; and the outputs after one launch each."""
    fg = inp["fg"]
    plan, splan = fg.dst_plan, fg.src_plan
    eq, ek, g = inp["eq"], inp["ek"], inp["g"]
    ekt, eqt, gt = (t.to(dtype) for t in (ek, eq, g))
    h, de = we.shape[1], we.shape[0]
    r, rs = plan.row_key.numel(), splan.row_key.numel()
    p = torch.Tensor.data_ptr
    f32 = dict(dtype=torch.float32, device=eq.device)
    a, sl, bf = act.kernel_id, float(act.param), int(dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    blocks = lib.ell_edge_src_bwd_blocks(rs, h, de, a, bf)
    if blocks <= 0:
        raise RuntimeError(f"ell_edge_src_bwd cannot take H = {h}, De = "
                           f"{de}")
    rows, srows = torch.empty((r, h), **f32), torch.empty((r, h), **f32)
    out = torch.empty((rs, h), **f32)
    part = torch.empty((blocks, de * h), **f32)
    gwe = torch.empty((de, h), **f32)

    def check(code, entry):
        if code:
            raise RuntimeError(f"{entry}: CUDA error {code}")

    def fwd():
        check(lib.ell_edge_act_reduce2(
            p(eq), p(ekt), bf, p(eb), p(we), p(fg.dst_slot_srcnode),
            p(plan.slot_edge), p(fg.dst_slot_scales["sym"]),
            p(plan.row_key), p(plan.row_ptr), r, h, de, a, sl, p(rows),
            p(srows), stream), "ell_edge_act_reduce2")

    def bwd():
        check(lib.ell_edge_src_bwd(
            p(eqt), p(gt), bf, p(ek), p(eb), p(we), p(fg.src_slot_dstnode),
            p(splan.slot_edge), p(fg.src_slot_scales["sym"]),
            p(splan.row_key), p(splan.row_ptr), rs, h, de, a, sl,
            blocks, p(out), p(part), p(gwe), stream), "ell_edge_src_bwd")

    fwd()
    bwd()
    torch.cuda.synchronize()
    outs = dict(rows=rows.clone(), srows=srows.clone(), out=out.clone(),
                gwe=gwe.clone(), keep=(ekt, eqt, gt, part, blocks))
    return dict(fwd=fwd, bwd=bwd), outs


def edge_no_reuse_estimate(inp: dict, de: int, dtype) -> tuple:
    """(ms, GB) of #8's no-L2-reuse estimate at 3.35 TB/s: each valid src
    slot (scale not 0) reads its eq and g rows (``dtype``) and its f32
    basis row from device memory, each row its f32 ek row and writes its
    f32 output row, every slot's index, edge id and scale and each row's
    range and key are read once. Not a floor: a row the L2 still holds
    costs less; printed where one gathered table holds more than twice the
    L2 (``L2_BYTES``)."""
    fg = inp["fg"]
    splan = fg.src_plan
    h = inp["eq"].shape[1]
    valid = int((fg.src_slot_scales["sym"] != 0).sum())
    rows, row = splan.row_key.numel(), h * torch.tensor(
        [], dtype=dtype).element_size()
    nbytes = (valid * (2 * row + 4 * de) + rows * h * 4 * 2
              + splan.num_slots * 12 + rows * 8)
    return nbytes / 3.35e12 * 1e3, nbytes / 1e9


def run_edge(device, other: Path, h: int = H, de: int = EDGE_DE) -> dict:
    """Every A/B line of #7 and #8 at width ``h`` and basis width ``de``;
    returns label -> record."""
    libs = {"other": build_other(other, "ell_edge_kernels"),
            "this": _library("ell_edge_kernels")}
    for fn, regs, spill in build.ptxas_entries(
            build.build_log("ell_edge_kernels")):
        if TILES_ENTRIES.search(fn):
            print(f"build this: {TILES_ENTRIES.search(fn).group(0)}: {regs} "
                  f"registers, {spill} B spill stores", flush=True)
    inp = arxiv_inputs(device, h)
    gen = torch.Generator(device=device).manual_seed(0)
    eb = torch.randn((inp["fg"].e_pad, de), generator=gen, device=device)
    we = 0.3 * torch.randn((de, h), generator=gen, device=device)
    recs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        for act in (leaky_relu(0.2), tanh, gelu()):
            print(f"layout at H = {h}, De = {de} ({act.name}, {dt}): "
                  f"{ell_edge_layout(h, de, act, dtype)}", flush=True)
            runs = {k: edge_launches(lib, inp, eb, we, act, dtype)
                    for k, lib in libs.items()}
            o, t = runs["other"][1], runs["this"][1]
            diffs = {k: float((o[k] - t[k]).abs().max())
                     for k in ("rows", "srows", "out", "gwe")}
            equal = [k for k in diffs if torch.equal(o[k], t[k])]
            ref = o["gwe"].abs()
            gw_ok = bool(((o["gwe"] - t["gwe"]).abs() <= GW_TOL["atol"]
                          + GW_TOL["amax"] * float(ref.max())
                          + GW_TOL["rtol"] * ref).all())
            print(f"{act.name}, {dt}: max |diff| rows {diffs['rows']:.3e}, "
                  f"srows {diffs['srows']:.3e}, g_ek rows {diffs['out']:.3e},"
                  f" g_WE {diffs['gwe']:.3e} (largest entry "
                  f"{float(ref.max()):.3e}, within GW_TOL: {gw_ok}); "
                  f"bitwise equal: {', '.join(equal) or 'none'}; #8's "
                  f"blocks: other {o['keep'][-1]}, this {t['keep'][-1]}",
                  flush=True)
            names = {"fwd": "#7 ell_edge_act_reduce2",
                     "bwd": "#8 ell_edge_src_bwd"}
            for key, label in names.items():
                ms = alternating_ms({k: r[0][key] for k, r in runs.items()},
                                    EDGE_ITERS, EDGE_ROUNDS)
                line = ", ".join(f"{k} {_fmt(v)}" for k, v in ms.items())
                this = statistics.median(ms["this"])
                gain = statistics.median(ms["other"]) / this
                est, note = None, ""
                if key == "bwd" and inp["eq"].shape[0] * h * torch.tensor(
                        [], dtype=dtype).element_size() > 2 * L2_BYTES:
                    est, gb = edge_no_reuse_estimate(inp, de, dtype)
                    note = (f"; no-L2-reuse estimate {est:.4f} ms ({gb:.3f} "
                            f"GB), this at {100 * est / this:.1f}% of it")
                print(f"{label} ({act.name}, {dt}): {line}, this/other "
                      f"{gain:.2f}x faster{note}", flush=True)
                recs[f"{label} ({act.name}, {dt})"] = dict(
                    ms=ms, equal=equal, gw_within_tol=gw_ok,
                    no_reuse_ms=est, **diffs)
    return recs


def general_launches(lib, inp: dict, act, dtype) -> tuple:
    """#1r, #3, #4r, #5 and #6, and for a row-wise sigma #1r·e, #3·e and
    #4r·e, of one library on ``inp`` with the gathered tables in ``dtype`` (ek
    and e for the dst-major kernels, eq, g and e for the src-major ones):
    name -> a call that launches it; and the outputs after one launch
    each, with the layout this library reports for each kernel."""
    fg = inp["fg"]
    plan, splan = fg.dst_plan, fg.src_plan
    eq, ek, g = inp["eq"], inp["ek"], inp["g"]
    h = eq.shape[1]
    ekt, eqt, gt = (t.to(dtype) for t in (ek, eq, g))
    both = torch.cat([eqt, gt], 1)
    edge = not act.diagonal
    et = inp["e"].to(dtype) if edge else None
    r, rs = plan.row_key.numel(), splan.row_key.numel()
    p = torch.Tensor.data_ptr
    f32 = dict(dtype=torch.float32, device=eq.device)
    a, prm, bf = act.kernel_id, float(act.param), int(dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    outs = dict(rows=torch.empty((r, h), **f32),
                geq=torch.empty((r, h), **f32),
                out=torch.empty((rs, h), **f32),
                fused=torch.empty((rs, h), **f32),
                gz=torch.empty((plan.num_slots, h), dtype=dtype,
                               device=eq.device),
                geq6=torch.empty((r, h), **f32))
    if edge:
        outs.update(rows_e=torch.empty((r, h), **f32),
                    geq_e=torch.empty((r, h), **f32),
                    out_e=torch.empty((rs, h), **f32),
                    g_e=torch.zeros((fg.e_pad, h), **f32))
    sd, ss = fg.dst_slot_scales["sym"], fg.src_slot_scales["sym"]
    dst = (p(sd), p(plan.row_key), p(plan.row_ptr), r, h, a, prm)
    src = (p(ss), p(splan.row_key), p(splan.row_ptr), rs, h, a, prm)

    def call(entry, *args):
        def run():
            code = getattr(lib, entry)(*args, stream)
            if code:
                raise RuntimeError(f"{entry}: CUDA error {code}")
        return run

    calls = {
        "#1r": call("ell_act_reduce_rowwise", p(eq), p(ekt), bf,
                    p(fg.dst_slot_srcnode), *dst, p(outs["rows"])),
        "#3": call("ell_geq_reduce", p(eq), p(ekt), bf, p(g),
                   p(fg.dst_slot_srcnode), *dst, p(outs["geq"])),
        "#4r": call("ell_src_bwd_rowwise", p(eqt), p(gt), bf, p(ek),
                    p(fg.src_slot_dstnode), *src, p(outs["out"])),
        "#5": call("ell_src_bwd_fused", p(both), bf, p(ek),
                   p(fg.src_slot_dstnode), *src, p(outs["fused"])),
        "#6": call("ell_act_reduce_bwd", p(eq), p(ekt), bf, p(g),
                   p(fg.dst_slot_srcnode), *dst, bf, p(outs["geq6"]),
                   p(outs["gz"])),
    }
    tables = {"#1r": ("ell_act_reduce_rowwise", eq, ekt, outs["rows"]),
              "#3": ("ell_geq_reduce", eq, ekt, g, outs["geq"]),
              "#4r": ("ell_src_bwd_rowwise", eqt, gt, ek, outs["out"]),
              "#5": ("ell_src_bwd_fused", both, ek, outs["fused"]),
              "#6": ("ell_act_reduce_bwd", eq, ekt, g, outs["gz"],
                     outs["geq6"])}
    if edge:
        calls["#1r·e"] = call(
            "ell_act_reduce_rowwise_edge", p(eq), p(ekt), p(et), bf,
            p(fg.dst_slot_srcnode), p(plan.slot_edge), *dst,
            p(outs["rows_e"]))
        calls["#3·e"] = call(
            "ell_geq_reduce_edge", p(eq), p(ekt), p(et), bf, p(g),
            p(fg.dst_slot_srcnode), p(plan.slot_edge), *dst,
            p(outs["geq_e"]))
        calls["#4r·e"] = call(
            "ell_src_bwd_rowwise_edge", p(eqt), p(gt), p(et), bf, p(ek),
            p(fg.src_slot_dstnode), p(splan.slot_edge), *src,
            p(outs["out_e"]), p(outs["g_e"]))
        tables["#1r·e"] = ("ell_act_reduce_rowwise_edge", eq, ekt, et,
                           outs["rows_e"])
        tables["#3·e"] = ("ell_geq_reduce_edge", eq, ekt, et, g,
                          outs["geq_e"])
        tables["#4r·e"] = ("ell_src_bwd_rowwise_edge", eqt, gt, et, ek,
                           outs["out_e"], outs["g_e"])
    for run in calls.values():
        run()
    torch.cuda.synchronize()
    layouts = {tag: ell_general_layout(name, h, dtype, act, *ts, lib=lib)
               for tag, (name, *ts) in tables.items()}
    # the calls hold raw pointers: keep what they point into alive; a
    # launch writes the same outputs again, so the timed launches leave
    # them as they are
    return calls, dict(**outs, layouts=layouts, keep=(ekt, eqt, gt, both, et))


def wide_build_report(log: str, h: int, what: str) -> list:
    """Lines of ``-Xptxas -v``'s registers and spill stores for each entry
    of ``WIDE_ENTRIES`` in the compiler output ``log`` of the build
    ``what``, with the warps an SM holds at H = ``h`` (8-warp blocks; the
    lane groups' key rows in 2 H floats of shared memory a warp), reckoned
    from the registers and shared memory, not measured. Raises if the
    report names none of them."""
    lines = []
    for fn, regs, spill in build.ptxas_entries(log):
        k = WIDE_ENTRIES.search(fn)
        if k:
            # a lane-group warp's f32 key rows, two buffers (#3: eq and g)
            keys = 2 if k.group("mode") == "0" else 1
            smem = 8 * 2 * keys * h * 4 if k.group("group") else 0
            per_warp = -(-regs * 32 // 256) * 256
            blocks = min(65536 // (8 * per_warp), 8,
                         233472 // (smem + 1024))
            lines.append(f"{k.group(0)}: {regs} registers, {spill} B spill "
                         f"stores, {8 * blocks} warps an SM")
    if not lines:
        raise RuntimeError(f"the compiler output of {what} names no entry "
                           f"of WIDE_ENTRIES ({len(log)} characters)")
    return lines


def gate_rows(inp: dict, act, dtype, edge: bool,
              chunk: int = 1 << 18) -> dict:
    """Under centered_relu: bool masks of the src plan's rows ("rows") and
    of the per-edge cotangent's rows ("edges") that hold a valid slot with
    a near gate (``checks.near_gate``) at the src-major kernels' z (eq,
    with the edge row added when ``edge``, gathered in ``dtype``, plus the
    f32 key row), and of the dst plan's rows ("dst_rows") at #3's z (ek,
    with the edge row added when ``edge``, gathered in ``dtype``, plus the
    f32 eq row), taken ``chunk`` slots at a time; empty for another
    sigma."""
    if act.name != "centered_relu":
        return {}
    fg = inp["fg"]
    plan = fg.dst_plan
    ekt = inp["ek"].to(dtype)
    et = inp["e"].to(dtype) if edge else None
    dnear = torch.zeros(plan.num_slots, dtype=torch.bool,
                        device=ekt.device)
    sd = fg.dst_slot_scales["sym"]
    for s0 in range(0, plan.num_slots, chunk):
        s = slice(s0, min(s0 + chunk, plan.num_slots))
        kv = ekt.index_select(0, fg.dst_slot_srcnode[s])
        if edge:
            kv = add_cast(kv, et.index_select(0, plan.slot_edge[s]))
        z = kv.float() + inp["eq"].index_select(0, plan.slot_key[s])
        dnear[s] = near_gate(z, sd[s], act).any(1)
    del ekt, et
    splan = fg.src_plan
    eqt = inp["eq"].to(dtype)
    et = inp["e"].to(dtype) if edge else None
    sc = fg.src_slot_scales["sym"]
    near = torch.zeros(splan.num_slots, dtype=torch.bool,
                       device=eqt.device)
    for s0 in range(0, splan.num_slots, chunk):
        s = slice(s0, min(s0 + chunk, splan.num_slots))
        z = eqt.index_select(0, fg.src_slot_dstnode[s])
        if edge:
            z = add_cast(z, et.index_select(0, splan.slot_edge[s]))
        z = z.float() + inp["ek"].index_select(0, splan.slot_key[s])
        near[s] = near_gate(z, sc[s], act).any(1)
    edges = torch.zeros(fg.e_pad, dtype=torch.bool, device=near.device)
    edges[splan.slot_edge[near].long()] = True
    return dict(rows=slot_rows(splan, near), edges=edges,
                dst_rows=slot_rows(plan, dnear))


def no_reuse_estimate(tag: str, inp: dict, dtype) -> tuple:
    """(ms, GB) of ``tag``'s no-L2-reuse estimate at 3.35 TB/s: each valid
    slot (scale not 0) reads its gathered rows (``GENERAL_ROWS``) from
    device memory, each row its f32 key rows and writes its f32 output
    row, and every slot's index, scale (and edge id) is read once; #6 also
    writes every slot's g_z row, #4r·e each valid slot's f32 g_e row. Not
    a floor: a row the L2 still holds costs less (at H = 96 kernels beat
    it by up to 6%), so it is printed only where one gathered node table
    holds more than twice the L2 (``L2_BYTES``), as at H = 512."""
    fg = inp["fg"]
    h = inp["eq"].shape[1]
    src = tag.startswith(("#4r", "#5"))
    plan = fg.src_plan if src else fg.dst_plan
    sc = (fg.src_slot_scales if src else fg.dst_slot_scales)["sym"]
    valid, rows, slots = int((sc != 0).sum()), plan.row_key.numel(), \
        plan.num_slots
    row = h * torch.tensor([], dtype=dtype).element_size()
    keys = 2 if tag in ("#3", "#3·e", "#6") else 1
    nbytes = (valid * GENERAL_ROWS[tag] * row + rows * h * 4 * (keys + 1)
              + slots * (12 if tag.endswith("·e") else 8) + rows * 8)
    if tag == "#6":
        nbytes += slots * row
    if tag == "#4r·e":
        nbytes += valid * h * 4
    return nbytes / 3.35e12 * 1e3, nbytes / 1e9


def run_general(device, other: Path, h: int = H) -> dict:
    """Every A/B line of ``GENERAL_AB`` at width ``h``, each output held to
    the other build's as ``GENERAL_HELD`` says, and #6's rows to #3's bits
    where both take the lane-group path; returns label -> record. Raises
    at the end if an output held to the other build's bits differs, or
    lies beyond its tolerance, or #6's rows differ from #3's."""
    libs = {"other": build_other(other, "ell_general_kernels"),
            "this": _library("ell_general_kernels")}
    other_log = other_target(other, "ell_general_kernels")[0].with_name(
        "build.log")
    logs = {"other": other_log.read_text() if other_log.exists() else "",
            "this": build.build_log("ell_general_kernels")}
    for k, text in logs.items():
        for line in wide_build_report(text, h, f"the {k} build"):
            print(f"build {k}: {line}", flush=True)
    inp = arxiv_inputs(device, h)
    # one gathered node table past twice the L2: print the estimate
    past_l2 = {dtype: inp["eq"].shape[0] * h * torch.tensor(
        [], dtype=dtype).element_size() > 2 * L2_BYTES
        for dtype in (torch.bfloat16, torch.float32)}
    recs, faults = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        for act in (centered_relu(0.5), softmax, leaky_relu(0.2), tanh):
            timed = GENERAL_AB["elementwise" if act.diagonal else "rowwise"]
            runs = {k: general_launches(lib, inp, act, dtype)
                    for k, lib in libs.items()}
            o, t = runs["other"][1], runs["this"][1]
            setting = f"{act.name}, {dt}"
            for k in ("other", "this"):
                print(f"layout at H = {h} ({setting}), {k}: " + ", ".join(
                    f"{tag} {v}" for tag, v in runs[k][1]["layouts"].items()),
                    flush=True)
            held, gates = {}, {}
            for key, (tag, tol) in GENERAL_HELD.items():
                if key not in t:
                    continue
                if o["layouts"][tag] == t["layouts"][tag]:
                    same = torch.equal(o[key], t[key])
                    held[key] = "same bits" if same else "DIFFERENT bits"
                    if not same:
                        faults.append(f"{setting}: {key} differs")
                    continue
                if tol == "step":
                    tol = BF16_STEP if dtype == torch.bfloat16 else BWD_TOL
                diff = (o[key].float() - t[key].float()).abs()
                over = (diff > tol["atol"] + tol["rtol"]
                        * o[key].float().abs()).any(1)
                note = ""
                if key in GATE_ROWS and act.name == "centered_relu":
                    which, edge = GATE_ROWS[key]
                    if edge not in gates:
                        gates[edge] = gate_rows(inp, act, dtype, edge)
                    mask = gates[edge][which]
                    note = (f" ({int((over & mask).sum())} more in the "
                            f"{int(mask.sum())} rows with a near gate, "
                            f"left out)")
                    over &= ~mask
                beyond = int(over.sum())
                name = ("BF16_STEP" if tol is BF16_STEP else
                        "FWD_TOL" if tol is FWD_TOL else "BWD_TOL")
                held[key] = (f"path changed: max |diff| "
                             f"{float(diff.max()):.3e}, {beyond} of "
                             f"{over.numel()} rows beyond {name}{note}")
                del diff, over
                if beyond:
                    faults.append(f"{setting}: {key} beyond {name}")
            del gates
            print(f"{setting} against the other build: " + "; ".join(
                f"{k} {v}" for k, v in held.items()), flush=True)
            if (isinstance(t["layouts"]["#3"], GeneralLayout)
                    and isinstance(t["layouts"]["#6"], GeneralLayout)):
                same = torch.equal(t["geq6"], t["geq"])
                print(f"{setting}: #6's rows {'are' if same else 'are NOT'} "
                      f"#3's bits", flush=True)
                if not same:
                    faults.append(f"{setting}: #6's rows differ from #3's")
            for tag in timed:
                label, key = GENERAL_KERNELS[tag]
                ms = alternating_ms({k: r[0][tag] for k, r in runs.items()},
                                    GENERAL_ITERS, GENERAL_ROUNDS)
                line = ", ".join(f"{k} {_fmt(v)}" for k, v in ms.items())
                this = statistics.median(ms["this"])
                gain = statistics.median(ms["other"]) / this
                est, note = None, ""
                if past_l2[dtype]:
                    est, gb = no_reuse_estimate(tag, inp, dtype)
                    note = (f"; no-L2-reuse estimate {est:.4f} ms ({gb:.3f} "
                            f"GB), this at {100 * est / this:.1f}% of it")
                print(f"{label} ({setting}): {line}, this/other {gain:.2f}x "
                      f"faster{note}; {held[key]}", flush=True)
                recs[f"{label} ({setting})"] = dict(
                    ms=ms, held=held[key], no_reuse_ms=est)
            del runs, o, t
    if faults:
        raise AssertionError("; ".join(faults))
    return recs


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        "same-card A/B of two builds of the port's ELL or lab kernels")
    p.add_argument("other", type=Path,
                   help="a source with the C interface of ell_kernels.cu "
                        "(with --lab, of lab_kernels.cu; with --max, of "
                        "ell_max_kernels.cu; with --edge, of "
                        "ell_edge_kernels.cu; with --general, of "
                        "ell_general_kernels.cu)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--lab", action="store_true",
                      help="time the lab's streams and gather (#19-#24) "
                           "with their library calls")
    mode.add_argument("--max", action="store_true",
                      help="time the max kernels #9-#11 (ell_max_kernels.cu)")
    mode.add_argument("--edge", action="store_true",
                      help="time the fused-edge kernels #7 and #8 "
                           "(ell_edge_kernels.cu)")
    mode.add_argument("--general", action="store_true",
                      help="time the general route's #1r, #3, #4r, #5 "
                           "and #6 (ell_general_kernels.cu); #1r, #3, #4r "
                           "and #5 must give the other build's bits")
    p.add_argument("--probes", action="store_true",
                   help="also time #2 and #4 with their gathers folded "
                        "into a smaller table")
    p.add_argument("--hidden", type=int, default=H,
                   help="with --edge or --general: the width H of the node "
                        "rows; with --max: H = O, past 96 on a graph of "
                        "roman-empire's size")
    p.add_argument("--de", type=int, default=EDGE_DE,
                   help="with --edge: the width De of the edge basis")
    p.add_argument("--define", action="append", default=[],
                   metavar="NAME",
                   help="with --max: build the other source with -DNAME "
                        "(ELL_MAX_WIDE_ONLY: the wide path wherever it fits)")
    args = p.parse_args(argv)
    if (args.lab or args.max or args.edge or args.general) and args.probes:
        p.error("--probes is for the ELL kernels, not --lab, --max, --edge "
                "or --general")
    if not args.edge and args.de != EDGE_DE:
        p.error("--de is for --edge")
    if not (args.edge or args.max or args.general) and args.hidden != H:
        p.error("--hidden is for --edge, --max and --general")
    if args.hidden < 1:
        p.error("--hidden must be positive")
    if args.define and not args.max:
        p.error("--define is for --max")
    device = resolve_device(False)
    name = ("lab_kernels" if args.lab else
            "ell_max_kernels" if args.max else
            "ell_edge_kernels" if args.edge else
            "ell_general_kernels" if args.general else "ell_kernels")
    print(card_line(), flush=True)
    print(f"other: {args.other}"
          + "".join(f" -D{d}" for d in args.define)
          + f"; this: {build.SOURCES[name]}", flush=True)
    if args.lab:
        return run_lab(device, args.other)
    if args.max:
        return run_max(device, args.other, args.hidden, args.define)
    if args.edge:
        return run_edge(device, args.other, args.hidden, args.de)
    if args.general:
        return run_general(device, args.other, args.hidden)
    return run(device, args.other, args.probes)


if __name__ == "__main__":
    main()
