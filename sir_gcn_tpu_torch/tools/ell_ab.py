"""Same-card A/B of two builds of one of the port's CUDA sources: another
source with the same C interface (an earlier revision of the file, for
example) against the package's own.

    git show <rev>:sir_gcn_tpu_torch/csrc/ell_kernels.cu > other.cu
    python -m sir_gcn_tpu_torch.tools.ell_ab other.cu [--probes]
    git show <rev>:sir_gcn_tpu_torch/csrc/lab_kernels.cu > other.cu
    python -m sir_gcn_tpu_torch.tools.ell_ab --lab other.cu

The other source is built with the package's nvcc flags for its source
into a library of its own (``build/kernels/ab-<hash>/``), which the
package never loads.

The ELL mode (``csrc/ell_kernels.cu``) runs each of #1, #2, #4 and their
edge-term forms (leaky_relu(0.2); #2 and #4 also with tanh) from both
libraries on the same inputs at the ogbn-arxiv plan with bf16 edges: ms
per launch by CUDA events over 50 warm launches in four turns (other,
this, this, other), and the largest difference of the two outputs.
``--probes`` adds #2 and #4 with every gathered index folded into 1/2,
1/4 and 1/8 of the node table and into 16,384 rows: the same gathers from
a smaller table, which the 50 MB L2 holds. The plan is the trainer's
synthetic stand-in for ogbn-arxiv (169,343 nodes, 1,166,243 edges, seed
0, bidirected with self-loops), H = 96.

The lab mode (``--lab``, ``csrc/lab_kernels.cu``) runs the streams #19
``lab_copy``, #20 ``lab_copy32`` (at each ``inflight``), #21 ``lab_pass``,
#22 ``lab_pass2`` (both modes) and #24 ``lab_tile_sum`` from both
libraries and the PyTorch call that computes the same function, at the
lab tools' sizes (``kernel_lab.SIZES``, ``gather_dma.SIZES``), on random
inputs from seed 0 made on the card: ms per launch over 20 warm launches
in eight turns (other, this, library, library, this, other, ...), the
median and the spread of each, the kernel's verdict against the library
call (win: its slowest turn beats the call's fastest; loss: the other
way round; else tie), and the largest difference of the two kernels'
outputs, which must be 0 for the passthroughs. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
from pathlib import Path

import torch

from ..data import synthetic_node_classification
from ..experiments.ogbn_arxiv.train import build_arxiv_graph, get_args
from ..ops.cuda import build
from ..ops.cuda.kernels import _ARGTYPES, _library
from ..ops.cuda.lab import INFLIGHT, PASS2_TILE_ROWS
from ..ops.ell import leaky_relu, tanh
from . import (
    alternating_ms,
    card_line,
    gather_dma,
    kernel_lab,
    resolve_device,
    verdict,
)

ARXIV = dict(nodes=169_343, edges=1_166_243, seed=0)
H = 96
ITERS = 50
FOLDS = (2, 4, 8)
FOLD_ROWS = 16_384
LAB_ITERS = 20
LAB_ROUNDS = 8  # turns of (other, this, library), alternating in order


def build_other(source: Path, name: str = "ell_kernels") -> ctypes.CDLL:
    """``source`` built as the package builds its source ``name`` (a key of
    ``build.SOURCES``), with the package's argument types of ``name`` on
    its entries."""
    if name not in build.SOURCES:
        raise ValueError(f"no source {name!r}; the sources are "
                         f"{sorted(build.SOURCES)}")
    flags = build._flags(name)
    text = source.read_bytes()
    tag = hashlib.sha256(text + " ".join(flags).encode())
    lib = build.BUILD_DIR / f"ab-{tag.hexdigest()[:16]}" / "libab.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        out = subprocess.run(
            [build._nvcc(), *flags, "-o", str(lib), str(source)],
            capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed for {source}:\n{out.stdout}"
                               f"{out.stderr}")
    other = ctypes.CDLL(str(lib))
    for entry, argtypes in _ARGTYPES[name].items():
        fn = getattr(other, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return other


def arxiv_inputs(device) -> dict:
    """The plan and random node and edge tables, from seed 0."""
    data = synthetic_node_classification(
        ARXIV["nodes"], ARXIV["edges"], feat_dim=128, num_classes=40,
        seed=ARXIV["seed"])
    fg = build_arxiv_graph(
        data, get_args(["--add-reverse-edge", "--add-self-loop"]), device)
    gen = torch.Generator(device=device).manual_seed(0)
    eq, ek, g = (torch.randn((fg.n_pad, H), generator=gen, device=device)
                 for _ in range(3))
    e = torch.randn((fg.e_pad, H), generator=gen, device=device)
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
    if fold is None and act.name == "leaky_relu":
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
    call) of #19-#22 and #24 at the lab tools' sizes, on random inputs
    from seed 0 made on the card; and the inputs, to keep alive."""
    R, B, H = (kernel_lab.SIZES[k] for k in "RBH")
    S, TSUM = gather_dma.SIZES["S"], gather_dma.SIZES["TSUM"]
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
    return runs, (ekg32, ekg, v)


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
    for act in (leaky_relu(0.2), tanh):
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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        "same-card A/B of two builds of the port's ELL or lab kernels")
    p.add_argument("other", type=Path,
                   help="a source with the C interface of ell_kernels.cu "
                        "(with --lab, of lab_kernels.cu)")
    p.add_argument("--lab", action="store_true",
                   help="time the lab's streams (#19-#22, #24) with their "
                        "library calls")
    p.add_argument("--probes", action="store_true",
                   help="also time #2 and #4 with their gathers folded "
                        "into a smaller table")
    args = p.parse_args(argv)
    if args.lab and args.probes:
        p.error("--probes is for the ELL kernels, not --lab")
    device = resolve_device(False)
    name = "lab_kernels" if args.lab else "ell_kernels"
    print(card_line(), flush=True)
    print(f"other: {args.other}; this: {build.SOURCES[name]}", flush=True)
    if args.lab:
        return run_lab(device, args.other)
    return run(device, args.other, args.probes)


if __name__ == "__main__":
    main()
