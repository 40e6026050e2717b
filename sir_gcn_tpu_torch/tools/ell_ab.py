"""Same-card A/B of two builds of the ELL kernels of ``csrc/ell_kernels.cu``:
another source with the same C interface (an earlier revision of the file,
for example) against the package's own, at the ogbn-arxiv plan with bf16
edges.

    git show <rev>:sir_gcn_tpu_torch/csrc/ell_kernels.cu > other.cu
    python -m sir_gcn_tpu_torch.tools.ell_ab other.cu [--probes]

The other source is built with the package's nvcc flags into a library of
its own (``build/kernels/ab-<hash>/``), which the package never loads.
Each of #1, #2, #4 and their edge-term forms (leaky_relu(0.2); #2 and #4
also with tanh) runs from both libraries on the same inputs: ms per launch
by CUDA events over 50 warm launches in four turns (other, this, this,
other), and the largest difference of the two outputs. ``--probes`` adds
#2 and #4 with every gathered index folded into 1/2, 1/4 and 1/8 of the
node table and into 16,384 rows: the same gathers from a smaller table,
which the 50 MB L2 holds. The plan is the trainer's synthetic stand-in
for ogbn-arxiv (169,343 nodes, 1,166,243 edges, seed 0, bidirected with
self-loops), H = 96. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
from pathlib import Path

import torch

from ..data import synthetic_node_classification
from ..experiments.ogbn_arxiv.train import build_arxiv_graph, get_args
from ..ops.cuda import build
from ..ops.cuda.kernels import _ARGTYPES, _library
from ..ops.ell import leaky_relu, tanh
from . import card_line, cuda_ms, resolve_device

ARXIV = dict(nodes=169_343, edges=1_166_243, seed=0)
H = 96
ITERS = 50
FOLDS = (2, 4, 8)
FOLD_ROWS = 16_384


def build_other(source: Path) -> ctypes.CDLL:
    """``source`` built as the package builds ell_kernels.cu, with the
    package's argument types on its entries."""
    text = source.read_bytes()
    tag = hashlib.sha256(text + " ".join(build.NVCC_FLAGS).encode())
    lib = build.BUILD_DIR / f"ab-{tag.hexdigest()[:16]}" / "libab.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        out = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(source)],
            capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed for {source}:\n{out.stdout}"
                               f"{out.stderr}")
    other = ctypes.CDLL(str(lib))
    for entry, argtypes in _ARGTYPES["ell_kernels"].items():
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


def ab(label: str, entry: str, args, outs, libs: dict) -> dict:
    """Run ``entry`` from both libraries; print and return the ms of each
    turn and the largest difference of the outputs."""
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
    diff = max(float((a - b).abs().max())
               for a, b in zip(got["other"], got["this"]))
    ms = {"other": [], "this": []}
    for k in ("other", "this", "this", "other"):
        ms[k].append(cuda_ms(calls[k], ITERS))
    print(f"{label}: other {ms['other'][0]:.4f} / {ms['other'][1]:.4f} ms, "
          f"this {ms['this'][0]:.4f} / {ms['this'][1]:.4f} ms, "
          f"max |diff| {diff:.3e}", flush=True)
    return dict(ms=ms, diff=diff)


def run(device, other: Path, probes: bool = False) -> dict:
    """Every A/B line (and with ``probes`` the folded ones); returns
    label -> record."""
    libs = {"other": build_other(other), "this": _library("ell_kernels")}
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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        "same-card A/B of two builds of the ELL kernels")
    p.add_argument("other", type=Path,
                   help="a source with the C interface of ell_kernels.cu")
    p.add_argument("--probes", action="store_true",
                   help="also time #2 and #4 with their gathers folded "
                        "into a smaller table")
    args = p.parse_args(argv)
    device = resolve_device(False)
    print(card_line(), flush=True)
    print(f"other: {args.other}; this: {build.SOURCES['ell_kernels']}",
          flush=True)
    return run(device, args.other, args.probes)


if __name__ == "__main__":
    main()
