"""Kernel-variant lab on the card: time alternatives of the bucket
broadcast + act + reduce kernel (#1) at the dominant arxiv bucket (B = 16)
and the stream probes beside it. Port of ``tools/kernel_lab.py``, each of
its Pallas kernels a hand-written CUDA kernel (``ops/cuda/lab.py``).

    python -m sir_gcn_tpu_torch.tools.kernel_lab [--cpu] [tag ...]

Tags (default: all): v0 the production #1 (``ell_act_reduce``) on a
one-bucket plan reading the same bytes; v1 .. v6 the variants of
``make_v1`` .. ``make_v6``; xla the plain PyTorch composition; bound and
bound32 the sum-only streams from bf16 and f32; copy and copy2 the bf16
passthrough, one block a tile and with a persistent grid. Sizes are the
JAX tool's: R = 111,104 rows of B = 16 slots, H = 128, inputs from
``np.random.default_rng(0)``, leaky_relu(0.2).

Each line prints ms per call (CUDA events over 30 warm calls), the rate
by the JAX tool's formula (S*H*2 + R*H*4 bytes over the time) so the two
tools read side by side, and the share of the line's bound (its own bytes
at the data sheet's 3.35 TB/s). With ``--cpu`` each line runs the plain
versions once and prints the host time, which is no device time.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.cuda import (
    ell_act_reduce,
    lab_copy,
    lab_copy32,
    lab_pass,
    lab_pass2,
    lab_v1,
    lab_v2,
    lab_v3,
    lab_v4,
    lab_v5,
    lab_v6,
)
from ..ops.cuda.lab import INFLIGHT, PLANE_BLOCK_ROWS, SLOPE, V1_TILE_ROWS
from ..ops.ell import leaky_relu
from . import card_line, measure, resolve_device

SIZES = dict(R=111_104, B=16, H=128)  # dominant arxiv bucket, rounded to 8
TAGS = ("v0", "v1", "v2", "v3", "v4", "v5", "v6", "xla", "bound", "bound32",
        "copy", "copy2")
ITERS = 30
ACT_FLOPS = 5  # per slot and feature: add, compare, mul, scale, add


def make_inputs(device, R=SIZES["R"], B=SIZES["B"], H=SIZES["H"]) -> dict:
    """The JAX tool's inputs, drawn in its order: ekg [S, H] bf16, eq
    [R, H] f32, sc [R, B] f32 (flat [S]), the plane-major ekg3 [B, R, H]
    bf16 and sc3 [B, R] f32; and ekg32, ekg in f32."""
    rng = np.random.default_rng(0)
    S = R * B

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).to(device)

    def f32(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    ekg = bf16(rng.normal(size=(S, H)))
    eq = f32(rng.normal(size=(R, H)))
    sc = f32(rng.random((R, B))).reshape(S)
    ekg3 = bf16(rng.normal(size=(B, R, H)))
    sc3 = f32(rng.random((B, R, 1))).reshape(B, R)
    return dict(ekg=ekg, eq=eq, sc=sc, ekg3=ekg3, sc3=sc3,
                ekg32=ekg.float())


def xla_ref(ekg, eq, sc):
    """The JAX tool's pure-XLA reference (``xla_ref``), in PyTorch."""
    r, h = eq.shape
    z = ekg.float().view(r, -1, h) + eq[:, None, :]
    return (torch.where(z >= 0, z, SLOPE * z) * sc.view(r, -1, 1)).sum(1)


def identity_plan(R: int, B: int, device):
    """(slot_src, row_key, row_ptr) of one bucket whose slot s reads row s
    of the node table and whose row r is node r: #1 on it reads ekg and eq
    as the variants do."""
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.arange(R * B, **i32), torch.arange(R, **i32),
            torch.arange(0, R * B + 1, B, **i32))


def variants(inputs: dict, tags) -> list:
    """(tag, label, kernel or None, fn, bytes, flops) of each line, in the
    JAX tool's order."""
    ekg, eq, sc = inputs["ekg"], inputs["eq"], inputs["sc"]
    ekg3, sc3, ekg32 = inputs["ekg3"], inputs["sc3"], inputs["ekg32"]
    R, H = eq.shape
    S = ekg.shape[0]
    B = S // R
    act_bytes = S * H * 2 + R * H * 4 + S * 4 + R * H * 4
    act_flops = ACT_FLOPS * S * H
    out = []
    if "v0" in tags:
        slot_src, row_key, row_ptr = identity_plan(R, B, ekg.device)
        act = leaky_relu(SLOPE)
        out.append(("v0", "v0 production #1 (ell_act_reduce), one bucket",
                    "ell_act_reduce",
                    lambda: ell_act_reduce(eq, ekg, slot_src, sc, row_key,
                                           row_ptr, act),
                    act_bytes + (S + 2 * R + 1) * 4, act_flops))
    for tr in V1_TILE_ROWS if "v1" in tags else ():
        out.append(("v1", f"v1 tile staged in smem, {tr} rows ({tr * B} "
                    f"slots)", "lab_v1", lambda tr=tr: lab_v1(ekg, eq, sc, tr),
                    act_bytes, act_flops))
    for u in INFLIGHT if "v2" in tags else ():
        out.append(("v2", f"v2 warp a row, {u} loads in flight a lane",
                    "lab_v2", lambda u=u: lab_v2(ekg, eq, sc, u), act_bytes,
                    act_flops))
    if "v3" in tags:
        out.append(("v3", "v3 thread a feature pair, slot adds in order",
                    "lab_v3", lambda: lab_v3(ekg, eq, sc), act_bytes,
                    act_flops))
    for u in (4, 8) if "v4" in tags else ():
        out.append(("v4", f"v4 bf16 compute, {u} loads in flight a lane",
                    "lab_v4", lambda u=u: lab_v4(ekg, eq, sc, u), act_bytes,
                    act_flops))
    for br in PLANE_BLOCK_ROWS if "v5" in tags else ():
        out.append(("v5", f"v5 plane-major [B,R,H], {br} rows a block",
                    "lab_v5", lambda br=br: lab_v5(ekg3, eq, sc3, br),
                    act_bytes, act_flops))
    for br in (16, 32) if "v6" in tags else ():
        out.append(("v6", f"v6 plane-major, scale by shuffle, {br} rows a "
                    f"block", "lab_v6", lambda br=br: lab_v6(ekg3, eq, sc3, br),
                    act_bytes, act_flops))
    if "xla" in tags:
        out.append(("xla", "xla reference (plain PyTorch composition)", None,
                    lambda: xla_ref(ekg, eq, sc), act_bytes, act_flops))
    for u in (4, 8) if "bound" in tags else ():
        out.append(("bound", f"sum-only stream bf16, {u} loads in flight",
                    "lab_copy", lambda u=u: lab_copy(ekg, R, u),
                    S * H * 2 + R * H * 4, S * H))
    for u in (4, 8) if "bound32" in tags else ():
        out.append(("bound32",
                    f"sum-only stream f32, {u} slabs in flight a block",
                    "lab_copy32", lambda u=u: lab_copy32(ekg32, R, u),
                    S * H * 4 + R * H * 4, S * H))
    if "copy" in tags:
        out.append(("copy", "passthrough bf16 r+w, a 16-byte chunk a thread",
                    "lab_pass", lambda: lab_pass(ekg), 2 * S * H * 2, S * H))
    for sem, persistent in (("parallel", False), ("arbitrary", True)) \
            if "copy2" in tags else ():
        out.append(("copy2", f"passthrough tiles of 256 rows sem={sem}",
                    "lab_pass2", lambda p=persistent: lab_pass2(ekg, p),
                    2 * S * H * 2, S * H))
    return out


def run(device, tags=TAGS, inputs=None, R=SIZES["R"], B=SIZES["B"],
        H=SIZES["H"]) -> list:
    """Time each line of ``tags`` on ``device`` and print it; returns the
    lines' records (see ``tools.measure``). ``inputs`` from
    ``make_inputs``, else made at R, B, H."""
    if inputs is None:
        inputs = make_inputs(device, R, B, H)
    S, H = inputs["ekg"].shape
    R = inputs["eq"].shape[0]
    rate_bytes = S * H * 2 + R * H * 4  # tools/kernel_lab.py:56
    recs = []
    for tag, label, kernel, fn, nbytes, flops in variants(inputs, tags):
        recs.append(dict(tag=tag, **measure(device, label, kernel, fn,
                                            nbytes, flops, rate_bytes,
                                            ITERS)))
    return recs


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        "timing lab of the bucket act-reduce kernel (PyTorch + CUDA port)")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain versions on the CPU")
    p.add_argument("tags", nargs="*", metavar="tag",
                   help=f"lines to run, of {' '.join(TAGS)} (default all)")
    args = p.parse_args(argv)
    unknown = sorted(set(args.tags) - set(TAGS))
    if unknown:
        p.error(f"unknown tags {unknown}; the tags are {' '.join(TAGS)}")
    device = resolve_device(args.cpu)
    if device.type == "cuda":
        print(card_line(), flush=True)
    print(f"R {SIZES['R']}, B {SIZES['B']}, H {SIZES['H']}, device "
          f"{device}", flush=True)
    return run(device, args.tags or TAGS)


if __name__ == "__main__":
    main()
