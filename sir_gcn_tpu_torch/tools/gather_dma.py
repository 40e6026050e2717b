"""Per-row gather on the card: can a kernel that gathers each indexed
node row itself beat a take (``index_select``) that writes the gathered
rows out? Port of ``tools/gather_dma.py``, its two Pallas kernels
hand-written CUDA kernels (``ops/cuda/lab.py``).

    python -m sir_gcn_tpu_torch.tools.gather_dma [--cpu]

The TPU kernel could only copy the 8-row tile holding each row (Mosaic
cannot DMA one row); the kernel here reads each 256-byte row alone. Sizes
are the JAX tool's: a table of N = 169,984 rows of H = 128 bf16, S =
2,752,512 indices from ``np.random.default_rng(0)``, tiles of T = 4096
indices, and a consumer summing tiles of TSUM = 8192 rows. Lines:
  * the gather kernel (#23), per tile the f32 sum of its rows, by 16-byte
    loads, 8 rows in flight a warp;
  * take + sum: ``index_select``, then a sum in f32;
  * take -> materialised f32 -> sum: the taken rows widened to f32 first;
  * take -> #24 consumer: the taken rows summed per tile by the kernel
    that replaces the JAX tool's ``copy_kernel``.
Each prints ms per pass (CUDA events over 10 warm passes), the row
traffic S*H*2 over the time (the JAX tool's GB/s) and the share of the
gather's bound: table, indices and output at the data sheet's 3.35 TB/s.
The table (43.5 MB) fits in the card's 50 MB L2, so the gather's rate is
L2-assisted. Progress goes to stderr. With ``--cpu`` each line runs the
plain versions once and prints the host time, which is no device time.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..ops.cuda import lab_gather, lab_tile_sum
from ..ops.cuda.lab import TILE_ROWS_OUT
from . import card_line, measure, resolve_device

SIZES = dict(N=169_984, S=2_752_512, H=128, T=4096, TSUM=8192)
# a table of 174 MB at H = 128, beyond the card's 50 MB L2 (the lab's 43.5
# MB one fits in it)
BIG_N = 679_936
STEPS = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_inputs(device, N=SIZES["N"], S=SIZES["S"], H=SIZES["H"]) -> dict:
    """The JAX tool's inputs, drawn in its order: tbl [N, H] bf16 (N must
    be a multiple of 8 there: the TPU kernel copies each row's 8-row tile)
    and idx [S] int32 in [0, N)."""
    rng = np.random.default_rng(0)
    tbl = torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, N, S).astype(np.int32))
    return dict(tbl=tbl.to(torch.bfloat16).to(device), idx=idx.to(device))


def run(device, inputs=None, N=SIZES["N"], S=SIZES["S"], H=SIZES["H"],
        T=SIZES["T"], TSUM=SIZES["TSUM"]) -> list:
    """Time each line on ``device`` and print it; returns the lines'
    records (see ``tools.measure``). ``inputs`` from ``make_inputs``,
    else made at N, S, H."""
    if inputs is None:
        inputs = make_inputs(device, N, S, H)
    tbl, idx = inputs["tbl"], inputs["idx"]
    (N, H), S = tbl.shape, idx.shape[0]
    t0 = time.time()
    v = float(tbl[:8].float().sum())
    log(f"probe sum={v:.2f} in {time.time() - t0:.1f}s")
    G = S // T
    # the gather's own bytes: the table, the indices and its [G, 8, H] f32
    nbytes = N * H * 2 + S * 4 + G * TILE_ROWS_OUT * H * 4
    lines = [
        ("#23 gather kernel, 8 rows in flight a warp", "lab_gather",
         lambda: lab_gather(tbl, idx, T)),
        ("take + sum (index_select, f32 sum)", None,
         lambda: torch.sum(tbl.index_select(0, idx), dtype=torch.float32)),
        ("take -> materialised f32 -> sum", None,
         lambda: tbl.index_select(0, idx).float().sum()),
        ("take -> #24 consumer", "lab_tile_sum",
         lambda: lab_tile_sum(tbl.index_select(0, idx), TSUM)),
    ]
    recs = []
    for label, kernel, fn in lines:
        log(f"[start] {label}")
        recs.append(measure(device, label, kernel, fn, nbytes, S * H,
                            S * H * 2, STEPS))
    return recs


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        "per-row gather probe (PyTorch + CUDA port)")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain versions on the CPU")
    args = p.parse_args(argv)
    device = resolve_device(args.cpu)
    log(f"device: {device}")
    if device.type == "cuda":
        print(card_line(), flush=True)
    print(f"N {SIZES['N']}, S {SIZES['S']}, H {SIZES['H']}, T {SIZES['T']}, "
          f"TSUM {SIZES['TSUM']}, device {device}", flush=True)
    return run(device)


if __name__ == "__main__":
    main()
