#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port: edge-layers/s of the flagship
training step on an ogbn-arxiv-sized graph (``bench.py``'s recipe on
``sir_gcn_tpu_torch``).

The step is the reference's winning ogbn-arxiv SIR-GCN configuration
(hidden 96, 3 layers, sym aggregation, BatchNorm, residual, dropout and
feature dropout 0.2, bf16 edge pipeline with f32 sums): forward, plain
cross-entropy over all padded rows, backward, AdamW(1e-2, 1e-3). The graph
has 169,343 nodes and 1,166,243 raw edges from ``np.random.default_rng(0)``
(``--graph random|community|powerlaw``), bidirected with self-loops,
optionally RCM-reordered (``--reorder``), padded to a multiple of 1024.
``--edge-features`` runs the SIREConv lane instead: the same three layers
with an edge basis of De = 16 and conv dropout 0, so the fused-edge
kernels form the edge projection.

Timing: one untimed block of 10 steps (the kernels' build is timed apart
before it; the block holds the first launches), then ``--windows`` blocks
of 10 steps, each clocked on the host from before its first step to a
``torch.cuda.synchronize()`` after its last. The fastest block's step time
is reported and the spread logged.

Prints ONE JSON line on stdout, progress on stderr:
``{"metric", "value", "unit", "step_ms", "plan_seconds", "device"}``, plus
``powerlaw_step_ms`` on the powerlaw graph. ``value`` is valid edges x 3
layers / step seconds; ``device`` is the card's name and power limit from
``nvidia-smi`` ("cpu" with ``--cpu``). ``bench.py``'s ``vs_baseline`` and
``floor_fraction`` are left out: both model a TPU v5e (819 GB/s of HBM,
3.9 ns a gathered row) and say nothing of this card.

Runs on the CUDA card; ``--cpu`` runs on the CPU with the kernels' plain
versions. Without a card and without ``--cpu`` it raises.

    python bench_torch.py [--graph powerlaw] [--reorder] [--edge-features]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sir_gcn_tpu_torch import (
    add_self_loops,
    bandwidth,
    build_fast_graph,
    build_graph,
    permute_nodes,
    rcm_order,
    to_bidirected,
)
from sir_gcn_tpu_torch.data import powerlaw_edges
from sir_gcn_tpu_torch.experiments.ogbn_arxiv.model import (
    SIRModel,
    leaky_relu02,
)
from sir_gcn_tpu_torch.experiments.ogbn_arxiv.train import resolve_device
from sir_gcn_tpu_torch.models import Linear, SIREConv, get_norm
from sir_gcn_tpu_torch.models.layers import dropout as apply_dropout
from sir_gcn_tpu_torch.ops.cuda import LAUNCHES
from sir_gcn_tpu_torch.ops.ell import last_build_memo_hit, plan_timings
from sir_gcn_tpu_torch.ops.message_passing import (
    get_edge_dtype,
    set_edge_dtype,
)
from sir_gcn_tpu_torch.train import make_adamw

N = 169_343
E_RAW = 1_166_243
HIDDEN, LAYERS = 96, 3
NUM_CLASSES = 40
FEAT_DIM = 128
DE = 16  # the SIREConv lane's edge basis width
DROPOUT = 0.2
STEPS = 10
PAD_MULTIPLE = 1024


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def community_graph(rng, n, e, comm=85, p_intra=0.8):
    """Citation-network-like topology: most edges inside ~comm-node
    communities (the random graph is the worst case for gather
    locality)."""
    dst = rng.integers(0, n, e)
    intra = rng.random(e) < p_intra
    base = (dst // comm) * comm
    src = np.where(intra,
                   np.minimum(base + rng.integers(0, comm, e), n - 1),
                   rng.integers(0, n, e))
    return src, dst


def bench_edges(graph_kind: str, reorder: bool, rng, n: int, e_raw: int):
    """The benchmark graph's edges (src, dst): ``e_raw`` draws of
    ``graph_kind`` from ``rng``, bidirected, with self-loops, and with
    ``reorder`` relabelled in RCM order."""
    if graph_kind == "community":
        src, dst = community_graph(rng, n, e_raw)
    elif graph_kind == "powerlaw":
        src, dst = powerlaw_edges(rng, n, e_raw)
    elif graph_kind == "random":
        src = rng.integers(0, n, e_raw)
        dst = rng.integers(0, n, e_raw)
    else:
        raise ValueError(f"unknown graph {graph_kind!r}")
    src, dst = to_bidirected(src, dst)
    src, dst = add_self_loops(src, dst, n)
    if reorder:
        t0 = time.perf_counter()
        perm = rcm_order(src, dst, n)
        b0 = bandwidth(src, dst)
        src, dst, _ = permute_nodes(src, dst, perm)
        log(f"RCM reorder: {time.perf_counter() - t0:.1f}s, mean |src-dst| "
            f"{b0:.0f} -> {bandwidth(src, dst):.0f}")
    return src, dst


def build_bench_graph(src, dst, n: int, device):
    """The padded graph on ``device`` and its ELL plans; returns the
    FastGraph and the seconds ``build_fast_graph`` took."""
    graph = build_graph(src, dst, n, pad_multiple=PAD_MULTIPLE,
                        device=device)
    e = graph.num_edges
    log(f"padded: n_pad={graph.n_pad} e_pad={graph.e_pad} edges={e}")
    t0 = time.perf_counter()
    fg = build_fast_graph(graph)
    plan_seconds = time.perf_counter() - t0
    deg = np.bincount(np.asarray(dst), minlength=n)
    dp, sp = fg.dst_plan, fg.src_plan
    log(f"plans: {plan_seconds:.1f}s; slot inflation "
        f"dst {dp.num_slots / max(e, 1):.3f}x "
        f"src {sp.num_slots / max(e, 1):.3f}x; "
        f"max in-degree {int(deg.max())}; dst buckets {dp.buckets1}; "
        f"stage 2: dst {dp.buckets2 is not None} "
        f"src {sp.buckets2 is not None}")
    log("plan stage timings: " + ", ".join(
        f"{k}={v:.2f}s" for k, v in sorted(plan_timings().items(),
                                           key=lambda kv: -kv[1]))
        + (" (memo hit)" if last_build_memo_hit() else ""))
    return fg, plan_seconds


class SIREBenchModel(nn.Module):
    """The SIREConv lane's model (``bench.py``'s ``SIREBenchModel``): a
    linear embedding, then per layer SIREConv (De = 16, conv dropout 0,
    sym) -> BatchNorm -> leaky_relu(0.2) -> dropout, plus the residual,
    then a linear readout. Its attributes carry ``SIRModel``'s names, so
    ``utils.convert.load_jax_variables`` fills it from the flax model."""

    def __init__(self, input_dim: int, dropout: float = DROPOUT,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.embedding = Linear(input_dim, HIDDEN, generator=generator)
        self.convs = nn.ModuleList(
            SIREConv(HIDDEN, DE, HIDDEN, HIDDEN, leaky_relu02, dropout=0.0,
                     agg_type="sym", generator=generator)
            for _ in range(LAYERS))
        self.norms = nn.ModuleList(get_norm("bn", True, HIDDEN)
                                   for _ in range(LAYERS))
        self.readout = Linear(HIDDEN, NUM_CLASSES, generator=generator)

    def forward(self, graph, feats, efeats, *,
                generator: Optional[torch.Generator] = None):
        x = self.embedding(feats)
        for conv, norm in zip(self.convs, self.norms):
            resid = x
            x = conv(graph, x, efeats, generator=generator)
            x = apply_dropout(leaky_relu02(norm(graph, x)), self.dropout,
                              self.training, generator) + resid
        return self.readout(x)


def make_model(edge_features: bool, dropout: float = DROPOUT,
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """The sym lane's arxiv ``SIRModel`` or the SIREConv lane's model,
    weights drawn from ``generator``."""
    if edge_features:
        return SIREBenchModel(FEAT_DIM, dropout, generator)
    return SIRModel(FEAT_DIM, HIDDEN, NUM_CLASSES, num_layers=LAYERS,
                    dropout=dropout, norm="bn", residual=True,
                    feat_dropout=dropout, agg_type="sym",
                    generator=generator)


def bench_inputs(rng, fg, edge_features: bool, device):
    """feats [N_pad, 128] N(0, 1), labels [N_pad] and, for the SIREConv
    lane, efeats [E_pad, De] N(0, 1) in original edge order, drawn from
    ``rng`` in ``bench.py``'s order (efeats first)."""
    efeats = (rng.normal(size=(fg.e_pad, DE)).astype(np.float32)
              if edge_features else None)
    feats = rng.normal(size=(fg.n_pad, FEAT_DIM)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, fg.n_pad)
    to = lambda a: None if a is None else torch.from_numpy(a).to(device)
    return to(feats), to(labels), to(efeats)


def train_step(model, optimizer, fg, feats, labels, efeats=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One step: forward in training mode, mean cross-entropy over all
    N_pad rows, backward, AdamW. Returns the loss (not synchronised)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    margs = (fg, feats) if efeats is None else (fg, feats, efeats)
    loss = F.cross_entropy(model(*margs, generator=generator), labels)
    loss.backward()
    optimizer.step()
    return loss.detach()


def _block(step, steps: int, device) -> tuple:
    """(seconds, losses) of ``steps`` calls of ``step``, clocked from
    before the first to a device synchronise after the last."""
    t0 = time.perf_counter()
    losses = [step() for _ in range(steps)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, [float(x) for x in losses]


def device_label(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def run(graph_kind: str = "random", reorder: bool = False,
        edge_features: bool = False, windows: int = 3, device="cuda",
        n: int = N, e_raw: int = E_RAW, steps: int = STEPS,
        details: Optional[dict] = None) -> dict:
    """Build the graph, then time the step; returns the JSON record.
    ``details``, when given, receives the FastGraph (``fg``), every step's
    loss (``losses``), the kernel launches per step, the build and first
    block's seconds, each window's step ms and the peak device memory."""
    if windows < 1 or steps < 1:
        raise ValueError(f"need at least one window of at least one step, "
                         f"got {windows} of {steps}")
    device = torch.device(device)
    rng = np.random.default_rng(0)
    log(f"building arxiv-sized graph: {n} nodes, {e_raw} raw edges "
        f"({graph_kind}{', RCM' if reorder else ''}) ...")
    src, dst = bench_edges(graph_kind, reorder, rng, n, e_raw)
    fg, plan_seconds = build_bench_graph(src, dst, n, device)
    edges = fg.graph.num_edges

    prev_dtype = get_edge_dtype()
    set_edge_dtype(torch.bfloat16)
    try:
        model = make_model(edge_features, generator=torch.Generator()
                           .manual_seed(0)).to(device)
        optimizer = make_adamw(model.parameters(), 1e-2, 1e-3)
        feats, labels, efeats = bench_inputs(rng, fg, edge_features, device)
        gen = torch.Generator(device=device).manual_seed(0)
        step = lambda: train_step(model, optimizer, fg, feats, labels,
                                  efeats, gen)

        build_seconds = 0.0
        if device.type == "cuda":
            from sir_gcn_tpu_torch.ops.cuda import build

            t0 = time.perf_counter()
            build.build_all()
            build_seconds = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats(device)
        before = dict(LAUNCHES)
        first_seconds, losses = _block(step, steps, device)
        log(f"kernel build {build_seconds:.1f}s; first {steps} steps "
            f"{first_seconds:.2f}s, loss {losses[-1]:.3f}")
        times = []
        for _ in range(windows):
            seconds, window_losses = _block(step, steps, device)
            times.append(seconds / steps)
            losses += window_losses
        per_step = {k: (v - before[k]) / (steps * (1 + windows))
                    for k, v in LAUNCHES.items() if v != before[k]}
    finally:
        set_edge_dtype(prev_dtype)
    dt = min(times)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    log(f"step time: min {dt * 1e3:.2f} ms over {len(times)} windows "
        f"[{', '.join(f'{t * 1e3:.2f}' for t in times)}] "
        f"spread {(max(times) / dt - 1) * 100:.1f}%; launches per step "
        f"{per_step}; loss {losses[-1]:.3f}"
        + ("" if peak is None else f"; peak memory {peak / 2**30:.3f} GiB"))

    record = {
        "metric": ("arxiv_sire_fused_edge_layers_per_s" if edge_features
                   else "arxiv_sir_fwd_bwd_edge_layers_per_s"),
        "value": edges * LAYERS / dt,
        "unit": "edge-layers/s/chip",
        "step_ms": dt * 1e3,
        "plan_seconds": plan_seconds,
        "device": device_label(device),
    }
    if graph_kind == "powerlaw":
        record["powerlaw_step_ms"] = record["step_ms"]
    if details is not None:
        details.update(fg=fg, losses=losses, launches_per_step=per_step,
                       build_seconds=build_seconds,
                       first_block_seconds=first_seconds,
                       window_ms=[t * 1e3 for t in times],
                       peak_memory_bytes=peak)
    return record


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        "bench_torch.py", description="edge-layers/s of the flagship "
        "training step on the PyTorch + CUDA port")
    p.add_argument("--graph", choices=["random", "community", "powerlaw"],
                   default="random")
    p.add_argument("--reorder", action="store_true",
                   help="relabel the nodes in reverse Cuthill-McKee order")
    p.add_argument("--remat", action="store_true",
                   help="not ported: raises")
    p.add_argument("--edge-features", action="store_true",
                   help="SIREConv lane: fused-edge kernels (basis De=16)")
    p.add_argument("--windows", type=int, default=3,
                   help="timed 10-step windows; min is reported")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU with the kernels' plain versions")
    args = p.parse_args(argv)
    if args.remat:
        raise NotImplementedError(
            "--remat has no counterpart in the port (the step saves only "
            "node-sized tensors per layer)")
    device = resolve_device(args.cpu)
    record = run(args.graph, args.reorder, args.edge_features, args.windows,
                 device)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
