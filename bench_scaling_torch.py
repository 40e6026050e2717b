#!/usr/bin/env python3
"""Multi-device scaling benchmark of the PyTorch + CUDA port: the
full-graph SIR training step with the graph partitioned by node ranges
over N ranks (``bench_scaling.py``'s recipe on ``sir_gcn_tpu_torch``).

The step is ``bench_scaling.py``'s: the arxiv ``SIRModel`` (128 features,
``--hidden`` wide, ``--layers`` layers, sym aggregation, residual,
LayerNorm, 40 classes) on a random graph of ``--nodes`` nodes and
``--edges`` edges from ``np.random.default_rng(0)``, padded to a multiple
of 128 N nodes; forward, the mean cross-entropy over every padded row,
backward, the parameter gradients summed over the ranks, AdamW(1e-2).
``--path halo`` partitions the graph for the boundary-only halo aggregate
(the port's kernels on the card), ``--path gspmd`` row-shards it for the
CSR aggregate (no kernel).

One rank a card (NCCL), or with ``--cpu`` one gloo process a rank; a count
of 1 runs in this process with no process group. A count above the
visible cards raises, before anything runs: nothing falls back to fewer
cards or to the CPU.

Timing: ``--steps`` untimed steps (the kernels' build and first launches),
then ``--steps`` steps clocked on the host from before the first to a
``torch.cuda.synchronize()`` after the last; rank 0's clock is reported.

    python3 bench_scaling_torch.py --devices 1 2 4 8
    python3 bench_scaling_torch.py --cpu --devices 1 2 --nodes 2048 \\
        --edges 16384

Prints one JSON line per device count on stdout, progress on stderr:
``{"metric", "devices", "value", "unit", "efficiency_vs_1dev"}``, the value
in edge-layers/s (``--edges`` x ``--layers`` / step seconds) and the
efficiency against the first count's value times N.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "bench_scaling_torch.py", description="scaling of the row- or "
        "halo-partitioned full-graph step over N ranks")
    p.add_argument("--devices", type=int, nargs="+", default=None,
                   help="device counts (default: 1 and every visible card; "
                        "1 and 2 with --cpu)")
    p.add_argument("--nodes", type=int, default=16384)
    p.add_argument("--edges", type=int, default=131072)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--path", type=str, default="halo",
                   choices=["halo", "gspmd"],
                   help="boundary-only halo aggregate (the port's kernels "
                        "on the card) or the row-sharded CSR aggregate")
    p.add_argument("--cpu", action="store_true",
                   help="gloo processes on the CPU with the kernels' plain "
                        "versions")
    return p


def rank_steps(args) -> dict:
    """This rank's part of one device count's run (rank 0 of a group, or
    the only process): the graph, its partition, the model, the untimed
    and the timed steps. Returns the seconds a step and the last loss."""
    import torch.distributed as dist

    from sir_gcn_tpu_torch import build_graph
    from sir_gcn_tpu_torch.experiments.fullgraph_harness import rank_rows
    from sir_gcn_tpu_torch.experiments.ogbn_arxiv.model import SIRModel
    from sir_gcn_tpu_torch.parallel.collectives import (
        all_reduce_sum,
        sum_gradients,
    )
    from sir_gcn_tpu_torch.parallel.full_graph import shard_full_graph
    from sir_gcn_tpu_torch.parallel.halo import build_halo_graph
    from sir_gcn_tpu_torch.parallel.multihost import local_device
    from sir_gcn_tpu_torch.train import make_adamw, resolve_device, synchronize

    grouped = dist.is_initialized()
    nd = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    device = local_device(args.cpu) if grouped else resolve_device(args.cpu)

    rng = np.random.default_rng(0)
    n, e = args.nodes, args.edges
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    feats_np = rng.normal(size=(n, 128)).astype(np.float32)
    labels_np = rng.integers(0, 40, n)
    graph = build_graph(src, dst, n, pad_multiple=128 * nd, device=device)
    if args.path == "halo":
        graph = build_halo_graph(graph, nd, None, agg_type="sym")
    else:
        graph = shard_full_graph(graph, nd, rank)
    rows = graph.rows
    feats = np.zeros((graph.n_global, 128), np.float32)
    feats[:n] = feats_np
    labels = np.zeros(graph.n_global, np.int64)
    labels[:n] = labels_np
    feats_t = torch.from_numpy(feats[rows]).to(device)
    labels_t = torch.from_numpy(labels[rows]).to(device)

    model = SIRModel(128, args.hidden, 40, num_layers=args.layers,
                     agg_type="sym", residual=True, norm="ln",
                     generator=torch.Generator().manual_seed(0)).to(device)
    opt = make_adamw(model.parameters(), 1e-2)

    def step() -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        with rank_rows(graph):
            logp = torch.log_softmax(model(graph, feats_t), -1)
        loss = -logp.gather(1, labels_t[:, None]).sum() / graph.n_global
        loss.backward()
        sum_gradients(model, graph.group)
        opt.step()
        return loss.detach()

    model.train()
    for _ in range(args.steps):
        loss = step()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = step()
    synchronize(device)
    dt = (time.perf_counter() - t0) / args.steps
    loss = float(all_reduce_sum(loss, graph.group))
    if not np.isfinite(loss):
        raise FloatingPointError(f"the loss is {loss} on {nd} devices")
    return {"seconds": dt, "loss": loss, "device": str(device)}


def main(argv=None) -> list:
    """Run each device count and print its JSON line; returns the
    records."""
    from sir_gcn_tpu_torch.parallel.multihost import (
        check_devices,
        spawn_ranks,
    )

    args = _parser().parse_args(argv)
    if args.devices:
        counts = args.devices
    elif args.cpu:
        counts = [1, 2]
    else:
        counts = [1, torch.cuda.device_count()]
    for nd in counts:  # every count's devices, before anything runs
        if nd < 1:
            raise ValueError(f"--devices {nd}")
        check_devices(nd, args.cpu)

    base, records = None, []
    for nd in counts:
        got = (rank_steps(args) if nd == 1
               else spawn_ranks(nd, rank_steps, args, cpu=args.cpu))
        eps = args.edges * args.layers / got["seconds"]
        if base is None:
            base = eps
        log(f"{nd} device(s), {args.path}, {got['device']}: step "
            f"{got['seconds'] * 1e3:.3f} ms, loss {got['loss']:.6f}")
        record = {
            "metric": "scaling_edge_layers_per_s",
            "devices": nd,
            "value": round(eps, 1),
            "unit": "edge-layers/s",
            "efficiency_vs_1dev": round(eps / (base * nd), 4),
        }
        print(json.dumps(record), flush=True)
        records.append(record)
    return records


if __name__ == "__main__":
    main()
