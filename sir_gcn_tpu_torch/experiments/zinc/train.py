"""ZINC graph-regression harness (port of ``experiments/zinc/train.py``;
reference ``benchmark-datasets/zinc/train.py``): L1 loss, MAE,
best-by-validation-MAE selection, a 10-epoch warmup. Reads the npz cache
if there is one, else ZINC-shaped synthetic molecules (flagged, not a
parity number). The flags are the reference's, so its README commands
run unchanged.

Runs on the CUDA card unless ``--cpu`` is given; with no card and no
``--cpu`` it raises.

    python -m sir_gcn_tpu_torch.experiments.zinc.train --norm gn \\
        --jumping-knowledge --residual --nruns 1
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from ...data import GraphCollection, has_cache, load_graph_cache
from ...data import synthetic_molecules
from ...ops.message_passing import set_edge_dtype
from ...parallel.multihost import needs_spawn, spawn_ranks, trainer_device
from ...train import aggregate_runs
from ...train.metrics import mae
from ..batched_harness import (
    apply_self_loops,
    run_batched_workload,
)
from .model import make_gin_model, make_sir_model


def load_zinc(args, seed):
    """(graphs, node feats, edge feats, labels, (train, val, test),
    synthetic)."""
    if has_cache("zinc"):
        z, graphs, nodes, edges = load_graph_cache("zinc")
        return (graphs, nodes("node_feat"), edges("edge_feat"),
                z["labels"].astype(np.float32),
                (z["train_idx"], z["val_idx"], z["test_idx"]), False)
    graphs, nfeats, efeats, labels = synthetic_molecules(
        num_graphs=args.synthetic_samples, seed=seed)
    n = len(graphs)
    tr, va = int(0.8 * n), int(0.9 * n)
    idx = np.arange(n)
    return (graphs, nfeats, efeats, labels,
            (idx[:tr], idx[tr:va], idx[va:]), True)


def l1_loss(preds, labels, weights):
    err = (preds[:, 0] - labels).abs()
    return (err * weights).sum() / weights.sum().clamp_min(1.0)


def build_model(args, input_dim: int, edge_dim: int,
                generator: Optional[torch.Generator] = None):
    """The ``--model`` of ``args`` for these feature vocabularies."""
    kwargs = dict(
        num_layers=args.nlayers, input_dropout=args.input_dropout,
        edge_dropout=args.edge_dropout, dropout=args.dropout,
        norm=args.norm, readout_layers=args.readout_layers,
        readout_dropout=args.readout_dropout,
        readout_pooling=args.readout_pooling,
        jumping_knowledge=args.jumping_knowledge,
        residual=args.residual, resid_layers=args.resid_layers,
        resid_dropout=args.resid_dropout, agg_type=args.agg_type,
        generator=generator,
    )
    if args.model == "SIR":
        return make_sir_model(input_dim, edge_dim, args.nhidden, 1,
                              feat_dropout=args.feat_dropout,
                              use_edge_feats=args.use_edge_feats, **kwargs)
    return make_gin_model(input_dim, edge_dim, args.nhidden, 1,
                          mlp_layers=args.nlayers_mlp, **kwargs)


def run_single(args, seed: int, device: torch.device,
               stats: Optional[dict] = None, time_steps: bool = False):
    graphs, nfeats, efeats, labels, (tr, va, te), synthetic = \
        load_zinc(args, seed)
    if synthetic:
        print("[warn] no zinc cache; synthetic stand-in (not parity)")
    if args.add_self_loop:
        # dgl.transforms.AddSelfLoop (zinc/train.py:40); the loop edges get
        # zero edge features, DGL's frame padding
        graphs, efeats = apply_self_loops(graphs, efeats)
    coll = GraphCollection(graphs, node_feats=nfeats, edge_feats=efeats,
                           labels=labels)
    input_dim = int(max(f.max() for f in nfeats)) + 1
    edge_dim = int(max(f.max() for f in efeats)) + 1
    model = build_model(args, input_dim, edge_dim,
                        torch.Generator().manual_seed(seed))
    return run_batched_workload(
        model=model, coll=coll, train_idx=tr, val_idx=va, test_idx=te,
        args=args, seed=seed, loss_fn=l1_loss,
        metric_fn=lambda p, l: mae(p[:, 0], l),
        minimize_metric=True, device=device, warmup_size=10,
        has_edge_feats=args.use_edge_feats, stats=stats,
        time_steps=time_steps,
    )


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "SIR-GCN/GIN on ZINC (PyTorch + CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--edge-bf16", action="store_true",
                   help="the edge dtype of the ELL routes; the CSR "
                        "aggregate these batches take ignores it")
    p.add_argument("--gpu", type=int, default=0,
                   help="ignored (the card is CUDA device 0); accepted so "
                        "reference commands run unchanged")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model", type=str, default="SIR",
                   choices=["SIR", "GIN"])
    p.add_argument("--nhidden", type=int, default=64)
    p.add_argument("--nlayers", type=int, default=4)
    p.add_argument("--input-dropout", type=float, default=0)
    p.add_argument("--edge-dropout", type=float, default=0)
    p.add_argument("--dropout", type=float, default=0)
    p.add_argument("--norm", type=str, default="none",
                   choices=["gn", "cn", "bn", "ln", "none"])
    p.add_argument("--readout-layers", type=int, default=1)
    p.add_argument("--readout-dropout", type=float, default=0)
    p.add_argument("--readout-pooling", type=str, default="sum",
                   choices=["sum", "mean"])
    p.add_argument("--jumping-knowledge", action="store_true")
    p.add_argument("--residual", action="store_true")
    p.add_argument("--resid-layers", type=int, default=0)
    p.add_argument("--resid-dropout", type=float, default=0)
    p.add_argument("--feat-dropout", type=float, default=0)
    p.add_argument("--agg-type", type=str, default="sum",
                   choices=["sum", "max", "mean", "sym"])
    p.add_argument("--nlayers-mlp", type=int, default=2)
    p.add_argument("--use-edge-feats", action="store_true",
                   help="SIREConv2 path (bond-type embedding)")
    p.add_argument("--add-self-loop", action="store_true")
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--dp-devices", type=int, default=0,
                   help="data-parallel ranks, one card each (gloo CPU "
                        "processes with --cpu); 0/1 = one device")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--wd", type=float, default=0)
    p.add_argument("--l1", type=float, default=0)
    p.add_argument("--l2", type=float, default=0)
    p.add_argument("--factor", type=float, default=0.5)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--nruns", type=int, default=10)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--synthetic-samples", type=int, default=1000)
    return p


def _rank_main(argv: list, time_steps: bool):
    """``main`` on one rank of a ``--dp-devices`` run; its stats come back
    to the spawning process with the metrics."""
    stats = []
    vals, tests = main(argv, stats, time_steps)
    return vals, tests, stats


def main(argv=None, stats: Optional[list] = None, time_steps: bool = False):
    """Train ``--nruns`` runs; returns (val MAEs, test MAEs). With
    ``stats`` (a list) each run appends its harness stats."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if needs_spawn(args.dp_devices, args.cpu):
        vals, tests, run_stats = spawn_ranks(
            args.dp_devices, _rank_main, argv, time_steps, cpu=args.cpu)
        if stats is not None:
            stats.extend(run_stats)
        return vals, tests
    device = trainer_device(args.cpu, args.dp_devices)
    set_edge_dtype(torch.bfloat16 if args.edge_bf16 else None)

    val_maes, test_maes = [], []
    for i in range(args.nruns):
        run_stats = {}
        r = run_single(args, args.seed + i, device, run_stats, time_steps)
        if stats is not None:
            stats.append(run_stats)
        val_maes.append(r["val_metric"])
        test_maes.append(r["test_metric"])

    print(f"Runned {args.nruns} times")
    aggregate_runs("val MAE", val_maes)
    aggregate_runs("test MAE", test_maes)
    return val_maes, test_maes


if __name__ == "__main__":
    main()
