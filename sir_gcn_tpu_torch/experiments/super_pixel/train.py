"""MNIST/CIFAR10 super-pixel harness (port of
``experiments/super_pixel/train.py``; reference
``benchmark-datasets/super-pixel/train.py``): batched graph
classification, CE and accuracy, the first 5000 training graphs held out
for validation (train.py:48-49), ``--use-feature`` for the raw pixel
features. Model: input dropout on the raw features, the SIRConv stack, JK
readouts and pooling (model.py:12-55), or the GIN baseline. The flags are
the reference's.

Runs on the CUDA card unless ``--cpu`` is given; with no card and no
``--cpu`` it raises.

    python -m sir_gcn_tpu_torch.experiments.super_pixel.train \\
        --dataset MNIST --use-feature --nruns 1
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...data import GraphCollection, has_cache, load_graph_cache
from ...ops.message_passing import set_edge_dtype
from ...parallel.multihost import needs_spawn, spawn_ranks, trainer_device
from ...train import aggregate_runs
from ...train.metrics import accuracy
from ..batched_harness import (
    apply_self_loops,
    run_batched_workload,
)
from ..common_models import GraphGINModel, GraphSIRModel

NUM_CLASSES = 10


def synthetic_superpixel(num_graphs, num_classes, use_feature, seed):
    """Super-pixel-shaped synthetic: 60-75-node 8-nearest-neighbour
    geometric graphs whose class sets a feature pattern."""
    rng = np.random.default_rng(seed)
    graphs, nfeats, labels = [], [], []
    for _ in range(num_graphs):
        n = int(rng.integers(60, 76))
        xy = rng.random((n, 2)).astype(np.float32)
        d2 = ((xy[:, None] - xy[None, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        k = 8
        nn_idx = np.argsort(d2, 1)[:, :k]
        src = np.repeat(np.arange(n), k).astype(np.int32)
        dst = nn_idx.reshape(-1).astype(np.int32)
        y = int(rng.integers(0, num_classes))
        base = np.sin(xy @ np.asarray([[1.0], [2.0]]) * (y + 1)).astype(
            np.float32)
        feat_dim = 3 if use_feature else 1
        fe = np.concatenate(
            [base, xy], 1).astype(np.float32) if use_feature else base
        graphs.append((src, dst, n))
        nfeats.append(fe + 0.1 * rng.normal(size=(n, feat_dim)).astype(
            np.float32))
        labels.append(y)
    return graphs, nfeats, np.asarray(labels, np.int64)


def ce_loss(preds, labels, weights):
    logp = torch.log_softmax(preds, -1)
    cel = -logp.gather(1, labels[:, None])[:, 0]
    return (cel * weights).sum() / weights.sum().clamp_min(1.0)


def build_model(args, feat_dim: int, num_classes: int,
                generator: Optional[torch.Generator] = None):
    common = dict(
        num_layers=args.nlayers, input_dropout=args.input_dropout,
        edge_dropout=args.edge_dropout, dropout=args.dropout,
        norm=args.norm, readout_layers=args.readout_layers,
        readout_dropout=args.readout_dropout,
        readout_pooling=args.readout_pooling,
        jumping_knowledge=args.jumping_knowledge,
        residual=args.residual, resid_layers=args.resid_layers,
        resid_dropout=args.resid_dropout, agg_type=args.agg_type,
        generator=generator)
    # raw features in (model.py:40)
    if args.model == "SIR":
        return GraphSIRModel(nn.Identity(), feat_dim, args.nhidden,
                             num_classes, feat_dropout=args.feat_dropout,
                             **common)
    return GraphGINModel(nn.Identity(), feat_dim, args.nhidden, num_classes,
                         mlp_layers=args.nlayers_mlp, **common)



def load_superpixel(args, seed):
    """(graphs, node feats, labels, (train, val, test)): the npz cache, or
    the synthetic stand-in with a fifth of its graphs (at most 5000) held
    out for validation."""
    name = f"superpixel-{args.dataset.lower()}"
    if has_cache(name):
        z, graphs, nodes, _ = load_graph_cache(name)
        return (graphs, [f.astype(np.float32) for f in nodes("node_feat")],
                z["labels"].astype(np.int64),
                (z["train_idx"], z["val_idx"], z["test_idx"]))
    graphs, nfeats, labels = synthetic_superpixel(
        args.synthetic_samples, NUM_CLASSES, args.use_feature, seed)
    print("[warn] no super-pixel cache; synthetic stand-in")
    n = len(graphs)
    idx = np.arange(n)
    n_val = min(n // 5, 5000)
    return (graphs, nfeats, labels,
            (idx[n_val:int(0.9 * n)], idx[:n_val], idx[int(0.9 * n):]))


def run_single(args, seed: int, device: torch.device,
               stats: Optional[dict] = None, time_steps: bool = False):
    graphs, nfeats, labels, (tr, va, te) = load_superpixel(args, seed)
    if args.add_self_loop:
        graphs, _ = apply_self_loops(graphs, None)
    coll = GraphCollection(graphs, node_feats=nfeats, labels=labels)
    model = build_model(args, nfeats[0].shape[-1], NUM_CLASSES,
                        torch.Generator().manual_seed(seed))
    return run_batched_workload(
        model=model, coll=coll, train_idx=tr, val_idx=va, test_idx=te,
        args=args, seed=seed, loss_fn=ce_loss,
        metric_fn=lambda p, l: accuracy(p, l.astype(np.int64)),
        minimize_metric=False, device=device, warmup_size=10,
        label_dtype=torch.int64, stats=stats, time_steps=time_steps,
    )


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "SIR-GCN on MNIST/CIFAR10 super-pixels (PyTorch + CUDA port)",
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
    p.add_argument("--dataset", type=str, default="MNIST",
                   choices=["MNIST", "CIFAR10"])
    p.add_argument("--model", type=str, default="SIR",
                   choices=["SIR", "GIN"])
    p.add_argument("--nlayers-mlp", type=int, default=2)
    p.add_argument("--use-feature", action="store_true")
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
    p.add_argument("--add-self-loop", action="store_true")
    p.add_argument("--epochs", type=int, default=200)
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
    p.add_argument("--synthetic-samples", type=int, default=500)
    return p


def _rank_main(argv: list, time_steps: bool):
    """``main`` on one rank of a ``--dp-devices`` run; its stats come back
    to the spawning process with the metrics."""
    stats = []
    vals, tests = main(argv, stats, time_steps)
    return vals, tests, stats


def main(argv=None, stats: Optional[list] = None, time_steps: bool = False):
    """Train ``--nruns`` runs; returns (val accuracies, test accuracies).
    With ``stats`` (a list) each run appends its harness stats."""
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

    val_accs, test_accs = [], []
    for i in range(args.nruns):
        run_stats = {}
        r = run_single(args, args.seed + i, device, run_stats, time_steps)
        if stats is not None:
            stats.append(run_stats)
        val_accs.append(r["val_metric"])
        test_accs.append(r["test_metric"])

    print(f"Runned {args.nruns} times")
    aggregate_runs("val accuracy", val_accs)
    aggregate_runs("test accuracy", test_accs)
    return val_accs, test_accs


if __name__ == "__main__":
    main()
