"""Heterophilous-datasets harness (port of
``experiments/heterophilous/train.py``; reference
``benchmark-datasets/heterophilous-datasets/train.py``): five datasets
(roman-empire, amazon-ratings, minesweeper, tolokers, questions) over 10
predefined splits; the binary ones take BCE on logits and ROC-AUC, the
others CE and accuracy (train.py:44-56); best-by-val-loss; ``--use-amp``
rounds the input features to bf16 (the model's ``use_bf16``). Reads the
npz cache if there is one, else a synthetic stand-in (flagged, not a
parity number). The flags are the JAX harness's, so its README commands
run unchanged.

Runs on the CUDA card unless ``--cpu`` is given; with no card and no
``--cpu`` it raises. The graph is a FastGraph, so each SIRConv's erf-GELU
aggregate runs on the elementwise kernels (mean, sum, sym) or the max
kernels (``--agg-type max``); ``--no-fast-path`` keeps the plain
``GraphBatch`` and the CSR aggregate.

    python -m sir_gcn_tpu_torch.experiments.heterophilous.train \\
        --dataset minesweeper --use-amp
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ...data import has_cache, synthetic_node_classification
from ...data.loaders import _cache_path
from ...graph import add_self_loops, build_graph, remove_self_loops
from ...ops.ell import build_fast_graph
from ...ops.message_passing import set_edge_dtype
from ...train import aggregate_runs, resolve_device
from ...train.metrics import accuracy, roc_auc
from ..fullgraph_harness import (
    masked_bce_logits,
    masked_ce,
    pad_inputs,
    run_fullgraph_workload,
)
from .model import SIRModel

DATASETS = ("roman-empire", "amazon-ratings", "minesweeper", "tolokers",
            "questions")
BINARY = {"minesweeper", "tolokers", "questions"}
NUM_SPLITS = 10


def load_hetero(args, seed, split):
    """(src, dst, feat, labels, train, val, test masks, synthetic) of
    ``args.dataset``'s split ``split``: the npz cache, else the synthetic
    stand-in of seed ``seed * NUM_SPLITS + split`` (2 classes for a binary
    dataset, else 8; homophily 0.15)."""
    name = args.dataset
    if has_cache(name):
        z = np.load(_cache_path(name))
        return (z["src"], z["dst"], z["feat"].astype(np.float32),
                z["labels"].astype(np.int64), z["train_masks"][split],
                z["val_masks"][split], z["test_masks"][split], False)
    classes = 2 if name in BINARY else 8
    d = synthetic_node_classification(
        num_nodes=args.synthetic_nodes, num_edges=args.synthetic_edges,
        feat_dim=128, num_classes=classes, homophily=0.15,
        seed=seed * NUM_SPLITS + split)
    n = d.feat.shape[0]

    def m(idx):
        w = np.zeros(n, bool)
        w[idx] = True
        return w

    return (d.src, d.dst, d.feat, d.labels, m(d.train_idx),
            m(d.val_idx), m(d.test_idx), True)


def build_model(args, input_dim: int, num_classes: int,
                generator: Optional[torch.Generator] = None) -> SIRModel:
    return SIRModel(
        input_dim, args.nhidden, num_classes, num_layers=args.nlayers,
        input_dropout=args.input_dropout, dropout=args.dropout,
        norm=args.norm, residual=args.residual,
        feat_dropout=args.feat_dropout, agg_type=args.agg_type,
        use_bf16=args.use_amp, generator=generator)


def prepare(args, seed: int, split: int, device: torch.device) -> dict:
    """The graph (a FastGraph unless ``--no-fast-path``) on ``device`` and
    the padded host arrays of one run: feats, labels (f32 for a binary
    dataset, else int32), the three split masks, the class count."""
    src, dst, feat, labels, tr, va, te, synthetic = load_hetero(
        args, seed, split)
    if synthetic:
        print("[warn] no cache for", args.dataset, "; synthetic stand-in")
    n = feat.shape[0]
    if args.add_self_loop:
        src, dst = remove_self_loops(src, dst)
        src, dst = add_self_loops(src, dst, n)
    graph = build_graph(src, dst, n, pad_multiple=128, device=device)
    if not args.no_fast_path:
        graph = build_fast_graph(graph)

    binary = args.dataset in BINARY
    feats_p, labels_p, masks = pad_inputs(
        graph.n_pad, feat, labels, (tr, va, te),
        np.float32 if binary else np.int32)
    return dict(graph=graph, feats=feats_p, labels=labels_p, masks=masks,
                num_classes=1 if binary else int(labels.max()) + 1)


def run_single(args, seed: int, split: int, device: torch.device,
               stats: Optional[dict] = None, time_steps: bool = False):
    run = prepare(args, seed, split, device)
    model = build_model(args, run["feats"].shape[1], run["num_classes"],
                        torch.Generator().manual_seed(seed))
    if args.dataset in BINARY:
        loss_fn = masked_bce_logits
        metric = lambda lg, lb: roc_auc(lg[:, 0], lb)
    else:
        loss_fn = masked_ce
        metric = lambda lg, lb: accuracy(lg, lb.astype(np.int64))
    return run_fullgraph_workload(
        model=model, graph=run["graph"], feats=run["feats"],
        labels=run["labels"], masks=run["masks"], args=args, seed=seed,
        device=device, loss_fn=loss_fn, metric_fn=metric, stats=stats,
        time_steps=time_steps)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "SIR-GCN on HeterophilousGraphs (PyTorch + CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--edge-bf16", action="store_true",
                   help="carry the message-passing edge pipeline in "
                        "bfloat16 (f32 accumulation)")
    p.add_argument("--gpu", type=int, default=0,
                   help="ignored (the card is CUDA device 0); accepted so "
                        "reference commands run unchanged")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use-amp", action="store_true",
                   help="round the input features to bf16 (the JAX "
                        "package's bf16 policy); compute stays f32")
    p.add_argument("--dataset", type=str, default="roman-empire",
                   choices=list(DATASETS))
    p.add_argument("--model", type=str, default="SIR", choices=["SIR"])
    p.add_argument("--nhidden", type=int, default=512)
    p.add_argument("--nlayers", type=int, default=5)
    p.add_argument("--input-dropout", type=float, default=0)
    p.add_argument("--dropout", type=float, default=0)
    p.add_argument("--norm", type=str, default="none",
                   choices=["bn", "ln", "none"])
    p.add_argument("--residual", action="store_true")
    p.add_argument("--feat-dropout", type=float, default=0)
    p.add_argument("--agg-type", type=str, default="mean",
                   choices=["sum", "max", "mean", "sym"])
    p.add_argument("--add-self-loop", action="store_true")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--wd", type=float, default=0)
    p.add_argument("--l1", type=float, default=0)
    p.add_argument("--l2", type=float, default=0)
    p.add_argument("--factor", type=float, default=0.5)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--nruns", type=int, default=1)
    p.add_argument("--nsplits", type=int, default=NUM_SPLITS)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--no-fast-path", action="store_true")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="devices to partition the graph over (0/1 = one "
                        "device; more raises: not yet ported)")
    p.add_argument("--dist-path", type=str, default="halo",
                   choices=["halo", "gspmd"])
    p.add_argument("--synthetic-nodes", type=int, default=2048)
    p.add_argument("--synthetic-edges", type=int, default=16384)
    return p


def main(argv=None, stats: Optional[list] = None, time_steps: bool = False):
    """Train ``--nruns`` x ``--nsplits`` runs; returns (val metrics, test
    metrics). With ``stats`` (a list) each run appends its harness
    stats."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.cpu)
    set_edge_dtype(torch.bfloat16 if args.edge_bf16 else None)

    vals, tests = [], []
    for i in range(args.nruns):
        for split in range(args.nsplits):
            run_stats = {}
            r = run_single(args, args.seed + i, split, device, run_stats,
                           time_steps)
            if stats is not None:
                stats.append(run_stats)
            vals.append(r["val_metric"])
            tests.append(r["test_metric"])

    name = "ROC-AUC" if args.dataset in BINARY else "accuracy"
    print(f"Runned {args.nruns} x {args.nsplits} times")
    aggregate_runs(f"val {name}", vals)
    aggregate_runs(f"test {name}", tests)
    return vals, tests


if __name__ == "__main__":
    main()
