"""wiki-cs harness (port of ``experiments/wiki_cs/train.py``; reference
``benchmark-datasets/wiki-cs/train.py``): full-graph node classification
over 20 predefined splits x nruns (train.py:161-168), the ``val`` and
``stopping`` masks merged (train.py:44), CE loss, best-by-val-loss. The
SIR model is the batched workloads' ``GraphSIRModel`` on the raw features
(an identity encoder, model.py:34) with per-layer DropEdge, JK readouts
and MLP residuals (model.py:12-50), unpooled; the GATv2 baseline is the
arxiv ``GATModel`` (model.py:53-90). Reads the npz cache if there is one,
else a synthetic stand-in (flagged, not a parity number). The flags are
the JAX harness's, so its README commands run unchanged.

Runs on the CUDA card unless ``--cpu`` is given; with no card and no
``--cpu`` it raises. The graph is a FastGraph, so the SIR convs' aggregate
runs on the kernels (``--no-fast-path`` keeps the CSR aggregate).

    python -m sir_gcn_tpu_torch.experiments.wiki_cs.train \\
        --jumping-knowledge --resid-layers 1
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...data import has_cache, synthetic_node_classification
from ...data.loaders import _cache_path
from ...graph import (
    add_self_loops,
    build_graph,
    remove_self_loops,
    to_bidirected,
)
from ...ops.ell import build_fast_graph
from ...ops.message_passing import set_edge_dtype
from ...train import aggregate_runs, resolve_device
from ...train.metrics import accuracy
from ..common_models import GraphSIRModel
from ..fullgraph_harness import pad_inputs, run_fullgraph_workload
from ..ogbn_arxiv.model import GATModel

NUM_SPLITS = 20


def load_wiki(args, seed, split):
    """(src, dst, feat, labels, train, val, test masks, synthetic) of split
    ``split``: the npz cache, else the synthetic stand-in of seed
    ``seed * NUM_SPLITS + split`` (300 features, 10 classes)."""
    if has_cache("wiki-cs"):
        z = np.load(_cache_path("wiki-cs"))
        src, dst, feat = z["src"], z["dst"], z["feat"].astype(np.float32)
        labels = z["labels"].astype(np.int64)
        tr = z["train_masks"][split]
        va = (z["val_masks"][split] | z["stopping_masks"][split])
        te = z["test_mask"]
        return src, dst, feat, labels, tr, va, te, False
    d = synthetic_node_classification(
        num_nodes=args.synthetic_nodes, num_edges=args.synthetic_edges,
        feat_dim=300, num_classes=10, seed=seed * NUM_SPLITS + split)
    n = d.feat.shape[0]
    masks = []
    for idx in (d.train_idx, d.val_idx, d.test_idx):
        m = np.zeros(n, bool)
        m[idx] = True
        masks.append(m)
    return (d.src, d.dst, d.feat, d.labels, *masks, True)


def build_model(args, input_dim: int, num_classes: int,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """The ``--model`` of ``args``: GraphSIRModel or the GATv2 baseline."""
    kwargs = dict(
        num_layers=args.nlayers, input_dropout=args.input_dropout,
        edge_dropout=args.edge_dropout, dropout=args.dropout,
        norm=args.norm, readout_layers=args.readout_layers,
        readout_dropout=args.readout_dropout,
        jumping_knowledge=args.jumping_knowledge, residual=args.residual,
        generator=generator)
    if args.model == "SIR":
        return GraphSIRModel(
            nn.Identity(), input_dim, args.nhidden, num_classes,
            resid_layers=args.resid_layers, resid_dropout=args.resid_dropout,
            feat_dropout=args.feat_dropout, agg_type=args.agg_type,
            pool_after_readout=False, **kwargs)
    return GATModel(input_dim, args.nhidden, num_classes,
                    num_heads=args.nheads, attn_dropout=args.attn_dropout,
                    **kwargs)


def prepare(args, seed: int, split: int, device: torch.device) -> dict:
    """The graph (a FastGraph unless ``--no-fast-path``) on ``device`` and
    the padded host arrays of one run."""
    src, dst, feat, labels, tr, va, te, synthetic = load_wiki(
        args, seed, split)
    if synthetic:
        print("[warn] no wiki-cs cache; synthetic stand-in")
    n = feat.shape[0]
    if args.add_reverse_edge:
        src, dst = to_bidirected(src, dst)
    if args.add_self_loop:
        src, dst = remove_self_loops(src, dst)
        src, dst = add_self_loops(src, dst, n)
    graph = build_graph(src, dst, n, pad_multiple=128, device=device)
    if not args.no_fast_path:
        graph = build_fast_graph(graph)

    feats_p, labels_p, masks = pad_inputs(graph.n_pad, feat, labels,
                                          (tr, va, te), np.int32)
    return dict(graph=graph, feats=feats_p, labels=labels_p, masks=masks,
                num_classes=int(labels.max()) + 1)


def run_single(args, seed: int, split: int, device: torch.device,
               stats: Optional[dict] = None, time_steps: bool = False):
    run = prepare(args, seed, split, device)
    model = build_model(args, run["feats"].shape[1], run["num_classes"],
                        torch.Generator().manual_seed(seed))
    return run_fullgraph_workload(
        model=model, graph=run["graph"], feats=run["feats"],
        labels=run["labels"], masks=run["masks"], args=args, seed=seed,
        device=device,
        metric_fn=lambda lg, lb: accuracy(lg, lb.astype(np.int64)),
        stats=stats, time_steps=time_steps)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "SIR-GCN/GATv2 on WikiCS (PyTorch + CUDA port)",
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
    p.add_argument("--model", type=str, default="SIR",
                   choices=["SIR", "GAT"])
    p.add_argument("--nhidden", type=int, default=64)
    p.add_argument("--nlayers", type=int, default=4)
    p.add_argument("--input-dropout", type=float, default=0)
    p.add_argument("--edge-dropout", type=float, default=0)
    p.add_argument("--dropout", type=float, default=0)
    p.add_argument("--norm", type=str, default="none",
                   choices=["cn", "bn", "ln", "none"])
    p.add_argument("--readout-layers", type=int, default=1)
    p.add_argument("--readout-dropout", type=float, default=0)
    p.add_argument("--jumping-knowledge", action="store_true")
    p.add_argument("--residual", action="store_true")
    p.add_argument("--resid-layers", type=int, default=0)
    p.add_argument("--resid-dropout", type=float, default=0)
    p.add_argument("--feat-dropout", type=float, default=0)
    p.add_argument("--agg-type", type=str, default="mean",
                   choices=["sum", "max", "mean", "sym"])
    p.add_argument("--nheads", type=int, default=1)
    p.add_argument("--attn-dropout", type=float, default=0)
    p.add_argument("--add-self-loop", action="store_true")
    p.add_argument("--add-reverse-edge", action="store_true")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--wd", type=float, default=0)
    p.add_argument("--l1", type=float, default=0)
    p.add_argument("--l2", type=float, default=0)
    p.add_argument("--factor", type=float, default=0.5)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--nruns", type=int, default=10)
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
    """Train ``--nruns`` x ``--nsplits`` runs; returns (val accuracies, test
    accuracies). With ``stats`` (a list) each run appends its harness
    stats."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.cpu)
    set_edge_dtype(torch.bfloat16 if args.edge_bf16 else None)

    val_accs, test_accs = [], []
    for i in range(args.nruns):
        for split in range(args.nsplits):
            run_stats = {}
            r = run_single(args, args.seed + i, split, device, run_stats,
                           time_steps)
            if stats is not None:
                stats.append(run_stats)
            val_accs.append(r["val_metric"])
            test_accs.append(r["test_metric"])

    print(f"Runned {args.nruns} x {args.nsplits} times")
    aggregate_runs("val accuracy", val_accs)
    aggregate_runs("test accuracy", test_accs)
    return val_accs, test_accs


if __name__ == "__main__":
    main()
