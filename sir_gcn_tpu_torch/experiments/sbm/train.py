"""SBM PATTERN/CLUSTER harness (port of ``experiments/sbm/train.py``;
reference ``benchmark-datasets/sbm-dataset/train.py``): inductive node
classification on batched SBM graphs, a class-weighted CE whose weights
come from each batch's labels (train.py:52-56), class-balanced accuracy
(train.py:58-61). Model: an embedding, the SIRConv stack and per-node JK
readouts (model.py:12-53), or the GATv2 baseline. The flags are the
reference's.

Runs on the CUDA card unless ``--cpu`` is given; with no card and no
``--cpu`` it raises.

    python -m sir_gcn_tpu_torch.experiments.sbm.train --dataset PATTERN \\
        --nruns 1
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from ...data import GraphCollection, has_cache, load_graph_cache
from ...models import Embed
from ...ops.message_passing import set_edge_dtype
from ...parallel.multihost import needs_spawn, spawn_ranks, trainer_device
from ...train import aggregate_runs
from ...train.metrics import balanced_accuracy
from ..batched_harness import (
    apply_self_loops,
    run_batched_workload,
)
from ..common_models import GraphGATModel, GraphSIRModel


def synthetic_sbm(num_graphs, num_nodes, num_classes, seed):
    """PATTERN/CLUSTER-shaped SBM: block-structured random graphs; each
    node's label is its block; its feature the block with probability
    0.5, else ``num_classes`` ("unknown", the real datasets' one-hot
    vocabulary)."""
    rng = np.random.default_rng(seed)
    graphs, nfeats, nlabels = [], [], []
    for _ in range(num_graphs):
        n = int(rng.integers(num_nodes // 2, num_nodes + 1))
        blocks = rng.integers(0, num_classes, n)
        p_in, p_out = 0.5, 0.2
        probs = np.where(blocks[:, None] == blocks[None, :], p_in, p_out)
        adj = rng.random((n, n)) < probs
        np.fill_diagonal(adj, False)
        src, dst = np.nonzero(adj)
        hint = rng.random(n) < 0.5
        feats = np.where(hint, blocks, num_classes).astype(np.int32)
        graphs.append((src.astype(np.int32), dst.astype(np.int32), n))
        nfeats.append(feats)
        nlabels.append(blocks.astype(np.int32))
    return graphs, nfeats, nlabels


def make_weighted_ce(num_classes: int):
    def weighted_ce(preds, labels, weights):
        """Class-weighted CE with weights from the batch's label
        histogram (reference train.py:52-56: w_c = (n - n_c) * (n_c > 0)
        / n)."""
        n = weights.sum().clamp_min(1.0)
        counts = weights.new_zeros(num_classes).index_add(0, labels,
                                                          weights)
        cw = (n - counts) * (counts > 0) / n
        logp = torch.log_softmax(preds, -1)
        ce = -logp.gather(1, labels[:, None])[:, 0]
        w = weights * cw.index_select(0, labels)
        return (ce * w).sum() / w.sum().clamp_min(1e-9)

    return weighted_ce


def build_model(args, input_dim: int, num_classes: int,
                generator: Optional[torch.Generator] = None):
    common = dict(
        num_layers=args.nlayers, input_dropout=args.input_dropout,
        edge_dropout=args.edge_dropout, dropout=args.dropout,
        norm=args.norm, readout_layers=args.readout_layers,
        readout_dropout=args.readout_dropout,
        jumping_knowledge=args.jumping_knowledge, residual=args.residual,
        pool_after_readout=False, generator=generator)
    if args.model == "GAT":
        # reference sbm model.py:69: Embedding(input, heads * hidden)
        encoder = Embed(input_dim, args.nheads * args.nhidden,
                        generator=generator)
        return GraphGATModel(encoder, args.nhidden, num_classes,
                             num_heads=args.nheads,
                             attn_dropout=args.attn_dropout, **common)
    encoder = Embed(input_dim, args.nhidden, generator=generator)
    return GraphSIRModel(encoder, args.nhidden, args.nhidden, num_classes,
                         resid_layers=args.resid_layers,
                         resid_dropout=args.resid_dropout,
                         feat_dropout=args.feat_dropout,
                         agg_type=args.agg_type, **common)


def load_sbm(args, seed):
    """(graphs, node feats, node labels, (train, val, test), input vocabulary
    size, number of classes): the npz cache, or the synthetic stand-in."""
    name = f"sbm-{args.dataset.lower()}"
    num_classes = 2 if args.dataset == "PATTERN" else 6
    if has_cache(name):
        z, graphs, nodes, _ = load_graph_cache(name)
        nfeats = nodes("node_feat")
        return (graphs, nfeats, nodes("node_label"),
                (z["train_idx"], z["val_idx"], z["test_idx"]),
                int(max(f.max() for f in nfeats)) + 1, num_classes)
    graphs, nfeats, nlabels = synthetic_sbm(args.synthetic_samples, 40,
                                            num_classes, seed)
    print("[warn] no SBM cache; synthetic stand-in")
    n = len(graphs)
    idx = np.arange(n)
    return (graphs, nfeats, nlabels,
            (idx[:int(0.8 * n)], idx[int(0.8 * n):int(0.9 * n)],
             idx[int(0.9 * n):]), num_classes + 1, num_classes)


def run_single(args, seed: int, device: torch.device,
               stats: Optional[dict] = None, time_steps: bool = False):
    graphs, nfeats, nlabels, (tr, va, te), input_dim, num_classes = \
        load_sbm(args, seed)
    if args.add_self_loop:
        graphs, _ = apply_self_loops(graphs, None)
    coll = GraphCollection(graphs, node_feats=nfeats, node_labels=nlabels)
    model = build_model(args, input_dim, num_classes,
                        torch.Generator().manual_seed(seed))
    return run_batched_workload(
        model=model, coll=coll, train_idx=tr, val_idx=va, test_idx=te,
        args=args, seed=seed, loss_fn=make_weighted_ce(num_classes),
        metric_fn=lambda p, l: balanced_accuracy(
            p, l.astype(np.int64), num_classes),
        minimize_metric=False, device=device, warmup_size=10,
        node_level=True, label_dtype=torch.int64, stats=stats,
        time_steps=time_steps,
    )


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "SIR-GCN on SBM PATTERN/CLUSTER (PyTorch + CUDA port)",
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
    p.add_argument("--dataset", type=str, default="PATTERN",
                   choices=["PATTERN", "CLUSTER"])
    p.add_argument("--model", type=str, default="SIR",
                   choices=["SIR", "GAT"])
    p.add_argument("--nheads", type=int, default=1,
                   help="number of attention heads (GAT)")
    p.add_argument("--attn-dropout", type=float, default=0,
                   help="attention dropout rate (GAT)")
    p.add_argument("--nhidden", type=int, default=64)
    p.add_argument("--nlayers", type=int, default=4)
    p.add_argument("--input-dropout", type=float, default=0)
    p.add_argument("--edge-dropout", type=float, default=0)
    p.add_argument("--dropout", type=float, default=0)
    p.add_argument("--norm", type=str, default="none",
                   choices=["gn", "cn", "bn", "ln", "none"])
    p.add_argument("--readout-layers", type=int, default=1)
    p.add_argument("--readout-dropout", type=float, default=0)
    p.add_argument("--jumping-knowledge", action="store_true")
    p.add_argument("--residual", action="store_true")
    p.add_argument("--resid-layers", type=int, default=0)
    p.add_argument("--resid-dropout", type=float, default=0)
    p.add_argument("--feat-dropout", type=float, default=0)
    p.add_argument("--agg-type", type=str, default="mean",
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
    """Train ``--nruns`` runs; returns (val balanced accuracies, test
    balanced accuracies). With ``stats`` (a list) each run appends its
    harness stats."""
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
    aggregate_runs("val balanced accuracy", val_accs)
    aggregate_runs("test balanced accuracy", test_accs)
    return val_accs, test_accs


if __name__ == "__main__":
    main()
