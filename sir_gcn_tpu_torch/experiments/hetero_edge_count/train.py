"""HeteroEdgeCount training harness (port of
``experiments/hetero_edge_count/train.py``; reference
``synthetic-datasets/hetero-edge-count/train.py``): graph regression of
an exactly computable statistic. SIR-GCN reaches a test MSE near 1e-3
where GCN and GAT stay at the variance of the target. The flags are the
reference's, so its README commands run unchanged.

Runs on the CUDA card unless ``--cpu`` is given; with no card and no
``--cpu`` it raises. Each batch is collated on the host into the
dataset's one bucket (``GraphCollection``) and runs the CSR aggregate of
a plain ``GraphBatch``, as in the JAX package.

    python -m sir_gcn_tpu_torch.experiments.hetero_edge_count.train \\
        --classes 2 --nhidden 20 --nruns 1
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from ...data import GraphCollection, HeteroEdgeCountDataset
from ...ops.message_passing import set_edge_dtype
from ...train import (
    EpochDriver,
    aggregate_runs,
    make_adamw,
    param_count,
    resolve_device,
    set_lr_scale,
    set_seed,
    synchronize,
)
from .model import MODELS


def weighted_mse(pred, labels, weights):
    """Squared error averaged over the weighted graphs."""
    se = (labels - pred).square()
    return (se * weights).sum() / weights.sum().clamp_min(1.0)


def make_harness(model, optimizer):
    """The train step (forward, weighted MSE, backward, AdamW) and the
    eval step ((MSE, weight sum) as device scalars, no gradient) of one
    collated batch ``(graph, node_feats, labels, graph_weights)``."""

    def train_step(graph, feats, labels, weights, generator):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        pred = model(graph, feats, generator=generator)[:, 0]
        loss = weighted_mse(pred, labels, weights)
        loss.backward()
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(graph, feats, labels, weights):
        model.eval()
        return (weighted_mse(model(graph, feats)[:, 0], labels, weights),
                weights.sum())

    return train_step, eval_step


def batch_tensors(batch: dict, device) -> tuple:
    """``(graph, node_feats, labels, graph_weights)`` of a collated batch,
    the arrays as tensors on ``device``."""
    return (batch["graph"],
            *(torch.from_numpy(batch[k]).to(device)
              for k in ("node_feats", "labels", "graph_weights")))


def run_single(args, seed: int, device: torch.device,
               stats: Optional[dict] = None, time_steps: bool = False):
    """One run; returns (train MSE, test MSE) of its last epoch. With
    ``stats`` (a dict) it also records ``epochs``, ``seconds`` and
    ``collate_ms`` (each batch's collation and copy to the device), and
    with ``time_steps`` ``step_ms``, each train step timed between two
    device syncs."""
    set_seed(seed)
    t_run = time.perf_counter()
    ds = HeteroEdgeCountDataset(
        args.nodes, args.classes, args.samples, normalize=args.normalize,
        rng=np.random.default_rng(seed))
    coll = GraphCollection(ds.graphs, node_feats=ds.feats, labels=ds.labels)
    n_train = int(args.train_size * len(ds))
    train_idx = np.arange(n_train)
    test_idx = np.arange(n_train, len(ds))

    extra = ({} if args.model == "SIR"
             else {"num_heads": args.nheads, "mlp_layers": args.nlayers_mlp})
    model = MODELS[args.model](
        args.classes, args.nhidden, 1, num_layers=args.nlayers,
        dropout=args.dropout,
        generator=torch.Generator().manual_seed(seed), **extra).to(device)
    optimizer = make_adamw(model.parameters(), args.lr, args.wd)
    print(f"Params: {param_count(model)}")
    train_step, eval_step = make_harness(model, optimizer)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)
    step_ms, collate_ms = [], []

    def batches(idx, shuffle_rng=None):
        it = coll.loader(idx, args.batch_size, shuffle_rng, device=device)
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            if b is None:
                return
            b = batch_tensors(b, device)
            if stats is not None:
                collate_ms.append((time.perf_counter() - t0) * 1e3)
            yield b

    def evaluate(idx):
        parts = torch.stack([torch.stack(eval_step(*b))
                             for b in batches(idx)]).double().cpu().numpy()
        return float((parts[:, 0] * parts[:, 1]).sum() / parts[:, 1].sum())

    driver = EpochDriver(epochs=args.epochs, factor=args.factor,
                         patience=args.patience, log_every=args.log_every)
    shuffle_rng = np.random.default_rng(seed + 12345)
    loss = test_loss = float("inf")
    epoch = 0
    for epoch in range(1, args.epochs + 1):
        # the warmup and plateau scale apply to THIS epoch's steps
        set_lr_scale(optimizer, driver.lr_scale(epoch))
        for b in batches(train_idx, shuffle_rng):
            if not time_steps:
                train_step(*b, dropout_gen)
                continue
            synchronize(device)
            t0 = time.perf_counter()
            train_step(*b, dropout_gen)
            synchronize(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        loss = evaluate(train_idx)
        test_loss = evaluate(test_idx)
        driver.plateau_step(epoch, loss)

        if driver.should_log(epoch):
            print(f"Epoch {epoch:04d} | loss: {loss:.4f} | "
                  f"test_loss: {test_loss:.4f}")
        if loss < 1e-3 and test_loss < 1e-3:
            break

    if stats is not None:
        stats.update(epochs=epoch, seconds=time.perf_counter() - t_run,
                     collate_ms=collate_ms)
        if time_steps:
            stats["step_ms"] = step_ms
    return loss, test_loss


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "SIR-GCN/GCN/GAT on HeteroEdgeCount (PyTorch + CUDA port)",
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
    p.add_argument("--model", type=str, default="SIR", choices=list(MODELS))
    p.add_argument("--nhidden", type=int, default=64)
    p.add_argument("--nlayers", type=int, default=1)
    p.add_argument("--dropout", type=float, default=0)
    p.add_argument("--nheads", type=int, default=1)
    p.add_argument("--nlayers-mlp", type=int, default=1)
    p.add_argument("--nodes", type=int, default=50,
                   help="maximum number of nodes in random graphs")
    p.add_argument("--classes", type=int, default=5)
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--samples", type=int, default=5000)
    p.add_argument("--train-size", type=float, default=0.8)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--wd", type=float, default=0)
    p.add_argument("--factor", type=float, default=0.5)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--nruns", type=int, default=10)
    p.add_argument("--log-every", type=int, default=20)
    return p


def main(argv=None, stats: Optional[list] = None,
         time_steps: bool = False):
    """Train ``--nruns`` runs; returns (train MSEs, test MSEs). With
    ``stats`` (a list) each run appends its :func:`run_single` stats (with
    ``step_ms`` if ``time_steps``)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.cpu)
    set_edge_dtype(torch.bfloat16 if args.edge_bf16 else None)

    losses, test_losses = [], []
    for i in range(args.nruns):
        run_stats = {}
        loss, test_loss = run_single(args, args.seed + i, device, run_stats,
                                     time_steps)
        if stats is not None:
            stats.append(run_stats)
        losses.append(loss)
        test_losses.append(test_loss)
        # per-run progress on stderr, so an interrupted protocol keeps its
        # finished seeds (stdout keeps the reference's shape)
        print(f"[run {i} seed {args.seed + i}] train MSE {loss:.8f} "
              f"test MSE {test_loss:.8f} ({run_stats['epochs']} epochs, "
              f"{run_stats['seconds']:.1f} s)", file=sys.stderr, flush=True)

    print(args)
    print(f"Runned {args.nruns} times")
    aggregate_runs("train MSE", losses)
    aggregate_runs("test MSE", test_losses)
    return losses, test_losses


if __name__ == "__main__":
    main()
