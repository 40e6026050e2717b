"""DictionaryLookup training harness (port of
``experiments/dictionary_lookup/train.py``; reference
``synthetic-datasets/dictionary-lookup/train.py``): the paper's
discriminative-power probe. SIR-GCN must reach test accuracy 1.0 where
GCN sits at chance. The flags are the reference's, so its README commands
run unchanged.

Runs on the CUDA card unless ``--cpu`` is given; with no card and no
``--cpu`` it raises. Every batch runs the CSR aggregate of a plain
``GraphBatch`` (``ops/segment.py``), as in the JAX package: no ELL plan.

    python -m sir_gcn_tpu_torch.experiments.dictionary_lookup.train \\
        --nodes 10 --nhidden 40 --nruns 1
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from ...data import DictionaryLookupDataset
from ...graph import GraphBatch, batch_graphs
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


def make_batcher(ds: DictionaryLookupDataset, batch_size: int,
                 device: torch.device | str = "cpu") -> GraphBatch:
    """Every sample has one structure: one padded template of
    ``batch_size`` copies on ``device``, reused by every batch (graph b
    holds nodes [b*2n, (b+1)*2n), keys first)."""
    return batch_graphs(
        [(ds.src, ds.dst, ds.graph_num_nodes)] * batch_size,
        g_pad=batch_size + 1, device=device)


def pad_batch(feats, labels, batch_size, n, n_pad):
    """Stack the features and labels of a (possibly partial) batch into
    padded per-node arrays: feats [n_pad, 2], labels [n_pad] and weights
    [n_pad], 1 on the key nodes of real samples."""
    b = feats.shape[0]
    out_feats = np.zeros((n_pad, 2), np.int32)
    out_labels = np.zeros(n_pad, np.int32)
    weights = np.zeros(n_pad, np.float32)
    out_feats[: b * 2 * n] = feats.reshape(b * 2 * n, 2)
    for i in range(b):
        sl = slice(i * 2 * n, i * 2 * n + n)
        out_labels[sl] = labels[i]
        weights[sl] = 1.0
    return out_feats, out_labels, weights


def weighted_ce(logits, labels, weights):
    """Cross-entropy averaged over the weighted nodes."""
    logp = torch.log_softmax(logits, -1)
    ce = -logp.gather(1, labels[:, None])[:, 0]
    return (ce * weights).sum() / weights.sum().clamp_min(1.0)


def make_harness(model, template: GraphBatch, optimizer):
    """The train step (forward, weighted CE, backward, AdamW) and the eval
    step ((loss, weighted count of correct nodes, weight sum) as device
    scalars, no gradient), both on the template graph. Labels are int64
    tensors."""

    def train_step(feats, labels, weights, generator):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = weighted_ce(model(template, feats, generator=generator),
                           labels, weights)
        loss.backward()
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(feats, labels, weights):
        model.eval()
        logits = model(template, feats)
        correct = (logits.argmax(-1) == labels).to(weights.dtype)
        return (weighted_ce(logits, labels, weights),
                (correct * weights).sum(), weights.sum())

    return train_step, eval_step


def run_single(args, seed: int, device: torch.device,
               stats: Optional[dict] = None, time_steps: bool = False):
    """One run; returns (train accuracy, test accuracy) of its last epoch.
    With ``stats`` (a dict) it also records ``epochs`` and ``seconds``,
    and with ``time_steps`` ``step_ms``, each train step timed between
    two device syncs."""
    set_seed(seed)
    t_run = time.perf_counter()
    ds = DictionaryLookupDataset(args.nodes, args.samples,
                                 rng=np.random.default_rng(seed))
    n = args.nodes
    n_train = int(args.train_size * len(ds))
    train_idx = np.arange(n_train)
    test_idx = np.arange(n_train, len(ds))
    template = make_batcher(ds, args.batch_size, device)
    n_pad = template.n_pad

    extra = ({} if args.model == "SIR"
             else {"num_heads": args.nheads, "mlp_layers": args.nlayers_mlp})
    model = MODELS[args.model](
        n, args.nhidden, n, num_layers=args.nlayers, dropout=args.dropout,
        generator=torch.Generator().manual_seed(seed), **extra).to(device)
    optimizer = make_adamw(model.parameters(), args.lr, args.wd)
    print(f"Params: {param_count(model)}")
    train_step, eval_step = make_harness(model, template, optimizer)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)

    def iterate(idx, shuffle_rng=None):
        order = (idx if shuffle_rng is None
                 else shuffle_rng.permutation(idx))
        for s in range(0, len(order), args.batch_size):
            sel = order[s: s + args.batch_size]
            f, lab, w = pad_batch(ds.feats[sel], ds.labels[sel],
                                  args.batch_size, n, n_pad)
            yield (torch.from_numpy(f).to(device),
                   torch.from_numpy(lab).to(device, torch.int64),
                   torch.from_numpy(w).to(device))

    def evaluate(idx):
        """(loss, accuracy) over the samples ``idx``: the batch losses
        weighted by their key counts, and the correct keys over all keys
        (integer counts, so a chance-level model reads exactly 1/n)."""
        parts = torch.stack([torch.stack(eval_step(*b))
                             for b in iterate(idx)]).double().cpu().numpy()
        loss, correct, w = parts[:, 0], parts[:, 1], parts[:, 2]
        return (float((loss * w).sum() / w.sum()),
                float(correct.sum() / w.sum()))

    driver = EpochDriver(epochs=args.epochs, factor=args.factor,
                         patience=args.patience, log_every=args.log_every)
    shuffle_rng = np.random.default_rng(seed + 12345)
    step_ms = []
    acc = test_acc = 0.0
    epoch = 0
    for epoch in range(1, args.epochs + 1):
        # the warmup and plateau scale apply to THIS epoch's steps
        set_lr_scale(optimizer, driver.lr_scale(epoch))
        for feats, labels, weights in iterate(train_idx, shuffle_rng):
            if not time_steps:
                train_step(feats, labels, weights, dropout_gen)
                continue
            synchronize(device)
            t0 = time.perf_counter()
            train_step(feats, labels, weights, dropout_gen)
            synchronize(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        loss, acc = evaluate(train_idx)
        test_loss, test_acc = evaluate(test_idx)
        driver.plateau_step(epoch, loss)

        if driver.should_log(epoch):
            print(f"Epoch {epoch:04d} | loss: {loss:.4f} | acc: {acc:.4f} | "
                  f"test_loss: {test_loss:.4f} | test_acc: {test_acc:.4f}")
        if loss < 1e-3 and test_loss < 1e-3:
            break

    if stats is not None:
        stats.update(epochs=epoch, seconds=time.perf_counter() - t_run)
        if time_steps:
            stats["step_ms"] = step_ms
    return acc, test_acc


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "SIR-GCN/GCN on DictionaryLookup (PyTorch + CUDA port)",
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
    p.add_argument("--nlayers-mlp", type=int, default=2)
    p.add_argument("--nodes", type=int, default=10)
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
    """Train ``--nruns`` runs; returns (train accuracies, test
    accuracies). With ``stats`` (a list) each run appends its
    :func:`run_single` stats (with ``step_ms`` if ``time_steps``)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.cpu)
    set_edge_dtype(torch.bfloat16 if args.edge_bf16 else None)

    train_accs, test_accs = [], []
    for i in range(args.nruns):
        run_stats = {}
        train_acc, test_acc = run_single(args, args.seed + i, device,
                                         run_stats, time_steps)
        if stats is not None:
            stats.append(run_stats)
        train_accs.append(train_acc)
        test_accs.append(test_acc)
        # per-run progress on stderr, so an interrupted protocol keeps its
        # finished seeds (stdout keeps the reference's shape)
        print(f"[run {i} seed {args.seed + i}] train acc {train_acc:.6f} "
              f"test acc {test_acc:.6f} ({run_stats['epochs']} epochs, "
              f"{run_stats['seconds']:.1f} s)", file=sys.stderr, flush=True)

    print(args)
    print(f"Runned {args.nruns} times")
    aggregate_runs("train accuracy", train_accs)
    aggregate_runs("test accuracy", test_accs)
    return train_accs, test_accs


if __name__ == "__main__":
    main()
