"""Shared training harness of the batched-graph workloads (port of
``experiments/batched_harness.py``): ZINC, SBM and super-pixel (molhiv
keeps its own loop for FLAG). The reference copies this loop into each
experiment (``benchmark-datasets/zinc/train.py:55-128`` and so on); here
it is one engine: train and eval steps over fixed-bucket batches, linear
warmup and plateau scheduling, best-by-validation selection.

Each training batch is collated on the host by a prefetch thread
(``data/prefetch.py``) while the card runs the previous step; the copies
to the card happen on the calling thread. Every batch is a plain
``GraphBatch`` and takes the CSR aggregate, as in the JAX package.

``--dp-devices N`` trains data-parallel over N ranks (one card each, or
gloo processes with ``--cpu``; ``parallel/multihost.py`` starts them): of
each N consecutive batches rank r takes the r-th, the gradients, the loss
and BatchNorm's running statistics are averaged over the ranks
(``parallel/data_parallel.py``), and the last fewer than N batches of an
epoch run as one step on every rank, as the JAX harness runs them
single-device. Every rank evaluates every split.
"""

from __future__ import annotations

import functools
import itertools
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..data.batching import GraphCollection
from ..data.prefetch import prefetch
from ..graph import add_self_loops
from ..parallel.collectives import rank_of, world_size
from ..parallel.data_parallel import make_dp_train_step_stateful, rank_batches
from ..train import (
    EpochDriver,
    l1_l2_regularizer,
    make_adamw,
    param_count,
    set_lr_scale,
    set_seed,
    synchronize,
)

ARRAYS = ("node_feats", "edge_feats", "labels", "graph_weights",
          "node_labels", "node_weights")


def to_device(batch: dict, device: torch.device,
              label_dtype: torch.dtype = torch.float32) -> dict:
    """A collated host batch with its graph and arrays on ``device``;
    labels in ``label_dtype``."""
    out = {"graph": batch["graph"].to(device)}
    for k in ARRAYS:
        if k in batch:
            out[k] = torch.from_numpy(batch[k]).to(device)
    for k in ("labels", "node_labels"):
        if k in out:
            out[k] = out[k].to(label_dtype)
    return out


def timed_batches(batches: Iterator[dict], device: torch.device,
                  label_dtype: torch.dtype,
                  wait_ms: Optional[list] = None) -> Iterator[dict]:
    """(host batch, its copy on ``device``) for each of ``batches``; with
    ``wait_ms`` (a list) it records, for each, the milliseconds the caller
    waited for it: the collation still to do (all of it without
    prefetch) and the copies to the card."""
    while True:
        t0 = time.perf_counter()
        b = next(batches, None)
        if b is None:
            return
        db = to_device(b, device, label_dtype)
        if wait_ms is not None:
            wait_ms.append((time.perf_counter() - t0) * 1e3)
        yield b, db


def run_batched_workload(
    *,
    model: torch.nn.Module,
    coll: GraphCollection,
    train_idx: np.ndarray,
    val_idx: Optional[np.ndarray],
    test_idx: np.ndarray,
    args,
    seed: int,
    loss_fn: Callable,     # (preds, labels, weights) -> scalar tensor
    metric_fn: Callable,   # (preds np, labels np) -> float, per split
    minimize_metric: bool,
    device: torch.device,
    warmup_size: int = 10,
    has_edge_feats: bool = False,
    label_dtype: torch.dtype = torch.float32,
    node_level: bool = False,
    stats: Optional[dict] = None,
    time_steps: bool = False,
) -> dict:
    """Train ``model`` on ``device`` and return the best-by-validation
    ``val_loss``, ``val_metric``, ``test_loss`` and ``test_metric``.

    With ``stats`` (a dict) it also records ``epochs``, ``seconds``,
    ``wait_ms`` (per training batch, prefetched: the wait for its
    collation and its copies) and ``collate_ms`` (per eval batch, not
    prefetched: its collation and copies); with ``time_steps``
    ``step_ms``, each train step timed between two device syncs."""
    dp = int(getattr(args, "dp_devices", 0) or 0)
    if dp > 1 and world_size() != dp:
        raise RuntimeError(f"--dp-devices {dp} needs a process group of {dp} "
                           f"ranks (parallel/multihost.py)")
    set_seed(seed)
    t_run = time.perf_counter()
    batch_size = args.batch_size
    model.to(device)
    opt = make_adamw(model.parameters(), args.lr, args.wd)
    print(f"Params: {param_count(model)}")
    l1 = getattr(args, "l1", 0.0)
    l2 = getattr(args, "l2", 0.0)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)
    step_ms, wait_ms, collate_ms = [], [], []

    def forward(batch, generator):
        a = [batch["graph"], batch["node_feats"]]
        if has_edge_feats:
            a.append(batch["edge_feats"])
        return model(*a, generator=generator)

    def loss_of(preds, batch):
        if node_level:
            return loss_fn(preds, batch["node_labels"],
                           batch["node_weights"])
        return loss_fn(preds, batch["labels"], batch["graph_weights"])

    def train_step(batch):
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = loss_of(forward(batch, dropout_gen), batch) \
            + l1_l2_regularizer(model, l1, l2)
        loss.backward()
        opt.step()
        return loss.detach()

    if dp > 1:
        # the rank's own batches draw dropout from a generator of its own;
        # a batch every rank runs, from the shared one
        rank_gen = torch.Generator(device=device).manual_seed(int(
            np.random.SeedSequence([seed, rank_of()]).generate_state(1)[0]))
        dp_step = make_dp_train_step_stateful(
            model, lambda m, b, gen: (loss_of(forward(b, gen), b)
                                      + l1_l2_regularizer(m, l1, l2)), opt)

    @torch.no_grad()
    def evaluate(idx):
        model.eval()
        losses, preds_all, labels_all = [], [], []
        for b, db in timed_batches(coll.loader(np.asarray(idx), batch_size),
                                   device, label_dtype, collate_ms):
            preds = forward(db, None)
            losses.append(float(loss_of(preds, db)))
            w, labels = ((b["node_weights"], b["node_labels"]) if node_level
                         else (b["graph_weights"], b["labels"]))
            w = w.astype(bool)
            preds_all.append(preds.cpu().numpy()[w])
            labels_all.append(labels[w])
        metric = metric_fn(np.concatenate(preds_all),
                           np.concatenate(labels_all))
        return float(np.mean(losses)), metric

    driver = EpochDriver(epochs=args.epochs, warmup=warmup_size,
                         factor=args.factor, patience=args.patience,
                         log_every=args.log_every)
    shuffle_rng = np.random.default_rng(seed + 12345)
    best = None
    better = (lambda a, b: a < b) if minimize_metric else \
        (lambda a, b: a > b)

    t_epochs = time.perf_counter()
    for epoch in range(1, args.epochs + 1):
        # the warmup and plateau scale apply to THIS epoch's steps
        set_lr_scale(opt, driver.lr_scale(epoch))
        if dp > 1:
            order = shuffle_rng.permutation(np.asarray(train_idx))
            plan = list(rank_batches(order, batch_size, rank_of(), dp))
            loader = prefetch(coll.collate(sel, batch_size)
                              for _, sel in plan)
            steps = [functools.partial(
                dp_step, generator=rank_gen if kind == "dp" else dropout_gen)
                for kind, _ in plan]
        else:
            loader = prefetch(coll.loader(np.asarray(train_idx), batch_size,
                                          shuffle_rng))
            steps = itertools.repeat(train_step)
        for step, (_, db) in zip(steps, timed_batches(loader, device,
                                                      label_dtype, wait_ms)):
            if not time_steps:
                step(db)
                continue
            synchronize(device)
            t0 = time.perf_counter()
            step(db)
            synchronize(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)

        loss, metric = evaluate(train_idx)
        if val_idx is not None:
            val_loss, val_metric = evaluate(val_idx)
        else:
            val_loss, val_metric = loss, metric
        test_loss, test_metric = evaluate(test_idx)
        driver.plateau_step(epoch, loss)

        if best is None or better(val_metric, best["val_metric"]):
            best = dict(val_loss=val_loss, val_metric=val_metric,
                        test_loss=test_loss, test_metric=test_metric)
        if driver.should_log(epoch):
            print(f"Epoch {epoch:04d} | loss: {loss:.4f} | "
                  f"metric: {metric:.4f} | val: {val_metric:.4f} | "
                  f"test: {test_metric:.4f}")

    # wall per epoch over all train batches and the three evaluations
    # (each reads its predictions back, a hard sync)
    dt = (time.perf_counter() - t_epochs) / max(args.epochs, 1)
    print(f"step_time_ms: {dt * 1e3:.1f} (train+eval wall per epoch, "
          f"{args.epochs} epochs)")
    if stats is not None:
        stats.update(epochs=args.epochs, seconds=time.perf_counter() - t_run,
                     wait_ms=wait_ms, collate_ms=collate_ms)
        if time_steps:
            stats["step_ms"] = step_ms
    return best


def apply_self_loops(graphs, edge_feats):
    """``dgl.transforms.AddSelfLoop`` on ``(src, dst, n)`` triples: drop
    the existing loops, append one loop per node; the new loop edges get
    zero edge features (DGL's frame padding)."""
    out_g, out_e = [], [] if edge_feats is not None else None
    for i, (s, d, n) in enumerate(graphs):
        s = np.asarray(s)
        d = np.asarray(d)
        keep = s != d
        s2, d2 = add_self_loops(s[keep], d[keep], n)
        out_g.append((s2.astype(np.int32), d2.astype(np.int32), n))
        if edge_feats is not None:
            ef = np.asarray(edge_feats[i])[keep]
            pad = np.zeros((n,) + ef.shape[1:], ef.dtype)
            out_e.append(np.concatenate([ef, pad]))
    return out_g, out_e
