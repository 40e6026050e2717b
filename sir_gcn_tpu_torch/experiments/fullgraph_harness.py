"""Shared full-graph node-classification harness (port of
``experiments/fullgraph_harness.py``; wiki-cs, heterophilous).

One training step over the whole padded graph an epoch, then an eval;
masked losses per split, a 10-epoch warmup and plateau scheduling,
best-by-val-loss selection: the ``run`` skeleton of
``benchmark-datasets/wiki-cs/train.py:60-115`` and
``benchmark-datasets/heterophilous-datasets/train.py:67-124``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..graph import build_graph
from ..models.layers import row_shard
from ..ops.ell import FastGraph
from ..parallel.collectives import all_gather_rows, rank_of, sum_gradients
from ..parallel.full_graph import NodeShard, shard_full_graph
from ..parallel.halo import build_halo_graph
from ..parallel.mesh import make_mesh
from ..train import (
    EpochDriver,
    l1_l2_regularizer,
    make_adamw,
    param_count,
    set_lr_scale,
    set_seed,
    synchronize,
)


def _denominator(w: torch.Tensor, weight_sum) -> torch.Tensor:
    return (w.sum() if weight_sum is None else weight_sum).clamp_min(1.0)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor,
              w: torch.Tensor, weight_sum=None) -> torch.Tensor:
    """Softmax cross-entropy weighted by ``w`` [N], over max(sum w, 1);
    ``weight_sum`` replaces sum w (the sum over every rank's rows, on one
    rank's shard)."""
    logp = torch.log_softmax(logits, -1)
    ce = -logp.gather(1, labels.long()[:, None])[:, 0]
    return (ce * w).sum() / _denominator(w, weight_sum)


def masked_bce_logits(logits: torch.Tensor, labels: torch.Tensor,
                      w: torch.Tensor, weight_sum=None) -> torch.Tensor:
    """Binary cross-entropy on logits (the first column of [N, 1], or
    [N]), in the stable form max(z, 0) - z y + log1p(exp(-|z|)), weighted
    by ``w`` over max(sum w, 1) (``weight_sum`` as in :func:`masked_ce`)."""
    z = logits[:, 0] if logits.ndim > 1 else logits
    ce = F.relu(z) - z * labels + torch.log1p(torch.exp(-z.abs()))
    return (ce * w).sum() / _denominator(w, weight_sum)


def pad_inputs(n_pad: int, feat: np.ndarray, labels: np.ndarray,
               masks: tuple, label_dtype) -> tuple:
    """The host arrays of a run on a graph padded to ``n_pad`` nodes:
    feats [n_pad, D] f32, labels [n_pad] in ``label_dtype``, and each bool
    split mask [n] as a float weight [n_pad]; zero past the n real
    nodes."""
    n = feat.shape[0]
    feats_p = np.zeros((n_pad, feat.shape[1]), np.float32)
    feats_p[:n] = feat
    labels_p = np.zeros(n_pad, label_dtype)
    labels_p[:n] = labels
    weights = []
    for m in masks:
        w = np.zeros(n_pad, np.float32)
        w[:n] = m.astype(np.float32)
        weights.append(w)
    return feats_p, labels_p, tuple(weights)


def setup_mesh_graph(graph, args, halo_model: bool = True):
    """``--mesh-devices N`` above 1 (this process one of the N ranks):
    partition the graph by node ranges over the ranks, after re-padding
    its nodes to a multiple of 128 N where N does not divide their padding
    (the edges keep theirs). The path is chosen as the JAX harness chooses
    it: the boundary-only halo aggregate for a SIR model (``halo_model``)
    with sum, mean or sym, else, or with ``--dist-path gspmd``, the
    row-sharded CSR (``parallel/full_graph.py``), printing the JAX
    harness's note where the halo path was asked for. Returns ``graph`` as
    it is for one device."""
    n = int(getattr(args, "mesh_devices", 0) or 0)
    if n <= 1:
        return graph
    if isinstance(graph, FastGraph):
        graph = graph.graph  # partition the plain graph
    if graph.n_pad % n:
        # padding edges sit at the tail of the dst-sorted arrays; they keep
        # their count, so a DropEdge mask is drawn at the same shape
        h, ne = graph.host, graph.num_edges
        graph = build_graph(h["src"][:ne], h["dst"][:ne], graph.num_nodes,
                            pad_multiple=128 * n, e_pad=graph.e_pad,
                            device=graph.device)
    group = make_mesh((n,), ("graph",), graph.device.type).get_group("graph")
    agg = getattr(args, "agg_type", "sum")
    dist_path = getattr(args, "dist_path", "halo")
    use_halo = (dist_path == "halo" and halo_model
                and agg in ("sum", "mean", "sym"))
    if dist_path == "halo" and not use_halo:
        print("[note] halo path needs a SIR model with a linear "
              "aggregator; using the row-sharded CSR (--dist-path gspmd) "
              "instead")
    if use_halo:
        return build_halo_graph(graph, n, group, agg)
    return shard_full_graph(graph, n, rank_of(group), group)


def grow_rows(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` with zero rows appended up to ``n`` (a node-indexed array of a
    graph re-padded for the mesh)."""
    return np.concatenate([a, np.zeros((n - a.shape[0],) + a.shape[1:],
                                       a.dtype)])


def rank_rows(graph):
    """A context for one rank's forward on its shard of a node-partitioned
    graph (a ``NodeShard``): random draws at the whole graph's shape, its
    rows (and on a ``ShardedGraph`` its edges) kept (``row_shard``); a
    null context on any other graph."""
    if not isinstance(graph, NodeShard):
        return contextlib.nullcontext()
    return row_shard(graph.rows.start, graph.rows.stop, graph.n_global,
                     graph.edge_run)


def gather_logits(graph, logits: torch.Tensor) -> torch.Tensor:
    """The whole graph's rows of ``logits`` on every rank: an all-gather of
    the ranks' rows on a ``NodeShard``, else ``logits``."""
    if not isinstance(graph, NodeShard):
        return logits
    return all_gather_rows(logits.contiguous(), graph.group)


def run_fullgraph_workload(
    *,
    model: torch.nn.Module,
    graph,
    feats: np.ndarray,          # [n_pad, D]
    labels: np.ndarray,         # [n_pad]
    masks: tuple,               # (train_w, val_w, test_w) float [n_pad]
    args,
    seed: int,
    device: torch.device,
    loss_fn: Callable = masked_ce,
    metric_fn: Optional[Callable] = None,  # (logits np, labels np) -> float
    warmup_size: int = 10,
    stats: Optional[dict] = None,
    time_steps: bool = False,
) -> dict:
    """Train ``model`` on ``graph`` (on ``device``) and return the
    best-by-val-loss epoch's ``loss``, ``metric``, ``val_loss``,
    ``val_metric``, ``test_loss`` and ``test_metric``.

    With ``--mesh-devices N`` each of the N ranks runs this on its own
    device: the graph is partitioned (:func:`setup_mesh_graph`), the model
    sees the rank's node rows, the train loss's weight sum spans every
    rank, the parameter gradients are summed over the ranks, and each eval
    gathers the logits of every rank, so every rank computes the same
    metrics.

    With ``stats`` (a dict) it also records ``epochs`` and ``seconds``
    (the run, from the upload of the inputs to the last eval); with
    ``time_steps`` ``step_ms`` and ``eval_ms``, each train step and each
    eval (its forward and the read-back of the logits) timed between two
    device syncs."""
    set_seed(seed)
    t_run = time.perf_counter()
    train_w, val_w, test_w = masks
    graph = setup_mesh_graph(graph, args,
                             halo_model=getattr(args, "model", "SIR")
                             == "SIR")
    sharded = isinstance(graph, NodeShard)
    n_pad = graph.n_global if sharded else graph.n_pad
    if n_pad > feats.shape[0]:  # re-padded for the mesh
        feats, labels = grow_rows(feats, n_pad), grow_rows(labels, n_pad)
        train_w, val_w, test_w = (grow_rows(w, n_pad)
                                  for w in (train_w, val_w, test_w))
    rows = graph.rows if sharded else slice(None)  # a rank's own rows

    feats_t = torch.from_numpy(np.asarray(feats, np.float32)).to(device)
    labels_t = torch.from_numpy(np.asarray(labels)).to(device)
    split_w = [torch.from_numpy(np.asarray(w, np.float32)).to(device)
               for w in (train_w, val_w, test_w)]
    train_sum = float(np.asarray(train_w, np.float32).sum())
    model.to(device)
    opt = make_adamw(model.parameters(), args.lr, args.wd)
    print(f"Params: {param_count(model)}")
    l1 = getattr(args, "l1", 0.0)
    l2 = getattr(args, "l2", 0.0)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)
    step_ms, eval_ms = [], []

    def train_step():
        model.train()
        opt.zero_grad(set_to_none=True)
        with rank_rows(graph):
            logits = model(graph, feats_t[rows], generator=dropout_gen)
        if sharded:
            loss = loss_fn(logits, labels_t[rows], split_w[0][rows],
                           weight_sum=torch.tensor(train_sum, device=device))
        else:
            loss = loss_fn(logits, labels_t, split_w[0])
        if not sharded or graph.rank == 0:  # the ranks' losses are summed
            loss = loss + l1_l2_regularizer(model, l1, l2)
        loss.backward()
        if sharded:
            sum_gradients(model, graph.group)
        opt.step()

    @torch.no_grad()
    def eval_step():
        model.eval()
        with rank_rows(graph):
            return gather_logits(graph, model(graph, feats_t[rows]))

    def timed(fn, record):
        if not time_steps:
            return fn()
        synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        synchronize(device)
        record.append((time.perf_counter() - t0) * 1e3)
        return out

    driver = EpochDriver(epochs=args.epochs, warmup=warmup_size,
                         factor=args.factor, patience=args.patience,
                         log_every=args.log_every)
    best = None
    labels_np = np.asarray(labels)
    t_epochs = time.perf_counter()
    for epoch in range(1, args.epochs + 1):
        # the warmup and plateau scale apply to THIS epoch's step
        set_lr_scale(opt, driver.lr_scale(epoch))
        timed(train_step, step_ms)

        logits = timed(eval_step, eval_ms)
        logits_np = logits.float().cpu().numpy()
        metrics = {}
        for name, w, tw in zip(("", "val_", "test_"),
                               (train_w, val_w, test_w), split_w):
            idx = np.asarray(w).astype(bool)
            with torch.no_grad():
                metrics[f"{name}loss"] = float(loss_fn(logits, labels_t, tw))
            metrics[f"{name}metric"] = metric_fn(logits_np[idx],
                                                 labels_np[idx])

        driver.plateau_step(epoch, metrics["loss"])
        if best is None or metrics["val_loss"] < best["val_loss"]:
            best = dict(metrics)
        if driver.should_log(epoch):
            print(f"Epoch {epoch:04d} | "
                  + " | ".join(f"{k}: {v:.4f}" for k, v in metrics.items()))
    # wall per epoch over the train step and the eval (whose read-back of
    # the logits is a hard sync)
    dt = (time.perf_counter() - t_epochs) / max(args.epochs, 1)
    print(f"step_time_ms: {dt * 1e3:.1f} (train+eval wall per epoch, "
          f"{args.epochs} epochs)")
    if stats is not None:
        stats.update(epochs=args.epochs,
                     seconds=time.perf_counter() - t_run)
        if time_steps:
            stats.update(step_ms=step_ms, eval_ms=eval_ms)
    return best
