"""Shared full-graph node-classification harness (port of
``experiments/fullgraph_harness.py``; wiki-cs, heterophilous).

One training step over the whole padded graph an epoch, then an eval;
masked losses per split, a 10-epoch warmup and plateau scheduling,
best-by-val-loss selection: the ``run`` skeleton of
``benchmark-datasets/wiki-cs/train.py:60-115`` and
``benchmark-datasets/heterophilous-datasets/train.py:67-124``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..train import (
    EpochDriver,
    l1_l2_regularizer,
    make_adamw,
    param_count,
    set_lr_scale,
    set_seed,
    synchronize,
)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy weighted by ``w`` [N], over max(sum w, 1)."""
    logp = torch.log_softmax(logits, -1)
    ce = -logp.gather(1, labels.long()[:, None])[:, 0]
    return (ce * w).sum() / w.sum().clamp_min(1.0)


def masked_bce_logits(logits: torch.Tensor, labels: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on logits (the first column of [N, 1], or
    [N]), in the stable form max(z, 0) - z y + log1p(exp(-|z|)), weighted
    by ``w`` over max(sum w, 1)."""
    z = logits[:, 0] if logits.ndim > 1 else logits
    ce = F.relu(z) - z * labels + torch.log1p(torch.exp(-z.abs()))
    return (ce * w).sum() / w.sum().clamp_min(1.0)


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


def setup_mesh_graph(graph, args):
    """``--mesh-devices`` above 1 partitions the graph over a mesh in the
    JAX harness; the port runs on one device until that path is ported
    and returns ``graph`` as JAX's single-device branch does."""
    if int(getattr(args, "mesh_devices", 0) or 0) > 1:
        raise NotImplementedError(
            "--mesh-devices > 1 (the edge-partitioned full graph) is not yet "
            "ported (ROADMAP.md Queue A item 11)")
    return graph


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

    With ``stats`` (a dict) it also records ``epochs`` and ``seconds``
    (the run, from the upload of the inputs to the last eval); with
    ``time_steps`` ``step_ms`` and ``eval_ms``, each train step and each
    eval (its forward and the read-back of the logits) timed between two
    device syncs."""
    set_seed(seed)
    t_run = time.perf_counter()
    train_w, val_w, test_w = masks
    graph = setup_mesh_graph(graph, args)

    feats_t = torch.from_numpy(np.asarray(feats, np.float32)).to(device)
    labels_t = torch.from_numpy(np.asarray(labels)).to(device)
    split_w = [torch.from_numpy(np.asarray(w, np.float32)).to(device)
               for w in (train_w, val_w, test_w)]
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
        logits = model(graph, feats_t, generator=dropout_gen)
        loss = (loss_fn(logits, labels_t, split_w[0])
                + l1_l2_regularizer(model, l1, l2))
        loss.backward()
        opt.step()

    @torch.no_grad()
    def eval_step():
        model.eval()
        return model(graph, feats_t)

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
