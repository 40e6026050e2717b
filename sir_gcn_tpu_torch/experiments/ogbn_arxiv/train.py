"""ogbn-arxiv full-graph training harness (port of
``experiments/ogbn_arxiv/train.py``; reference
``benchmark-datasets/ogbn-arxiv/train.py``): log-softened cross-entropy,
AdamW, a 20-epoch linear warmup and plateau LR scaling, best-by-val-loss
selection.

Runs on the CUDA card unless ``--cpu`` is given; with no card and no
``--cpu`` it raises. With no dataset cache a synthetic arxiv-shaped task
stands in. ``--model GAT`` trains the GATv2 baseline; jumping knowledge
and MLP residuals are the model's flags. The label trick, FLAG,
knowledge distillation, ``--l1``/``--l2``, ``--mask-rate``, checkpoints,
RCM reordering, ``--no-fast-path`` and the multi-device paths are not yet
ported: setting their flags away from the defaults raises.

    python -m sir_gcn_tpu_torch.experiments.ogbn_arxiv.train --nhidden 96 \\
        --nlayers 3 --agg-type sym --norm bn --residual --dropout 0.2 \\
        --feat-dropout 0.2 --add-reverse-edge --add-self-loop --edge-bf16
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Optional

import numpy as np
import torch

from ...data.loaders import load_node_classification
from ...graph import (
    add_self_loops,
    build_graph,
    remove_self_loops,
    reverse_edges,
    to_bidirected,
)
from ...ops.ell import FastGraph, build_fast_graph
from ...ops.message_passing import set_edge_dtype
from ...train import (
    ReduceLROnPlateau,
    make_adamw,
    param_count,
    resolve_device,
    set_lr_scale,
    set_seed,
    synchronize,
    warmup_scale,
)
from .model import GATModel, SIRModel

EPS = 1.0 - np.log(2.0)
WARMUP = 20


def build_arxiv_graph(data, args, device) -> FastGraph:
    """Graph transforms as the reference's load_dataset: bidirect or
    reverse, then an optional self-loop refresh; then the ELL plans."""
    src, dst = data.src, data.dst
    if args.add_reverse_edge:
        src, dst = to_bidirected(src, dst)
    else:
        src, dst = reverse_edges(src, dst)
    if args.add_self_loop:
        src, dst = remove_self_loops(src, dst)
        src, dst = add_self_loops(src, dst, data.feat.shape[0])
    graph = build_graph(src, dst, data.feat.shape[0], pad_multiple=128,
                        device=device)
    return build_fast_graph(graph)


def masked_mean(x, w):
    return (x * w).sum() / w.sum().clamp_min(1.0)


def soft_ce(logits, labels, w):
    """Log-softened CE: mean(log(CE + eps) - log(eps)) (train.py:71-75)."""
    logp = torch.log_softmax(logits, -1)
    ce = -logp.gather(1, labels[:, None])[:, 0]
    return masked_mean(torch.log(ce + EPS) - math.log(EPS), w)


def _np_soft_ce(logits, labels):
    z = logits - logits.max(-1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    ce = -logp[np.arange(len(labels)), labels]
    return float(np.mean(np.log(ce + EPS) - np.log(EPS)))


def build_model(args, input_dim: int, num_classes: int,
                generator: Optional[torch.Generator] = None):
    """The ``--model`` of ``args``: the SIRModel or the GATv2 baseline."""
    kwargs = dict(
        num_layers=args.nlayers, input_dropout=args.input_dropout,
        edge_dropout=args.edge_dropout, dropout=args.dropout,
        norm=args.norm, readout_layers=args.readout_layers,
        readout_dropout=args.readout_dropout,
        jumping_knowledge=args.jumping_knowledge, residual=args.residual,
        generator=generator)
    if args.model == "GAT":
        return GATModel(input_dim, args.nhidden, num_classes,
                        num_heads=args.nheads,
                        attn_dropout=args.attn_dropout, **kwargs)
    return SIRModel(input_dim, args.nhidden, num_classes,
                    resid_layers=args.resid_layers,
                    resid_dropout=args.resid_dropout,
                    feat_dropout=args.feat_dropout, agg_type=args.agg_type,
                    **kwargs)


def make_harness(model, graph, optimizer):
    """The train step (forward, soft CE, backward, AdamW) and the eval
    step (forward with the running BN statistics, no gradient)."""

    def train_step(feats, labels, loss_w, generator):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = soft_ce(model(graph, feats, generator=generator), labels,
                       loss_w)
        loss.backward()
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(feats):
        model.eval()
        return model(graph, feats)

    return train_step, eval_step


def run_single(args, seed: int, data, device: torch.device) -> dict:
    """One training run. Returns the best-by-val-loss metrics plus the
    run's record: per-epoch train losses, train-step and eval seconds
    (host clock, ending in a device sync), and the plan's shape."""
    set_seed(seed)
    t0 = time.perf_counter()
    graph = build_arxiv_graph(data, args, device)
    plan_seconds = time.perf_counter() - t0
    print(f"ELL plans: {plan_seconds:.2f}s; dst slots "
          f"{graph.dst_plan.num_slots}, src slots {graph.src_plan.num_slots}"
          f"; dst buckets {graph.dst_plan.buckets1}")
    n_pad = graph.n_pad
    num_classes = data.num_classes

    feats = np.zeros((n_pad, data.feat.shape[1]), np.float32)
    feats[: data.feat.shape[0]] = data.feat
    labels = np.zeros(n_pad, np.int64)
    labels[: data.labels.shape[0]] = data.labels

    def mask_of(idx):
        m = np.zeros(n_pad, np.float32)
        m[idx] = 1.0
        return m

    train_w, val_w, test_w = (mask_of(i) for i in
                              (data.train_idx, data.val_idx, data.test_idx))

    model = build_model(args, feats.shape[1], num_classes,
                        torch.Generator().manual_seed(seed)).to(device)
    optimizer = make_adamw(model.parameters(), args.lr, args.wd)
    print(f"Params: {param_count(model)}")
    train_step, eval_step = make_harness(model, graph, optimizer)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)

    feats_t = torch.from_numpy(feats).to(device)
    labels_t = torch.from_numpy(labels).to(device)
    loss_w = torch.from_numpy(train_w).to(device)
    plateau = ReduceLROnPlateau(factor=args.factor, patience=args.patience)
    best_val_loss = np.inf
    result = {}
    losses, step_seconds, eval_seconds = [], [], []
    for epoch in range(1, args.epochs + 1):
        # warmup and plateau scale apply to THIS epoch's step
        set_lr_scale(optimizer,
                     warmup_scale(epoch, WARMUP) * plateau.scale)
        t0 = time.perf_counter()
        loss = train_step(feats_t, labels_t, loss_w, dropout_gen)
        synchronize(device)
        step_seconds.append(time.perf_counter() - t0)
        losses.append(float(loss))

        t0 = time.perf_counter()
        logits_np = eval_step(feats_t).cpu().numpy()
        eval_seconds.append(time.perf_counter() - t0)
        metrics = {}
        for name, w in (("", train_w), ("val_", val_w), ("test_", test_w)):
            idx = w.astype(bool)
            metrics[f"{name}loss"] = _np_soft_ce(logits_np[idx], labels[idx])
            metrics[f"{name}acc"] = float(np.mean(
                np.argmax(logits_np[idx], -1) == labels[idx]))

        # plateau steps after the eval; inside the warmup the next
        # epoch's warmup rate overrides a reduction (reference behaviour)
        plateau.step(metrics["loss"])
        if epoch + 1 <= WARMUP:
            plateau.scale = 1.0

        if metrics["val_loss"] < best_val_loss:
            best_val_loss = metrics["val_loss"]
            result = dict(metrics)

        if epoch == args.epochs or epoch % args.log_every == 0:
            print(f"Epoch {epoch:04d} | loss: {metrics['loss']:.4f} | "
                  f"acc: {metrics['acc']:.4f} | "
                  f"val_loss: {metrics['val_loss']:.4f} | "
                  f"val_acc: {metrics['val_acc']:.4f} | "
                  f"test_loss: {metrics['test_loss']:.4f} | "
                  f"test_acc: {metrics['test_acc']:.4f}")

    result.update(
        train_losses=losses, step_seconds=step_seconds,
        eval_seconds=eval_seconds, plan_seconds=plan_seconds,
        dst_slots=graph.dst_plan.num_slots,
        src_slots=graph.src_plan.num_slots,
        dst_buckets=graph.dst_plan.buckets1,
        src_buckets=graph.src_plan.buckets1, num_edges=graph.graph.num_edges)
    return result


# Flags this port implements; any other flag set away from its default
# raises. The parser keeps the JAX harness's full flag set so that its
# commands parse unchanged.
PORTED = {
    "cpu", "seed", "model", "nhidden", "nlayers", "input_dropout",
    "edge_dropout", "dropout", "norm", "readout_layers", "readout_dropout",
    "jumping_knowledge", "residual", "resid_layers", "resid_dropout",
    "feat_dropout", "agg_type", "nheads", "attn_dropout", "add_self_loop",
    "add_reverse_edge", "edge_bf16", "epochs", "lr", "wd", "factor",
    "patience", "nruns", "log_every", "synthetic_nodes", "synthetic_edges",
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "SIR-GCN on ogbn-arxiv (PyTorch + CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU with the kernels' plain versions")
    p.add_argument("--edge-bf16", action="store_true",
                   help="carry the message-passing edge pipeline in "
                        "bfloat16 (f32 accumulation)")
    p.add_argument("--gpu", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model", type=str, default="SIR",
                   choices=["SIR", "GAT"])
    p.add_argument("--nhidden", type=int, default=256)
    p.add_argument("--nlayers", type=int, default=1)
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
    p.add_argument("--use-xrt-emb", action="store_true")
    p.add_argument("--use-labels", action="store_true")
    p.add_argument("--label-iters", type=int, default=0)
    p.add_argument("--mask-rate", type=float, default=1)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--wd", type=float, default=0)
    p.add_argument("--l1", type=float, default=0)
    p.add_argument("--l2", type=float, default=0)
    p.add_argument("--factor", type=float, default=0.5)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--kd-mode", type=str, default="teacher",
                   choices=["teacher", "student"])
    p.add_argument("--kd-alpha", type=float, default=0.5)
    p.add_argument("--kd-temp", type=float, default=1)
    p.add_argument("--flag", action="store_true")
    p.add_argument("--m", type=int, default=5)
    p.add_argument("--train-step-size", type=float, default=1e-5)
    p.add_argument("--untrain-step-size", type=float, default=1e-5)
    p.add_argument("--nruns", type=int, default=10)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--save-pred", action="store_true")
    p.add_argument("--ckpt-dir", type=str, default="")
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no-fast-path", action="store_true")
    p.add_argument("--mesh-devices", type=int, default=0)
    p.add_argument("--dist-path", type=str, default="halo",
                   choices=["halo", "gspmd"])
    p.add_argument("--reorder", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--synthetic-nodes", type=int, default=4096)
    p.add_argument("--synthetic-edges", type=int, default=32768)
    return p


def get_args(argv=None):
    p = _parser()
    args = p.parse_args(argv)
    unported = sorted(
        k for k, v in vars(args).items()
        if k not in PORTED and v != p.get_default(k))
    if unported:
        raise NotImplementedError(
            "flags not yet ported: "
            + ", ".join("--" + k.replace("_", "-") for k in unported))
    return args


def main(argv=None) -> list:
    """Parse the flags, train ``--nruns`` runs, and return each run's
    result (see :func:`run_single`)."""
    args = get_args(argv)
    device = resolve_device(args.cpu)
    set_edge_dtype(torch.bfloat16 if args.edge_bf16 else None)

    results = []
    for i in range(args.nruns):
        data = load_node_classification(
            "ogbn-arxiv",
            synthetic_fallback=dict(
                num_nodes=args.synthetic_nodes,
                num_edges=args.synthetic_edges,
                feat_dim=128, num_classes=40,
            ),
            seed=args.seed + i,
        )
        if data.synthetic:
            print("[warn] no ogbn-arxiv cache; using synthetic stand-in "
                  "(not a parity number)")
        results.append(run_single(args, args.seed + i, data, device))

    print(f"Runned {args.nruns} times")
    for name in ("val_acc", "test_acc"):
        vals = [r[name] for r in results]
        print(f"Average {name}: {np.mean(vals):.6f} ± {np.std(vals):.6f}")
    return results


if __name__ == "__main__":
    main()
