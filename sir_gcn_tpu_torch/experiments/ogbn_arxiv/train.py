"""ogbn-arxiv full-graph training harness (port of
``experiments/ogbn_arxiv/train.py``; reference
``benchmark-datasets/ogbn-arxiv/train.py``): log-softened cross-entropy,
the label trick with label reuse, mask-rate subsampling, FLAG adversarial
perturbation, knowledge distillation, ``--l1``/``--l2``, AdamW under the
engine's ``EpochDriver`` (a 20-epoch linear warmup and plateau LR
scaling), best-by-val-loss selection, prediction saving for KD and
Correct & Smooth, checkpoints, RCM reordering and ``--no-fast-path``.

Runs on the CUDA card unless ``--cpu`` is given; with no card and no
``--cpu`` it raises. With no dataset cache a synthetic arxiv-shaped task
stands in. ``--model GAT`` trains the GATv2 baseline. ``--mesh-devices
N`` partitions the graph by node ranges over N ranks (N cards, or N gloo
processes with ``--cpu``), spawned here unless a launcher (torchrun)
started them: the halo aggregate for a SIR model with sum, mean or sym,
else, or with ``--dist-path gspmd``, the row-sharded CSR; every other
flag carries over. ``--remat`` raises.

The reference's best configuration is a teacher, a student and C&S:

    python -m sir_gcn_tpu_torch.experiments.ogbn_arxiv.train --nhidden 96 \\
        --nlayers 3 --agg-type sym --norm bn --residual --dropout 0.2 \\
        --feat-dropout 0.2 --add-reverse-edge --add-self-loop --edge-bf16 \\
        --use-labels --label-iters 1 --mask-rate 0.5 --flag --m 3 \\
        --save-pred
    python -m sir_gcn_tpu_torch.experiments.ogbn_arxiv.train ... \\
        --kd-mode student --save-pred
    python -m sir_gcn_tpu_torch.experiments.ogbn_arxiv.correct_and_smooth \\
        --use-sym --add-reverse-edge --add-self-loop
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...data.loaders import load_node_classification
from ...graph import (
    GraphBatch,
    add_self_loops,
    build_graph,
    permute_nodes,
    rcm_order,
    remove_self_loops,
    reverse_edges,
    to_bidirected,
)
from ...models.layers import rand_rows
from ...ops.ell import FastGraph, build_fast_graph
from ...ops.message_passing import set_edge_dtype
from ...parallel.collectives import all_reduce_sum, sum_gradients
from ...parallel.full_graph import NodeShard, ShardedGraph
from ...parallel.halo import HaloGraph
from ...parallel.multihost import needs_spawn, spawn_ranks, trainer_device
from ...train import (
    EpochDriver,
    l1_l2_regularizer,
    make_adamw,
    param_count,
    resolve_device,
    set_lr_scale,
    set_seed,
    synchronize,
)
from ...utils.checkpoint import latest_step, load_checkpoint, save_checkpoint
from ..fullgraph_harness import (
    gather_logits,
    rank_rows,
    setup_mesh_graph,
)
from .model import GATModel, SIRModel

EPS = 1.0 - np.log(2.0)
WARMUP = 20
METRIC_KEYS = ("loss", "acc", "val_loss", "val_acc", "test_loss",
               "test_acc")
XRT_EMB = "dataset/ogbn_arxiv_xrt/X.all.xrt-emb.npy"


def build_arxiv_graph(data, args, device) -> FastGraph | GraphBatch:
    """Graph transforms as the reference's load_dataset: bidirect or
    reverse, then an optional self-loop refresh; then the ELL plans, unless
    ``args.no_fast_path`` asks for the plain ``GraphBatch`` (the CSR
    aggregate, no kernel). With ``--mesh-devices N`` the nodes are padded
    to a multiple of 128 N (the edges to one of 128, as on one device) and
    the plain graph is returned, for the mesh's partition."""
    src, dst = data.src, data.dst
    if args.add_reverse_edge:
        src, dst = to_bidirected(src, dst)
    else:
        src, dst = reverse_edges(src, dst)
    if args.add_self_loop:
        src, dst = remove_self_loops(src, dst)
        src, dst = add_self_loops(src, dst, data.feat.shape[0])
    n_mesh = getattr(args, "mesh_devices", 0)
    pad = 128 * n_mesh if n_mesh > 1 else 128
    # the edges keep the single-device padding, so that a DropEdge mask
    # is drawn at the same shape on every mesh
    e_pad = max(-(-len(src) // 128) * 128, 128)
    graph = build_graph(src, dst, data.feat.shape[0], pad_multiple=pad,
                        e_pad=e_pad, device=device)
    if n_mesh > 1 or getattr(args, "no_fast_path", False):
        return graph  # the mesh partitions the plain graph
    return build_fast_graph(graph)


def masked_mean(x, w, weight_sum=None):
    """sum(x w) / max(sum w, 1); ``weight_sum`` replaces sum w (every
    rank's, on one rank's rows)."""
    return (x * w).sum() / (w.sum() if weight_sum is None
                            else weight_sum).clamp_min(1.0)


def soft_ce(logits, labels, w, weight_sum=None):
    """Log-softened CE: mean(log(CE + eps) - log(eps)) (train.py:71-75)."""
    logp = torch.log_softmax(logits, -1)
    ce = -logp.gather(1, labels[:, None])[:, 0]
    return masked_mean(torch.log(ce + EPS) - math.log(EPS), w, weight_sum)


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


def initial_perturbation(shape, train_mask: torch.Tensor, args,
                         generator: Optional[torch.Generator]
                         ) -> torch.Tensor:
    """FLAG's first perturbation (train.py:177-184): uniform in
    ±untrain_step_size, scaled on the train nodes by train / untrain."""
    u = args.untrain_step_size
    p = rand_rows(shape, generator, train_mask.device)
    scale = torch.where(train_mask[:, None], args.train_step_size / u, 1.0)
    return (p * (2.0 * u) - u) * scale


def make_harness(model, graph, optimizer, args, num_classes: int):
    """The train step and the eval step of ``args``' tricks, closed over
    the graph (``experiments/ogbn_arxiv/train.py`` ``make_harness``).

    ``train_step(feats, labels, loss_w, generator, labeled=, unlabeled=,
    train_mask=, kd_teacher=, perturb=)`` returns the loss and, with
    ``--flag``, the last perturbation (else None). FLAG runs m + 1 loss
    evaluations (m = ``--m``), each loss divided by m + 1, sums the
    parameter gradients over them and steps AdamW once; after each, the
    perturbation moves by its step times the sign of its gradient (the
    train nodes' step on the train nodes). It starts from ``perturb``, or
    from :func:`initial_perturbation` drawn from ``generator``.
    ``eval_step(feats, labels, labeled, unlabeled)`` returns the eval
    logits with label reuse.

    On a ``NodeShard`` (one rank of a ``--mesh-devices`` run) every
    node-indexed input is the rank's rows: random draws are made at the
    whole graph's shape (``row_shard``), the loss's weight sum and KD's
    mean span every rank, the regulariser is added on rank 0 only, the
    parameter gradients are summed over the ranks before AdamW steps, and
    ``eval_step`` gathers every rank's logits."""
    m = args.m + 1 if args.flag else 1
    reuse = args.label_iters if args.use_labels else 0
    sharded = isinstance(graph, NodeShard)

    def assemble(feats, labels, labeled):
        """The label trick: the labeled rows' one-hot labels as extra
        input columns (zeros elsewhere)."""
        if not args.use_labels:
            return feats
        one_hot = F.one_hot(labels, num_classes).to(feats.dtype)
        return torch.cat([feats, one_hot * labeled[:, None]], -1)

    def predict(feats, perturb, unlabeled, generator, grad: bool):
        """The logits of ``feats``, then label reuse: each of ``reuse``
        more forwards sees the last logits' softmax in the unlabeled rows'
        label columns. The loss sees only the last forward, so the others
        run without a gradient (where JAX's traced forward stops the
        gradient instead). In training each forward draws the same
        dropout and DropEdge masks, as JAX hands each the same key, and
        updates BatchNorm's running statistics."""
        state = (generator.get_state()
                 if reuse and generator is not None else None)
        for i in range(reuse + 1):
            if i and state is not None:
                generator.set_state(state)
            with torch.set_grad_enabled(grad and i == reuse):
                logits = model(graph, feats, perturb, generator=generator)
            if i < reuse:
                lab = torch.where(unlabeled[:, None] > 0,
                                  torch.softmax(logits, -1),
                                  feats[:, -num_classes:])
                feats = torch.cat([feats[:, :-num_classes], lab], -1)
        return logits

    def loss_fn(feats, labels, loss_w, labeled, unlabeled, kd_teacher,
                perturb, generator):
        f = assemble(feats, labels, labeled)
        if args.use_labels and torch.is_tensor(perturb):
            # FLAG perturbs the raw features only; the label columns get
            # zeros (train.py:122)
            perturb = torch.cat(
                [perturb, perturb.new_zeros(f.shape[0], num_classes)], -1)
        logits = predict(f, perturb, unlabeled, generator, grad=True)
        wsum = (all_reduce_sum(loss_w.sum(), graph.group) if sharded
                else None)
        loss = soft_ce(logits, labels, loss_w, wsum)
        if not sharded or graph.rank == 0:  # the ranks' losses are summed
            loss = loss + l1_l2_regularizer(model, args.l1, args.l2)
        loss = loss / m
        if args.kd_mode == "student":
            t = args.kd_temp
            logp = torch.log_softmax(logits / t, -1)
            p_teacher = torch.softmax(kd_teacher / t, -1)
            kd = (t * t) * (p_teacher * (
                torch.log(p_teacher.clamp_min(1e-12)) - logp)).sum(-1)
            kd = kd.sum() / graph.n_global if sharded else kd.mean()
            loss = loss * (1 - args.kd_alpha) + kd / m * args.kd_alpha
        return loss

    def step(total):
        if sharded:
            sum_gradients(model, graph.group)
            total = all_reduce_sum(total, graph.group)
        optimizer.step()
        return total

    def train_step(feats, labels, loss_w, generator, labeled=None,
                   unlabeled=None, train_mask=None, kd_teacher=None,
                   perturb=None):
        with rank_rows(graph):
            return _train_step(feats, labels, loss_w, generator, labeled,
                               unlabeled, train_mask, kd_teacher, perturb)

    def _train_step(feats, labels, loss_w, generator, labeled, unlabeled,
                    train_mask, kd_teacher, perturb):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        inputs = (feats, labels, loss_w, labeled, unlabeled, kd_teacher)
        if not args.flag:
            loss = loss_fn(*inputs, 0.0, generator)
            loss.backward()
            return step(loss.detach()), None
        if perturb is None:
            perturb = initial_perturbation(feats.shape, train_mask, args,
                                           generator)
        size = torch.where(train_mask[:, None], args.train_step_size,
                           args.untrain_step_size)
        total = 0.0
        for _ in range(m):
            perturb = perturb.detach().requires_grad_()
            loss = loss_fn(*inputs, perturb, generator)
            loss.backward()
            total = total + loss.detach()
            perturb = perturb + size * torch.sign(perturb.grad)
        return step(total), perturb.detach()

    @torch.no_grad()
    def eval_step(feats, labels, labeled, unlabeled):
        model.eval()
        with rank_rows(graph):
            logits = predict(assemble(feats, labels, labeled), 0.0,
                             unlabeled, None, grad=False)
        return gather_logits(graph, logits)

    return train_step, eval_step


def reorder_data(data):
    """RCM-relabel the nodes for src-gather locality (``rcm_order``).
    Training is equivariant to the relabelling; saved predictions are
    mapped back to the original order. Returns (perm, relabel)."""
    perm = rcm_order(data.src, data.dst, data.feat.shape[0])
    data.src, data.dst, relabel = permute_nodes(data.src, data.dst, perm)
    data.feat = data.feat[perm]
    data.labels = data.labels[perm]
    data.train_idx = relabel[data.train_idx]
    data.val_idx = relabel[data.val_idx]
    data.test_idx = relabel[data.test_idx]
    return perm, relabel


def graph_valid(n_pad, data):
    v = np.zeros(n_pad, np.float32)
    v[: data.feat.shape[0]] = 1.0
    return v


def _ckpt_payload(model, optimizer, driver, best_val_loss, result, n_pad,
                  num_classes, generator) -> dict:
    """Everything an exact resume needs: the model (BatchNorm's running
    statistics too) and AdamW, the plateau scheduler, the best-so-far
    selection (metrics and logits) and the dropout generator's state (JAX
    fast-forwards its key stream instead)."""
    pl = driver.plateau
    logits = result.get("logits")
    if logits is None:
        logits = np.zeros((n_pad, num_classes), np.float32)
    return {
        "model": model.state_dict(), "optimizer": optimizer.state_dict(),
        "plateau": torch.tensor([pl.best, pl.num_bad, pl.scale],
                                dtype=torch.float64),
        "best_val_loss": float(best_val_loss),
        "best_metrics": torch.tensor([result.get(k, 0.0)
                                      for k in METRIC_KEYS],
                                     dtype=torch.float64),
        "best_logits": torch.from_numpy(np.asarray(logits, np.float32)),
        "generator": generator.get_state()}


def run_single(args, seed: int, data, device: torch.device,
               iter_idx: int = 0) -> dict:
    """One training run. Returns the best-by-val-loss metrics and logits
    plus the run's record: per-epoch train losses, train-step and eval
    seconds (host clock, ending in a device sync), and the plan's
    shape."""
    set_seed(seed)
    perm = relabel = None
    if args.reorder:
        perm, relabel = reorder_data(data)
    t0 = time.perf_counter()
    whole = build_arxiv_graph(data, args, device)
    graph = setup_mesh_graph(whole, args, halo_model=args.model == "SIR")
    plan_seconds = time.perf_counter() - t0
    fast = isinstance(graph, FastGraph)
    if fast:
        print(f"ELL plans: {plan_seconds:.2f}s; dst slots "
              f"{graph.dst_plan.num_slots}, src slots "
              f"{graph.src_plan.num_slots}; dst buckets "
              f"{graph.dst_plan.buckets1}")
    sharded = isinstance(graph, NodeShard)
    if isinstance(graph, HaloGraph):
        print(f"halo plans: {plan_seconds:.2f}s; {graph.hfg.n_shards} "
              f"shards of {graph.hfg.n_local} nodes, h_max "
              f"{graph.hfg.h_max}")
    elif isinstance(graph, ShardedGraph):
        print(f"row-sharded CSR: {graph.n_shards} shards of {graph.n_pad} "
              f"nodes; rank {graph.rank} owns {graph.e_pad} edges")
    # a rank of a --mesh-devices run holds its own node rows
    n_pad = graph.n_global if sharded else graph.n_pad
    rows = graph.rows if sharded else slice(None)
    lead = not sharded or graph.rank == 0  # writes the files
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

    input_dim = feats.shape[1] + (num_classes if args.use_labels else 0)
    model = build_model(args, input_dim, num_classes,
                        torch.Generator().manual_seed(seed)).to(device)
    optimizer = make_adamw(model.parameters(), args.lr, args.wd)
    print(f"Params: {param_count(model)}")
    train_step, eval_step = make_harness(model, graph, optimizer, args,
                                         num_classes)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)

    def dev(x):
        return torch.from_numpy(x[rows]).to(device)

    feats_t, labels_t = dev(feats), dev(labels)
    train_mask = dev(train_w.astype(bool))
    kd_teacher = dev(np.zeros((n_pad, num_classes), np.float32))
    if args.kd_mode == "student":
        teacher = np.load(f"./output/teacher_{iter_idx}.npy")
        if perm is not None:  # the teacher is in the original node order
            teacher = np.concatenate([teacher[perm], teacher[len(perm):]], 0)
        if teacher.shape[0] < n_pad:  # saved at another padding
            teacher = np.concatenate([teacher, np.zeros(
                (n_pad - teacher.shape[0], num_classes), teacher.dtype)])
        kd_teacher = dev(teacher.astype(np.float32))
    eval_labeled = dev(train_w)
    eval_unlabeled = dev(np.clip(val_w + test_w, 0, 1)
                         * graph_valid(n_pad, data))

    driver = EpochDriver(epochs=args.epochs, warmup=WARMUP,
                         factor=args.factor, patience=args.patience,
                         log_every=args.log_every)
    host_rng = np.random.default_rng(seed + 999)
    result = {}
    best_val_loss = np.inf

    ckpt_dir = (os.path.join(args.ckpt_dir, f"run_{iter_idx}")
                if args.ckpt_dir else None)
    start_epoch = 1
    if ckpt_dir and args.resume:
        step = latest_step(ckpt_dir)
        if step is not None:
            r = load_checkpoint(ckpt_dir, step)
            model.load_state_dict(r["model"])
            optimizer.load_state_dict(r["optimizer"])
            pb, pn, ps = r["plateau"].tolist()
            driver.plateau.best, driver.plateau.num_bad = pb, int(pn)
            driver.plateau.scale = ps
            best_val_loss = r["best_val_loss"]
            if np.isfinite(best_val_loss):
                result = dict(zip(METRIC_KEYS, r["best_metrics"].tolist()))
                result["logits"] = r["best_logits"].numpy()
            dropout_gen.set_state(r["generator"])
            start_epoch = step + 1
            # the mask-rate draws of the epochs done, as JAX fast-forwards
            for _ in range(step):
                host_rng.random(len(data.train_idx))
            print(f"Resumed from {ckpt_dir} at epoch {step}")

    losses, step_seconds, eval_seconds = [], [], []
    t_epochs = time.perf_counter()
    for epoch in range(start_epoch, args.epochs + 1):
        # mask-rate subsampling (train.py:107-108); drawn at every rate
        sub = host_rng.random(len(data.train_idx)) < args.mask_rate
        loss_w = mask_of(data.train_idx[sub])
        labeled = mask_of(data.train_idx[~sub])  # the label trick's rows
        unlabeled = np.clip(train_w - labeled + val_w + test_w, 0, 1)

        # warmup and plateau scale apply to THIS epoch's step
        set_lr_scale(optimizer, driver.lr_scale(epoch))
        t0 = time.perf_counter()
        loss, _ = train_step(feats_t, labels_t, dev(loss_w), dropout_gen,
                             labeled=dev(labeled), unlabeled=dev(unlabeled),
                             train_mask=train_mask, kd_teacher=kd_teacher)
        synchronize(device)
        step_seconds.append(time.perf_counter() - t0)
        losses.append(float(loss))

        t0 = time.perf_counter()
        logits_np = eval_step(feats_t, labels_t, eval_labeled,
                              eval_unlabeled).cpu().numpy()
        eval_seconds.append(time.perf_counter() - t0)
        metrics = {}
        for name, w in (("", train_w), ("val_", val_w), ("test_", test_w)):
            idx = w.astype(bool)
            metrics[f"{name}loss"] = _np_soft_ce(logits_np[idx], labels[idx])
            metrics[f"{name}acc"] = float(np.mean(
                np.argmax(logits_np[idx], -1) == labels[idx]))

        driver.plateau_step(epoch, metrics["loss"])

        if metrics["val_loss"] < best_val_loss:
            best_val_loss = metrics["val_loss"]
            result = dict(metrics, logits=logits_np)

        if (lead and ckpt_dir and args.ckpt_every
                and epoch % args.ckpt_every == 0):
            save_checkpoint(ckpt_dir, _ckpt_payload(
                model, optimizer, driver, best_val_loss, result, n_pad,
                num_classes, dropout_gen), step=epoch)

        if driver.should_log(epoch):
            print(f"Epoch {epoch:04d} | loss: {metrics['loss']:.4f} | "
                  f"acc: {metrics['acc']:.4f} | "
                  f"val_loss: {metrics['val_loss']:.4f} | "
                  f"val_acc: {metrics['val_acc']:.4f} | "
                  f"test_loss: {metrics['test_loss']:.4f} | "
                  f"test_acc: {metrics['test_acc']:.4f}")

    # wall per epoch over the train step and the eval (whose read-back of
    # the logits is a hard sync)
    n_ep = args.epochs + 1 - start_epoch
    if n_ep > 0:
        dt = (time.perf_counter() - t_epochs) / n_ep
        print(f"step_time_ms: {dt * 1e3:.1f} (train+eval wall per epoch, "
              f"{n_ep} epochs)")

    if args.save_pred and lead:
        os.makedirs("./output", exist_ok=True)
        probs = torch.softmax(torch.from_numpy(result["logits"]), -1).numpy()
        if relabel is not None:  # saved in the original node order
            probs = np.concatenate([probs[relabel], probs[len(relabel):]], 0)
        np.save(f"./output/{args.kd_mode}_{iter_idx}.npy", probs)

    result.update(
        train_losses=losses, step_seconds=step_seconds,
        eval_seconds=eval_seconds, plan_seconds=plan_seconds,
        num_edges=(whole if isinstance(whole, GraphBatch)
                   else whole.graph).num_edges)
    if fast:
        result.update(
            dst_slots=graph.dst_plan.num_slots,
            src_slots=graph.src_plan.num_slots,
            dst_buckets=graph.dst_plan.buckets1,
            src_buckets=graph.src_plan.buckets1)
    return result


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
    p.add_argument("--gpu", type=int, default=0,
                   help="ignored (the card is cuda:0); accepted so "
                        "reference commands run unchanged")
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
    p.add_argument("--use-xrt-emb", action="store_true",
                   help=f"read the GIANT-XRT features from {XRT_EMB}")
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
    p.add_argument("--ckpt-dir", type=str, default="",
                   help="checkpoint directory (per-run subdirs); empty = "
                        "no checkpointing")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="save a checkpoint every N epochs (0 = never)")
    p.add_argument("--resume", action="store_true",
                   help="resume each run from its latest checkpoint")
    p.add_argument("--no-fast-path", action="store_true",
                   help="the plain GraphBatch on the CSR aggregate, no "
                        "kernel (debugging)")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="ranks to partition the graph over, one card each "
                        "(gloo CPU processes with --cpu); 0/1 = one device")
    p.add_argument("--dist-path", type=str, default="halo",
                   choices=["halo", "gspmd"])
    p.add_argument("--reorder", action="store_true",
                   help="RCM-relabel nodes for src-gather locality")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--synthetic-nodes", type=int, default=4096)
    p.add_argument("--synthetic-edges", type=int, default=32768)
    return p


def get_args(argv=None):
    """The parsed flags. ``--remat`` raises: the port keeps every
    activation for the backward (ROADMAP.md Queue A item 10)."""
    args = _parser().parse_args(argv)
    if args.remat:
        raise NotImplementedError("flags not yet ported: --remat "
                                  "(ROADMAP.md Queue A item 10)")
    return args


def main(argv=None) -> list:
    """Parse the flags, train ``--nruns`` runs, and return each run's
    result (see :func:`run_single`). With ``--mesh-devices N`` outside a
    launcher it spawns N ranks (``--cpu``: gloo processes) and returns
    rank 0's results."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = get_args(argv)
    if needs_spawn(args.mesh_devices, args.cpu):
        return spawn_ranks(args.mesh_devices, main, argv, cpu=args.cpu)
    device = trainer_device(args.cpu, args.mesh_devices)
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
        if args.use_xrt_emb:
            # GIANT-XRT embeddings replace the raw features
            # (reference train.py:48-50)
            data.feat = np.load(XRT_EMB).astype(np.float32)
        results.append(run_single(args, args.seed + i, data, device, i))

    print(f"Runned {args.nruns} times")
    for name in ("val_acc", "test_acc"):
        vals = [r[name] for r in results]
        print(f"Average {name}: {np.mean(vals):.6f} ± {np.std(vals):.6f}")
    return results


if __name__ == "__main__":
    main()
