"""ogbg-molhiv harness (port of ``experiments/ogbg_molhiv/train.py``;
reference ``benchmark-datasets/ogbg-molhiv/train.py``): BCE on the
sigmoid (train.py:57-58), the FLAG adversarial perturbation of the atom
embedding (train.py:78-96), ROC-AUC, best-by-validation-AUC selection.
The training batches are collated by a prefetch thread. The flags are the
reference's.

Runs on the CUDA card unless ``--cpu`` is given; with no card and no
``--cpu`` it raises.

    python -m sir_gcn_tpu_torch.experiments.ogbg_molhiv.train \\
        --virtual-node --flag --nruns 1
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ...data import (
    GraphCollection,
    has_cache,
    load_graph_cache,
    prefetch,
    synthetic_ogb_molecules,
)
from ...ops.message_passing import set_edge_dtype
from ...train import (
    EpochDriver,
    aggregate_runs,
    l1_l2_regularizer,
    make_adamw,
    param_count,
    resolve_device,
    set_lr_scale,
    set_seed,
    synchronize,
)
from ...train.metrics import roc_auc
from ..batched_harness import (
    apply_self_loops,
    timed_batches,
)
from .model import MODELS


def load_molhiv(args, seed):
    """(graphs, node feats, edge feats, labels, (train, val, test),
    synthetic)."""
    if has_cache("ogbg-molhiv"):
        z, graphs, nodes, edges = load_graph_cache("ogbg-molhiv")
        return (graphs, nodes("node_feat"), edges("edge_feat"),
                z["labels"].astype(np.float32).ravel(),
                (z["train_idx"], z["val_idx"], z["test_idx"]), False)
    graphs, nfeats, efeats, labels = synthetic_ogb_molecules(
        num_graphs=args.synthetic_samples, seed=seed)
    n = len(graphs)
    idx = np.arange(n)
    return (graphs, nfeats, efeats, labels,
            (idx[:int(0.8 * n)], idx[int(0.8 * n):int(0.9 * n)],
             idx[int(0.9 * n):]), True)


def dataset_max_degree(graphs) -> int:
    """The largest in-degree over the dataset (reference train.py:228:
    ``max_degree = dataset.max_degree``)."""
    return max((int(np.bincount(np.asarray(d, np.int64), minlength=1).max())
                if len(d) else 0) for _, d, _ in graphs)


def build_model(args, max_degree: int,
                generator: Optional[torch.Generator] = None):
    common = dict(
        hidden_dim=args.nhidden, output_dim=1, num_layers=args.nlayers,
        input_dropout=args.input_dropout, dropout=args.dropout,
        norm=args.norm, readout_pooling=args.readout_pooling,
        virtual_node=args.virtual_node, vn_layers=args.vn_layers,
        vn_dropout=args.vn_dropout, vn_residual=args.vn_residual,
        generator=generator)
    if args.model == "SIR":
        return MODELS["SIR"](
            rand_feat=args.rand_feat, max_degree=max_degree,
            residual=args.residual, feat_dropout=args.feat_dropout,
            agg_type=args.agg_type, use_edge_feats=args.use_edge_feats,
            edge_dropout=args.edge_dropout,
            readout_layers=args.readout_layers,
            readout_dropout=args.readout_dropout,
            jumping_knowledge=args.jumping_knowledge,
            resid_layers=args.resid_layers,
            resid_dropout=args.resid_dropout, **common)
    return MODELS["GIN"](mlp_layers=args.nlayers_mlp, **common)


def bce(preds, labels, weights):
    """BCE of the sigmoid with eps 1e-7 inside the logs (train.py:57-58),
    averaged over the weighted graphs."""
    p = torch.sigmoid(preds[:, 0])
    eps = 1e-7
    ce = -(labels * torch.log(p + eps) + (1 - labels) * torch.log(1 - p + eps))
    return (ce * weights).sum() / weights.sum().clamp_min(1.0)


def make_train_step(model, optimizer, args):
    """The train step of one batch on the card. With ``--flag``: m + 1
    forward and backward passes (m = ``--m``), each loss divided by m + 1,
    the parameter gradients summed over the passes, and after each pass
    perturb += step_size * sign(d loss / d perturb); the perturbation
    starts U(-step_size, step_size) of shape [N_pad, hidden], drawn from
    ``generator`` unless ``perturb`` is given. Each pass updates the
    BatchNorm running statistics, as JAX threads ``batch_stats`` through
    the passes. Returns the summed loss."""
    m = args.m + 1 if args.flag else 1

    def scaled_loss(batch, perturb, generator):
        preds = model(batch["graph"], batch["node_feats"],
                      batch["edge_feats"], perturb, generator=generator)
        return (bce(preds, batch["labels"], batch["graph_weights"])
                + l1_l2_regularizer(model, args.l1, args.l2)) / m

    def train_step(batch, generator, perturb=None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if not args.flag:
            loss = scaled_loss(batch, 0.0, generator)
            loss.backward()
            optimizer.step()
            return loss.detach()
        if perturb is None:
            u = torch.rand(batch["node_feats"].shape[0], args.nhidden,
                           generator=generator,
                           device=batch["node_feats"].device)
            perturb = (2.0 * u - 1.0) * args.step_size
        total = 0.0
        for _ in range(m):
            perturb = perturb.detach().requires_grad_()
            loss = scaled_loss(batch, perturb, generator)
            loss.backward()
            total = total + loss.detach()
            perturb = perturb + args.step_size * torch.sign(perturb.grad)
        optimizer.step()
        return total

    return train_step


def run_single(args, seed: int, device: torch.device,
               stats: Optional[dict] = None, time_steps: bool = False):
    """One run; returns the best-by-validation ``val_metric`` and
    ``test_metric`` (ROC-AUC). ``stats`` and ``time_steps`` as in
    ``batched_harness.run_batched_workload``."""
    set_seed(seed)
    t_run = time.perf_counter()
    graphs, nfeats, efeats, labels, (tr, va, te), synthetic = \
        load_molhiv(args, seed)
    if synthetic:
        print("[warn] no ogbg-molhiv cache; synthetic stand-in")
    if args.add_self_loop:
        graphs, efeats = apply_self_loops(graphs, efeats)
    coll = GraphCollection(graphs, node_feats=nfeats, edge_feats=efeats,
                           labels=labels)
    max_degree = (dataset_max_degree(graphs) if args.centrality_encoder
                  else args.max_degree)
    model = build_model(args, max_degree,
                        torch.Generator().manual_seed(seed)).to(device)
    opt = make_adamw(model.parameters(), args.lr, args.wd)
    print(f"Params: {param_count(model)}")
    train_step = make_train_step(model, opt, args)
    gen = torch.Generator(device=device).manual_seed(seed)
    step_ms, wait_ms, collate_ms = [], [], []

    @torch.no_grad()
    def evaluate(idx):
        model.eval()
        losses, ps, ls = [], [], []
        for b, db in timed_batches(coll.loader(np.asarray(idx),
                                               args.batch_size),
                                   device, torch.float32, collate_ms):
            preds = model(db["graph"], db["node_feats"], db["edge_feats"])
            losses.append(float(bce(preds, db["labels"],
                                    db["graph_weights"])))
            w = b["graph_weights"].astype(bool)
            ps.append(preds.cpu().numpy()[w, 0])
            ls.append(b["labels"][w])
        return (float(np.mean(losses)),
                roc_auc(np.concatenate(ps), np.concatenate(ls)))

    driver = EpochDriver(epochs=args.epochs, warmup=10, factor=args.factor,
                         patience=args.patience, log_every=args.log_every)
    shuffle_rng = np.random.default_rng(seed + 12345)
    best = None
    for epoch in range(1, args.epochs + 1):
        # the warmup and plateau scale apply to THIS epoch's steps
        set_lr_scale(opt, driver.lr_scale(epoch))
        loader = prefetch(coll.loader(np.asarray(tr), args.batch_size,
                                      shuffle_rng))
        for _, db in timed_batches(loader, device, torch.float32, wait_ms):
            if not time_steps:
                train_step(db, gen)
                continue
            synchronize(device)
            t0 = time.perf_counter()
            train_step(db, gen)
            synchronize(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        loss, auc = evaluate(tr)
        _, val_auc = evaluate(va)
        _, test_auc = evaluate(te)
        driver.plateau_step(epoch, loss)
        if best is None or val_auc > best["val_metric"]:
            best = dict(val_metric=val_auc, test_metric=test_auc)
        if driver.should_log(epoch):
            print(f"Epoch {epoch:04d} | loss: {loss:.4f} | "
                  f"auc: {auc:.4f} | val: {val_auc:.4f} | "
                  f"test: {test_auc:.4f}")
    if stats is not None:
        stats.update(epochs=args.epochs, seconds=time.perf_counter() - t_run,
                     wait_ms=wait_ms, collate_ms=collate_ms)
        if time_steps:
            stats["step_ms"] = step_ms
    return best


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "SIR-GCN/GIN on ogbg-molhiv (PyTorch + CUDA port)",
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
    p.add_argument("--model", type=str, default="SIR",
                   choices=["SIR", "GIN"])
    p.add_argument("--nhidden", type=int, default=64)
    p.add_argument("--nlayers", type=int, default=4)
    p.add_argument("--input-dropout", type=float, default=0)
    p.add_argument("--edge-dropout", type=float, default=0,
                   help="per-layer edge dropout rate")
    p.add_argument("--dropout", type=float, default=0)
    p.add_argument("--readout-layers", type=int, default=0,
                   help="0 = the reference active model's fixed EGC "
                        "readout; >0 = per-node readout MLP layers "
                        "(richer variant)")
    p.add_argument("--readout-dropout", type=float, default=0)
    p.add_argument("--jumping-knowledge", action="store_true",
                   help="sum per-layer readouts (needs --readout-layers)")
    p.add_argument("--resid-layers", type=int, default=0,
                   help="MLP residual layers (0 = identity residual)")
    p.add_argument("--resid-dropout", type=float, default=0)
    p.add_argument("--add-self-loop", action="store_true")
    p.add_argument("--centrality-encoder", action="store_true",
                   help="set max-degree from the dataset's max in-degree")
    p.add_argument("--norm", type=str, default="none",
                   choices=["gn", "cn", "bn", "ln", "none"])
    p.add_argument("--readout-pooling", type=str, default="sum",
                   choices=["sum", "mean"])
    p.add_argument("--virtual-node", action="store_true")
    p.add_argument("--vn-layers", type=int, default=2)
    p.add_argument("--vn-dropout", type=float, default=0)
    p.add_argument("--vn-residual", action="store_true")
    p.add_argument("--rand-feat", action="store_true")
    p.add_argument("--max-degree", type=int, default=0)
    p.add_argument("--residual", action="store_true")
    p.add_argument("--feat-dropout", type=float, default=0)
    p.add_argument("--agg-type", type=str, default="sum",
                   choices=["sum", "max", "mean", "sym"])
    p.add_argument("--use-edge-feats", action="store_true")
    p.add_argument("--nlayers-mlp", type=int, default=2)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--wd", type=float, default=0)
    p.add_argument("--l1", type=float, default=0)
    p.add_argument("--l2", type=float, default=0)
    p.add_argument("--factor", type=float, default=0.5)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--flag", action="store_true")
    p.add_argument("--m", type=int, default=3)
    p.add_argument("--step-size", type=float, default=1e-3)
    p.add_argument("--nruns", type=int, default=10)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--synthetic-samples", type=int, default=1000)
    return p


def main(argv=None, stats: Optional[list] = None, time_steps: bool = False):
    """Train ``--nruns`` runs; returns (val ROC-AUCs, test ROC-AUCs). With
    ``stats`` (a list) each run appends its stats."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.cpu)
    set_edge_dtype(torch.bfloat16 if args.edge_bf16 else None)

    val_aucs, test_aucs = [], []
    for i in range(args.nruns):
        run_stats = {}
        r = run_single(args, args.seed + i, device, run_stats, time_steps)
        if stats is not None:
            stats.append(run_stats)
        val_aucs.append(r["val_metric"])
        test_aucs.append(r["test_metric"])

    print(f"Runned {args.nruns} times")
    aggregate_runs("val ROC-AUC", val_aucs)
    aggregate_runs("test ROC-AUC", test_aucs)
    return val_aucs, test_aucs


if __name__ == "__main__":
    main()
