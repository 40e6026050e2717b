"""Correct & Smooth post-processing of ogbn-arxiv predictions (port of
``experiments/ogbn_arxiv/correct_and_smooth.py``; reference
``benchmark-datasets/ogbn-arxiv/correct_and_smooth.py``): loads saved
softmax prediction files, runs the *correct* step (the train residuals
propagated by label spreading, y <- alpha * D^-1/2 A D^-1/2 y + (1-alpha)
y0, :41-58, 87-91) and the *smooth* step (the clamped train one-hots
propagated, :93-97), and evaluates accuracy before and after. Each
propagation is ``copy_src_aggregate``, the CSR aggregate's segment sum.

Runs on the CUDA card unless ``--cpu`` is given; with no card and no
``--cpu`` it raises.

    python -m sir_gcn_tpu_torch.experiments.ogbn_arxiv.correct_and_smooth \\
        --use-sym --add-reverse-edge --add-self-loop
"""

from __future__ import annotations

import argparse
import glob
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ...data.loaders import load_node_classification
from ...ops.message_passing import copy_src_aggregate
from ...train import resolve_device
from .train import build_arxiv_graph


def label_spreading(graph, y0, nprop=10, alpha=0.1, use_sym=True,
                    post_step=None):
    """nprop iterations of y <- alpha * P y + (1-alpha) y0 with
    P = D^-1/2 A D^-1/2 (sym) or the row mean (reference :41-58)."""
    degs = graph.in_deg.clamp_min(1.0)
    norm = degs.pow(-0.5)[:, None] if use_sym else 1.0
    agg = "sum" if use_sym else "mean"

    y = y0
    for _ in range(nprop):
        y = copy_src_aggregate(graph, y * norm, agg) * norm
        y = alpha * y + (1 - alpha) * y0
        if post_step is not None:
            y = post_step(y)
    return y


def fix_input(x, y, mask):
    return torch.where(mask[:, None], y, x)


def evaluate(pred, labels, masks):
    out = []
    for w in masks:
        idx = w.astype(bool)
        out.append(float(np.mean(np.argmax(pred[idx], -1) == labels[idx])))
    return out


def run(graph, predictions, labels, masks, args, pred_file):
    """Correct and smooth one prediction file's [N_pad, C] softmax on
    ``graph``'s device; returns the accuracies before and after."""
    device = graph.in_deg.device
    train_mask = torch.from_numpy(masks[0].astype(bool)).to(device)
    nclasses = predictions.shape[1]
    labels_t = torch.from_numpy(labels.astype(np.int64)).to(device)

    predictions = np.asarray(predictions, np.float32)
    y = torch.from_numpy(predictions).to(device)
    orig = evaluate(predictions, labels, masks)
    print(f"Original val_acc: {orig[1]:.4f}")
    print(f"Original test_acc: {orig[2]:.4f}")

    one_hot = (F.one_hot(labels_t, nclasses).to(y.dtype)
               * train_mask[:, None])

    # Correct step (:87-91)
    dy = torch.where(train_mask[:, None], one_hot - y, 0.0)
    smoothed_dy = label_spreading(
        graph, dy, nprop=args.nprop_c, alpha=args.alpha_c,
        use_sym=args.use_sym,
        post_step=partial(fix_input, y=dy, mask=train_mask))
    y = y + args.alpha_c * smoothed_dy

    # Smooth step (:93-97)
    y = torch.where(train_mask[:, None], one_hot, y)
    smoothed_y = label_spreading(
        graph, y, nprop=args.nprop_s, alpha=args.alpha_s,
        use_sym=args.use_sym, post_step=lambda x: x.clamp(0, 1))

    final = smoothed_y.cpu().numpy()
    accs = evaluate(final, labels, masks)
    print(f"New val_acc: {accs[1]:.4f}")
    print(f"New test_acc: {accs[2]:.4f}")

    if args.save_pred:
        np.save(pred_file.replace("_", "_cs_"), final)

    return {"orig_val_acc": orig[1], "orig_test_acc": orig[2],
            "val_acc": accs[1], "test_acc": accs[2]}


def main(argv=None) -> list:
    """Correct and smooth every ``--pred-files`` file; returns each one's
    accuracies (see :func:`run`)."""
    p = argparse.ArgumentParser(
        "Correct & Smooth on ogbn-arxiv (PyTorch + CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU")
    p.add_argument("--gpu", type=int, default=0,
                   help="ignored (the card is cuda:0); accepted so "
                        "reference commands run unchanged")
    p.add_argument("--add-self-loop", action="store_true")
    p.add_argument("--add-reverse-edge", action="store_true")
    p.add_argument("--use-sym", action="store_true",
                   help="symmetric propagation (vs row mean)")
    p.add_argument("--nprop-c", type=int, default=10)
    p.add_argument("--alpha-c", type=float, default=0.8)
    p.add_argument("--nprop-s", type=int, default=10)
    p.add_argument("--alpha-s", type=float, default=0.6)
    p.add_argument("--pred-files", type=str, default="./output/*.npy")
    p.add_argument("--save-pred", action="store_true")
    p.add_argument("--synthetic-nodes", type=int, default=4096)
    p.add_argument("--synthetic-edges", type=int, default=32768)
    args = p.parse_args(argv)
    device = resolve_device(args.cpu)

    data = load_node_classification(
        "ogbn-arxiv",
        synthetic_fallback=dict(num_nodes=args.synthetic_nodes,
                                num_edges=args.synthetic_edges,
                                feat_dim=128, num_classes=40),
    )
    graph = build_arxiv_graph(data, args, device)
    n_pad = graph.n_pad
    labels = np.zeros(n_pad, np.int32)
    labels[: len(data.labels)] = data.labels

    def mask_of(idx):
        w = np.zeros(n_pad, np.float32)
        w[idx] = 1.0
        return w

    masks = tuple(mask_of(i) for i in
                  (data.train_idx, data.val_idx, data.test_idx))

    results = []
    for pred_file in sorted(glob.glob(args.pred_files)):
        print(f"=== {pred_file}")
        pred = np.load(pred_file)
        if pred.shape[0] < n_pad:
            pred = np.concatenate(
                [pred, np.zeros((n_pad - pred.shape[0], pred.shape[1]),
                                pred.dtype)])
        results.append(run(graph, pred, labels, masks, args, pred_file))

    if results:
        for k in results[0]:
            vals = [r[k] for r in results]
            print(f"Average {k}: {np.mean(vals):.6f} ± {np.std(vals):.6f}")
    return results


if __name__ == "__main__":
    main()
