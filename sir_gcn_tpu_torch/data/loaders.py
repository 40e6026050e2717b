"""Dataset ingestion (port of ``sir_gcn_tpu/data/loaders.py``).

Node-classification datasets are read from the same ``.npz`` caches as the
JAX package (``datasets/<name>.npz`` at the root of the checkout, or under
``$SIR_GCN_DATA``):

    src, dst : int64 [E]          edge list (original direction)
    feat     : float32 [N, D]     node features
    labels   : int64 [N]
    train_idx/val_idx/test_idx : int64

With no cache, a synthetic stand-in of matched shape is generated; for the
same seed it returns the same arrays as the JAX package's generator.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

DATA_ROOT = os.environ.get(
    "SIR_GCN_DATA", os.path.join(os.path.dirname(__file__), "..", "..",
                                 "datasets")
)


@dataclass
class NodeClassificationData:
    src: np.ndarray
    dst: np.ndarray
    feat: np.ndarray
    labels: np.ndarray
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray
    num_classes: int
    synthetic: bool = False


def _cache_path(name: str) -> str:
    return os.path.join(DATA_ROOT, f"{name.replace('-', '_')}.npz")


def load_node_classification(
    name: str,
    synthetic_fallback: Optional[dict] = None,
    seed: int = 0,
) -> NodeClassificationData:
    """Load a node-classification dataset from its npz cache, or generate a
    synthetic stand-in (flagged ``synthetic=True``)."""
    path = _cache_path(name)
    if os.path.exists(path):
        z = np.load(path)
        labels = z["labels"].astype(np.int64).ravel()
        return NodeClassificationData(
            src=z["src"].astype(np.int64),
            dst=z["dst"].astype(np.int64),
            feat=z["feat"].astype(np.float32),
            labels=labels,
            train_idx=z["train_idx"].astype(np.int64),
            val_idx=z["val_idx"].astype(np.int64),
            test_idx=z["test_idx"].astype(np.int64),
            num_classes=int(labels.max()) + 1,
        )
    if synthetic_fallback is None:
        raise FileNotFoundError(
            f"no cache at {path}; provide one or pass synthetic_fallback")
    return synthetic_node_classification(seed=seed, **synthetic_fallback)


def synthetic_node_classification(
    num_nodes: int = 4096,
    num_edges: int = 32768,
    feat_dim: int = 128,
    num_classes: int = 40,
    homophily: float = 0.6,
    train_frac: float = 0.54,
    val_frac: float = 0.18,
    seed: int = 0,
) -> NodeClassificationData:
    """Class-centroid features + homophilous random edges: a learnable task
    with ogbn-arxiv-like shape for pipeline tests and benchmarks."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num_nodes)
    centroids = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    feat = (centroids[labels]
            + 1.5 * rng.normal(size=(num_nodes, feat_dim))).astype(np.float32)

    src = rng.integers(0, num_nodes, num_edges)
    # homophilous: with prob `homophily`, rewire dst to a same-class node
    dst = rng.integers(0, num_nodes, num_edges)
    same = rng.random(num_edges) < homophily
    order = np.argsort(labels, kind="stable")
    starts = np.searchsorted(labels[order], np.arange(num_classes))
    ends = np.searchsorted(labels[order], np.arange(num_classes), "right")
    cls = labels[src[same]]
    span = np.maximum(ends[cls] - starts[cls], 1)
    dst[same] = order[starts[cls] + (rng.random(same.sum()) * span).astype(int)]

    perm = rng.permutation(num_nodes)
    n_train = int(train_frac * num_nodes)
    n_val = int(val_frac * num_nodes)
    return NodeClassificationData(
        src=src.astype(np.int64),
        dst=dst.astype(np.int64),
        feat=feat,
        labels=labels.astype(np.int64),
        train_idx=perm[:n_train],
        val_idx=perm[n_train:n_train + n_val],
        test_idx=perm[n_train + n_val:],
        num_classes=num_classes,
        synthetic=True,
    )
