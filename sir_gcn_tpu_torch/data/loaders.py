"""Dataset ingestion (port of ``sir_gcn_tpu/data/loaders.py``).

Node-classification datasets are read from the same ``.npz`` caches as the
JAX package (``datasets/<name>.npz`` at the root of the checkout, or under
``$SIR_GCN_DATA``):

    src, dst : int64 [E]          edge list (original direction)
    feat     : float32 [N, D]     node features
    labels   : int64 [N]
    train_idx/val_idx/test_idx : int64

The batched-graph workloads read ``datasets/<name>.npz`` caches of
concatenated graphs (``offsets_nodes``, ``offsets_edges``, ``src``,
``dst``, ``node_feat``, ``edge_feat`` or ``node_label``, ``labels``, the
split indices), the JAX package's layout.

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


def has_cache(name: str) -> bool:
    return os.path.exists(_cache_path(name))


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


def load_graph_cache(name: str):
    """The npz cache of a batched-graph dataset: the archive and its
    graphs split by the offsets, as ``(src, dst, num_nodes)`` triples and
    per-graph slices ``nodes(key)`` / ``edges(key)`` of a node- or
    edge-level array."""
    z = np.load(_cache_path(name))
    on, oe = z["offsets_nodes"], z["offsets_edges"]
    graphs = [(z["src"][oe[i]:oe[i + 1]], z["dst"][oe[i]:oe[i + 1]],
               int(on[i + 1] - on[i])) for i in range(len(on) - 1)]

    def nodes(key):
        return [z[key][on[i]:on[i + 1]] for i in range(len(on) - 1)]

    def edges(key):
        return [z[key][oe[i]:oe[i + 1]] for i in range(len(oe) - 1)]

    return z, graphs, nodes, edges


def synthetic_ogb_molecules(
    num_graphs: int = 1000,
    min_nodes: int = 9,
    max_nodes: int = 30,
    seed: int = 0,
):
    """ogbg-molhiv-shaped synthetic graphs: 9-column OGB atom features,
    3-column bond features, binary graph label derived from structure."""
    from ..models.encoders import ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS

    rng = np.random.default_rng(seed)
    graphs, nfeats, efeats, labels = [], [], [], []
    for _ in range(num_graphs):
        n = int(rng.integers(min_nodes, max_nodes + 1))
        s = list(range(n - 1)) + rng.integers(0, n, max(1, n // 5)).tolist()
        d = list(range(1, n)) + rng.integers(0, n, max(1, n // 5)).tolist()
        src = np.asarray(s + d, np.int32)
        dst = np.asarray(d + s, np.int32)
        nf = np.stack([rng.integers(0, c, n)
                       for c in ATOM_FEATURE_DIMS], 1).astype(np.int32)
        ef = np.stack([rng.integers(0, c, len(src))
                       for c in BOND_FEATURE_DIMS], 1).astype(np.int32)
        y = float(nf[:, 0].mean() > ATOM_FEATURE_DIMS[0] / 2 - 1)
        graphs.append((src, dst, n))
        nfeats.append(nf)
        efeats.append(ef)
        labels.append(y)
    return graphs, nfeats, efeats, np.asarray(labels, np.float32)


def synthetic_molecules(
    num_graphs: int = 1000,
    min_nodes: int = 9,
    max_nodes: int = 37,
    num_atom_types: int = 28,
    num_bond_types: int = 4,
    seed: int = 0,
):
    """ZINC-shaped synthetic molecular graphs (chain backbones plus random
    chords, both directions) with a structure-derived regression target,
    for the batched-graph pipeline without the real dataset."""
    rng = np.random.default_rng(seed)
    graphs, nfeats, efeats, labels = [], [], [], []
    for _ in range(num_graphs):
        n = int(rng.integers(min_nodes, max_nodes + 1))
        s = list(range(n - 1))
        d = list(range(1, n))
        extra = max(1, n // 5)
        s += rng.integers(0, n, extra).tolist()
        d += rng.integers(0, n, extra).tolist()
        src = np.asarray(s + d, np.int32)
        dst = np.asarray(d + s, np.int32)
        at = rng.integers(0, num_atom_types, n).astype(np.int32)
        bt = rng.integers(0, num_bond_types, len(src)).astype(np.int32)
        # target: a graph statistic in roughly ZINC's label range
        y = (np.mean(at) / num_atom_types - 0.5) * 4 + 0.1 * (len(src) / n)
        graphs.append((src, dst, n))
        nfeats.append(at)
        efeats.append(bt)
        labels.append(y)
    return graphs, nfeats, efeats, np.asarray(labels, np.float32)
