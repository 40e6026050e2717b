"""Synthetic graphs (port of ``sir_gcn_tpu/data/synthetic.py``): the two
correctness-probe datasets of the reference and the heavy-tailed edge
sampler of the benchmark's powerlaw graph.

* DictionaryLookup (Brody et al.): bipartite key/value graphs with a known
  exact solution; SIR-GCN must reach accuracy 1.0
  (reference ``synthetic-datasets/dictionary-lookup/data.py:9-41``).
* HeteroEdgeCount: the regression target is an exactly computable graph
  statistic, the count (or fraction) of heterophilous edges
  (reference ``synthetic-datasets/hetero-edge-count/data.py:8-36``).

Both draw from a NumPy generator in the JAX package's order, so the two
packages build equal arrays from equal seeds.
"""

from __future__ import annotations

import numpy as np


class DictionaryLookupDataset:
    """n key nodes (ids 0..n-1) and n value nodes (ids n..2n-1), complete
    bipartite edges value -> key. Node features are (key_id, val_id) pairs;
    key nodes carry ``empty_id = n`` in the value slot. Each key node must
    predict its value (data.py:27-35).

    All samples share one graph structure and differ in their features
    only, so a batcher can reuse one edge template."""

    def __init__(self, num_nodes: int, num_samples: int = 1000,
                 rng: np.random.Generator | None = None):
        self.num_nodes = num_nodes
        self.empty_id = num_nodes
        self.num_samples = num_samples
        rng = rng or np.random.default_rng()

        n = num_nodes
        # edges: product(val, key) -> src = value nodes, dst = key nodes
        val_ids = np.arange(n, 2 * n)
        key_ids = np.arange(n)
        self.src = np.repeat(val_ids, n).astype(np.int32)
        self.dst = np.tile(key_ids, n).astype(np.int32)
        self.graph_num_nodes = 2 * n

        # features [S, 2n, 2]: keys get (key, empty), values get (key, perm)
        perms = np.stack([rng.permutation(n) for _ in range(num_samples)])
        feats = np.zeros((num_samples, 2 * n, 2), np.int32)
        feats[:, :n, 0] = key_ids
        feats[:, :n, 1] = self.empty_id
        feats[:, n:, 0] = key_ids
        feats[:, n:, 1] = perms
        self.feats = feats
        self.labels = perms.astype(np.int32)  # label of key node i = perm[i]
        # True on key nodes, the prediction targets (data.py:20)
        self.key_mask = np.concatenate([np.ones(n, bool), np.zeros(n, bool)])

    def __len__(self):
        return self.num_samples


class HeteroEdgeCountDataset:
    """Random graphs whose regression target is the number (or fraction)
    of heterophilous edges, those whose endpoint classes differ
    (reference ``synthetic-datasets/hetero-edge-count/data.py:8-36``):
    2..max_nodes nodes, an edge count uniform in [n^2/4, n^2]
    (data.py:27-29), node classes uniform in [0, num_classes);
    ``normalize=True`` divides by the edge count (data.py:20-21).

    Edges are ``num_edges`` distinct ordered pairs (self-loops allowed),
    as ``dgl.rand_graph`` samples them without replacement."""

    def __init__(self, max_nodes: int, num_classes: int,
                 num_samples: int = 1000, normalize: bool = True,
                 rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng()
        self.num_classes = num_classes
        self.graphs = []   # (src, dst, num_nodes)
        self.feats = []    # [n] int class labels
        self.labels = []   # scalar target
        for _ in range(num_samples):
            n = int(rng.integers(2, max_nodes + 1))
            e = int(rng.integers(n * n // 4, n * n + 1))
            e = max(e, 1)
            pairs = rng.choice(n * n, size=e, replace=False)
            src = (pairs // n).astype(np.int32)
            dst = (pairs % n).astype(np.int32)
            classes = rng.integers(0, num_classes, n).astype(np.int32)
            hetero = float(np.sum(classes[src] != classes[dst]))
            y = hetero / e if normalize else hetero
            self.graphs.append((src, dst, n))
            self.feats.append(classes)
            self.labels.append(y)
        self.labels = np.asarray(self.labels, np.float32)

    def __len__(self):
        return len(self.graphs)


def powerlaw_edges(rng: np.random.Generator, num_nodes: int,
                   num_edges: int, exponent: float = 1.05):
    """Heavy-tailed in-degree edge sampler, after the power-law in-degrees
    of the ogbn-arxiv citation graph: ``dst`` follows a truncated Zipf over
    node ranks, ``src`` is uniform. Returns (src, dst) int64 arrays."""
    p = np.arange(1, num_nodes + 1, dtype=np.float64) ** -exponent
    p /= p.sum()
    dst = rng.choice(num_nodes, size=num_edges, p=p).astype(np.int64)
    src = rng.integers(0, num_nodes, num_edges).astype(np.int64)
    return src, dst
