"""Synthetic graphs (port of ``sir_gcn_tpu/data/synthetic.py``): for now
the heavy-tailed edge sampler of the benchmark's powerlaw graph."""

from __future__ import annotations

import numpy as np


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
