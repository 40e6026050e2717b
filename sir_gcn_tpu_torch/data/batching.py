"""Static-shape batched-graph loading (port of
``sir_gcn_tpu/data/batching.py``).

The ``dgl.dataloading.GraphDataLoader`` + ``dgl.batch`` collate of the
reference (``benchmark-datasets/zinc/train.py:42-44``): every batch is a
disjoint union padded to one (n_pad, e_pad, g_pad) bucket computed from
the dataset's worst case, the JAX package's layout. A partial final batch
is padded with empty graphs of weight 0.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..graph import _round_up, batch_graphs


class GraphCollection:
    """A dataset of variable-size graphs with per-node (and optionally
    per-edge) features and per-graph labels, served as fixed-bucket
    batches.

    Parameters
    ----------
    graphs : list of (src, dst, num_nodes)
    node_feats : list of [n_i, ...] arrays (or None)
    edge_feats : list of [e_i, ...] arrays (or None)
    labels : [S, ...] per-graph labels (or None)
    node_labels : list of [n_i, ...] per-node labels (or None)
    """

    def __init__(
        self,
        graphs: Sequence[tuple],
        node_feats: Optional[Sequence[np.ndarray]] = None,
        edge_feats: Optional[Sequence[np.ndarray]] = None,
        labels: Optional[np.ndarray] = None,
        node_labels: Optional[Sequence[np.ndarray]] = None,
    ):
        self.graphs = list(graphs)
        self.node_feats = node_feats
        self.edge_feats = edge_feats
        self.labels = labels
        self.node_labels = node_labels
        self.max_nodes = max(g[2] for g in self.graphs)
        self.max_edges = max(len(g[0]) for g in self.graphs)

    def __len__(self):
        return len(self.graphs)

    def bucket_shape(self, batch_size: int, pad_multiple: int = 8):
        n_pad = _round_up(batch_size * self.max_nodes + 1, pad_multiple)
        e_pad = _round_up(max(batch_size * self.max_edges, 1), pad_multiple)
        return n_pad, e_pad, batch_size + 1

    def collate(self, idx: np.ndarray, batch_size: int,
                device: torch.device | str = "cpu") -> dict:
        """One padded batch of the samples ``idx`` (fewer than
        ``batch_size`` for a final partial batch): ``graph``, a
        ``GraphBatch`` on ``device``, and NumPy arrays ``node_feats``,
        ``edge_feats``, ``labels``, ``node_labels``, ``node_weights`` (for
        the fields the collection has) and ``graph_weights``."""
        n_pad, e_pad, g_pad = self.bucket_shape(batch_size)
        gs = [self.graphs[i] for i in idx]
        out = {"graph": batch_graphs(gs, n_pad=n_pad, e_pad=e_pad,
                                     g_pad=g_pad, device=device)}
        if self.node_feats is not None:
            out["node_feats"] = _pad_rows(
                np.concatenate([self.node_feats[i] for i in idx]), n_pad)
        if self.edge_feats is not None:
            out["edge_feats"] = _pad_rows(
                np.concatenate([self.edge_feats[i] for i in idx]), e_pad)
        if self.labels is not None:
            out["labels"] = _pad_rows(np.asarray(self.labels)[idx], g_pad)
        if self.node_labels is not None:
            nl = np.concatenate([self.node_labels[i] for i in idx])
            out["node_labels"] = _pad_rows(nl, n_pad)
            nw = np.zeros(n_pad, np.float32)
            nw[: nl.shape[0]] = 1.0
            out["node_weights"] = nw
        w = np.zeros(g_pad, np.float32)
        w[: len(idx)] = 1.0
        out["graph_weights"] = w
        return out

    def loader(
        self,
        idx: np.ndarray,
        batch_size: int,
        shuffle_rng: Optional[np.random.Generator] = None,
        drop_last: bool = False,
        device: torch.device | str = "cpu",
    ) -> Iterator[dict]:
        """Batches of ``idx`` in order, or in ``shuffle_rng``'s
        permutation of it."""
        order = np.asarray(idx)
        if shuffle_rng is not None:
            order = shuffle_rng.permutation(order)
        for s in range(0, len(order), batch_size):
            sel = order[s: s + batch_size]
            if drop_last and len(sel) < batch_size:
                break
            yield self.collate(sel, batch_size, device)


def _pad_rows(x: np.ndarray, rows: int) -> np.ndarray:
    """``x`` with zero rows appended up to ``rows``."""
    pad = np.zeros((rows - x.shape[0],) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad])
