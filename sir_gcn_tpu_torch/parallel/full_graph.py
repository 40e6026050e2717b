"""Row-sharded full-graph training (port of
``sir_gcn_tpu/parallel/full_graph.py``).

A single large graph's nodes are split into contiguous ranges, one a
rank. Because a ``GraphBatch`` stores its edges sorted by dst, the
in-edges of a rank's rows are one contiguous run of the edge arrays
(bounded by ``row_ptr`` at its first and last rows), and the rank owns
that run: every dst-side segment sum, max or softmax stays on the rank,
and only src-side node rows cross ranks. This is the owner-aggregates
layout that the JAX module's docstring names as its aim; JAX lays the edge
arrays out in equal chunks and lets XLA's partitioner move what crosses a
chunk boundary, and the port, with no partitioner, owns edges by dst.

:func:`shard_full_graph` gives one rank its handle, a
:class:`ShardedGraph`: a plain ``GraphBatch`` of its rows and its run of
edges, so that every model on the CSR aggregate (SIRConv with any
aggregation, GATv2, the rest of the zoo) runs on it unchanged. Its src ids
stay global: a gather by src (``seg.gather_rows(x, graph.src_segments)``)
first all-gathers the ranks' rows of ``x``, with a gradient (the backward
reduce-scatters), then indexes them. No kernel of the port runs on this
path, as none does on JAX's.

The JAX module's ``node_sharding`` and ``replicated`` name XLA shardings.
One process a rank needs neither: a rank holds its ``rows`` of a node
array, and everything else (the weights, the optimizer state) whole.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..graph import GraphBatch
from .collectives import gather_rows, rank_sum


class NodeShard:
    """One rank's handle on a graph partitioned by contiguous node ranges
    (a :class:`ShardedGraph` or a ``HaloGraph``): the models see the
    rank's ``n_pad`` rows of the whole graph's ``n_global``; ``rank`` and
    ``group`` name the rank. The trainers test for this class."""

    rank: int
    group: object
    # (lo, hi, e): the rank's edges lo:hi of the whole graph's e, where
    # its edge arrays hold only its own; None where they are the whole's
    edge_run: Optional[tuple] = None

    @property
    def rows(self) -> slice:
        lo = self.rank * self.n_pad
        return slice(lo, lo + self.n_pad)

    def rank_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The differentiable sum over the ranks, for statistics that span
        every node (BatchNorm, ContraNorm)."""
        return rank_sum(x, self.group)


@dataclasses.dataclass(frozen=True, kw_only=True)
class ShardedGraph(GraphBatch, NodeShard):
    """One rank's rows of a graph partitioned by node ranges, as a plain
    ``GraphBatch``: node-indexed fields (``n_pad``, ``node_mask``, the
    degrees, ``node2graph``) are the rank's rows; the edge fields
    (``e_pad``, ``edge_mask``, ``edge_perm``, ``dst``, ``row_ptr``) its run
    of the dst-sorted edges, dst in local ids; ``src`` keeps the whole
    graph's ids, and ``src_segments`` gathers from the whole graph's rows
    (``gather``, by default the differentiable all-gather over ``group``).
    ``edge_run`` places the run in the whole graph's edges, so a DropEdge
    mask is drawn at the whole graph's shape and the rank keeps its
    edges."""

    rank: int
    n_shards: int
    n_global: int
    edge_run: tuple
    group: object = None
    # the whole graph's rows of a node table from this rank's (None: the
    # all-gather over ``group``)
    gather: Optional[Callable] = dataclasses.field(default=None,
                                                   compare=False)

    @functools.cached_property
    def src_segments(self):
        from ..ops.segment import Segments

        src = self.host["src"][:self.num_edges]
        source = self.gather or functools.partial(gather_rows,
                                                  group=self.group)
        return Segments(self.src, self.n_global,
                        tail=self.e_pad - self.num_edges,
                        max_run=int(np.bincount(src).max(initial=0)),
                        source=source)


def shard_full_graph(graph: GraphBatch, n_shards: int, rank: int,
                     group=None, gather: Optional[Callable] = None
                     ) -> ShardedGraph:
    """Rank ``rank``'s :class:`ShardedGraph` of a dst-sorted ``graph`` (on
    the rank's device) over ``n_shards`` contiguous node ranges. The
    padding edges sit at the tail of the dst-sorted arrays, pointing at the
    last node, so they fall in the last rank's run. ``gather`` replaces
    the all-gather over ``group`` (a rank run alone on one device is given
    the gathered table)."""
    if graph.n_pad % n_shards:
        raise ValueError(
            f"n_pad {graph.n_pad} is not a multiple of {n_shards} shards; "
            f"build the graph with pad_multiple a multiple of the shard "
            f"count")
    if not 0 <= rank < n_shards:
        raise ValueError(f"rank {rank} of {n_shards} shards")
    h = graph.host
    n_local = graph.n_pad // n_shards
    lo, hi = rank * n_local, (rank + 1) * n_local
    elo, ehi = int(h["row_ptr"][lo]), int(h["row_ptr"][hi])
    rows, run = slice(lo, hi), slice(elo, ehi)
    host = dict(
        src=h["src"][run], dst=h["dst"][run] - np.int32(lo),
        edge_perm=h["edge_perm"][run],
        row_ptr=h["row_ptr"][lo:hi + 1] - np.int32(elo),
        node_mask=h["node_mask"][rows], edge_mask=h["edge_mask"][run],
        graph_mask=h["graph_mask"], node2graph=h["node2graph"][rows],
        in_deg=h["in_deg"][rows], out_deg=h["out_deg"][rows])
    host = {k: np.ascontiguousarray(v) for k, v in host.items()}
    dev = {k: torch.from_numpy(v).to(graph.device) for k, v in host.items()}
    return ShardedGraph(
        num_nodes=int(host["node_mask"].sum()),
        num_edges=int(host["edge_mask"].sum()), num_graphs=graph.num_graphs,
        host=host, rank=rank, n_shards=n_shards, n_global=graph.n_pad,
        edge_run=(elo, ehi, graph.e_pad), group=group, gather=gather, **dev)
