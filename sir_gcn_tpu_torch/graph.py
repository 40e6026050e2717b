"""Static-shape graph containers (PyTorch port of ``sir_gcn_tpu/graph.py``).

A :class:`GraphBatch` holds a graph's structure as tensors on one device,
plus NumPy mirrors of the same arrays (``host``) so that the host-side ELL
planner (``ops/ell.py``) reads the structure without a device-to-host copy.

Layout (identical to the JAX package, so the two can be compared array for
array):
  * edges in COO (``src``, ``dst``) sorted by dst, stable in input order,
    with a CSR ``row_ptr`` over dst;
  * padding nodes and edges appended at the end and tracked by masks;
    padding edges point at the last padded node so dst stays sorted.

Graph transforms (reverse / bidirect / self-loops), batching and the RCM
locality reordering are host-side NumPy; the DropEdge mask is drawn on the
graph's device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A (possibly batched) graph with static padded shapes.

    src, dst : int32 [E_pad], sorted by dst; messages flow src -> dst.
    edge_perm : int32 [E_pad], sorted-edge position -> original edge id.
    row_ptr : int32 [N_pad + 1], CSR pointers over dst.
    node_mask, edge_mask, graph_mask : bool validity masks.
    node2graph : int32 [N_pad], graph id per node.
    num_nodes, num_edges, num_graphs : int, the true (unpadded) counts.
    in_deg, out_deg : float32 [N_pad], true degrees (0 on padding).
    host : NumPy copies of the array fields, keyed by field name.

    ``dst_segments``, ``src_segments`` and ``graph_segments`` hold dst, src
    and ``node2graph`` (sorted: graphs in order, padding nodes in the last)
    as the segment ops' ``Segments``, whose fixed-order sum plans (for
    the sums and the gathers' backward on a card) a graph builds once,
    told that the padding edges (nodes) come last and point at the last
    node (graph), and the longest real run.
    """

    src: torch.Tensor
    dst: torch.Tensor
    edge_perm: torch.Tensor
    row_ptr: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    graph_mask: torch.Tensor
    node2graph: torch.Tensor
    num_nodes: int
    num_edges: int
    num_graphs: int
    in_deg: torch.Tensor
    out_deg: torch.Tensor
    host: dict = dataclasses.field(repr=False, compare=False)

    @property
    def n_pad(self) -> int:
        return self.node_mask.shape[0]

    @property
    def e_pad(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def g_pad(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.src.device

    def batch_num_nodes(self) -> torch.Tensor:
        """Number of real nodes per graph, float32 [G_pad] (0 for padded
        graphs)."""
        m = self.node_mask.to(torch.float32)
        return m.new_zeros(self.g_pad).index_add(0, self.node2graph, m)

    @functools.cached_property
    def dst_segments(self):
        from .ops.segment import Segments

        return Segments(self.dst, self.n_pad, sorted_ids=True,
                        tail=self.e_pad - self.num_edges,
                        max_run=int(self.host["in_deg"].max(initial=0)))

    @functools.cached_property
    def src_segments(self):
        from .ops.segment import Segments

        return Segments(self.src, self.n_pad,
                        tail=self.e_pad - self.num_edges,
                        max_run=int(self.host["out_deg"].max(initial=0)))

    @functools.cached_property
    def graph_segments(self):
        from .ops.segment import Segments

        sizes = np.bincount(self.host["node2graph"][:self.num_nodes])
        return Segments(self.node2graph, self.g_pad, sorted_ids=True,
                        tail=self.n_pad - self.num_nodes,
                        max_run=int(sizes.max(initial=0)))

    def broadcast_nodes(self, gfeat: torch.Tensor) -> torch.Tensor:
        """Graph-level -> node-level broadcast (``dgl.broadcast_nodes``):
        row ``node2graph[u]`` of ``gfeat`` for each node u."""
        from .ops.segment import gather_rows

        return gather_rows(gfeat, self.graph_segments)

    def to(self, device: torch.device | str) -> "GraphBatch":
        """This graph with its tensors on ``device``, copied from the host
        mirrors (the same object if it is there already)."""
        device = torch.device(device)
        here = self.device
        if device.type == here.type and device.index in (None, here.index):
            return self
        return dataclasses.replace(
            self, **{k: torch.from_numpy(v).to(device)
                     for k, v in self.host.items()})


def build_graph(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    n_pad: Optional[int] = None,
    e_pad: Optional[int] = None,
    node2graph: Optional[np.ndarray] = None,
    num_graphs: int = 1,
    g_pad: Optional[int] = None,
    pad_multiple: int = 8,
    device: torch.device | str = "cpu",
) -> GraphBatch:
    """Build a :class:`GraphBatch` from a COO edge list on the host and
    place its tensors on ``device``."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    num_edges = int(src.shape[0])
    if n_pad is None:
        n_pad = max(_round_up(max(num_nodes, 1), pad_multiple), pad_multiple)
    if e_pad is None:
        e_pad = max(_round_up(max(num_edges, 1), pad_multiple), pad_multiple)
    if g_pad is None:
        g_pad = num_graphs
    if not (n_pad >= num_nodes and e_pad >= num_edges
            and g_pad >= num_graphs):
        raise ValueError(
            f"padding ({n_pad}, {e_pad}, {g_pad}) below the true counts "
            f"({num_nodes}, {num_edges}, {num_graphs})")

    order = np.argsort(dst, kind="stable").astype(np.int32)
    s_src = src[order]
    s_dst = dst[order]

    pad_e = e_pad - num_edges
    pad_node = n_pad - 1
    p_src = np.concatenate([s_src, np.full(pad_e, pad_node, np.int32)])
    p_dst = np.concatenate([s_dst, np.full(pad_e, pad_node, np.int32)])
    p_perm = np.concatenate([order, np.zeros(pad_e, np.int32)])

    counts = np.bincount(p_dst, minlength=n_pad)
    row_ptr = np.zeros(n_pad + 1, np.int32)
    np.cumsum(counts, out=row_ptr[1:])

    node_mask = np.arange(n_pad) < num_nodes
    edge_mask = np.arange(e_pad) < num_edges
    graph_mask = np.arange(g_pad) < num_graphs

    if node2graph is None:
        n2g = np.zeros(n_pad, np.int32)
        n2g[~node_mask] = g_pad - 1
    else:
        n2g = np.full(n_pad, g_pad - 1, np.int32)
        n2g[:num_nodes] = np.asarray(node2graph, dtype=np.int32)[:num_nodes]

    in_deg = np.bincount(s_dst, minlength=n_pad).astype(np.float32)
    out_deg = np.bincount(s_src, minlength=n_pad).astype(np.float32)
    in_deg[~node_mask] = 0.0
    out_deg[~node_mask] = 0.0

    host = dict(src=p_src, dst=p_dst, edge_perm=p_perm, row_ptr=row_ptr,
                node_mask=node_mask, edge_mask=edge_mask,
                graph_mask=graph_mask, node2graph=n2g, in_deg=in_deg,
                out_deg=out_deg)
    dev = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    return GraphBatch(num_nodes=int(num_nodes), num_edges=num_edges,
                      num_graphs=int(num_graphs), host=host, **dev)


def batch_graphs(
    graphs: list[tuple[np.ndarray, np.ndarray, int]],
    *,
    n_pad: Optional[int] = None,
    e_pad: Optional[int] = None,
    g_pad: Optional[int] = None,
    pad_multiple: int = 8,
    device: torch.device | str = "cpu",
) -> GraphBatch:
    """Disjoint union of ``(src, dst, num_nodes)`` triples into one
    :class:`GraphBatch` on ``device`` (``dgl.batch``); one padding graph
    unless ``g_pad`` is given."""
    num_graphs = len(graphs)
    srcs, dsts, n2g = [], [], []
    offset = 0
    for gid, (s, d, n) in enumerate(graphs):
        srcs.append(np.asarray(s, np.int64) + offset)
        dsts.append(np.asarray(d, np.int64) + offset)
        n2g.append(np.full(n, gid, np.int32))
        offset += n
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    node2graph = np.concatenate(n2g) if n2g else np.zeros(0, np.int32)
    return build_graph(
        src, dst, offset, n_pad=n_pad, e_pad=e_pad, node2graph=node2graph,
        num_graphs=num_graphs,
        g_pad=g_pad if g_pad is not None else num_graphs + 1,
        pad_multiple=pad_multiple, device=device)


# ----------------------------------------------------------------------
# Host-side graph transforms (reference: dgl.reverse / to_bidirected /
# add_self_loop / remove_self_loop)
# ----------------------------------------------------------------------

def reverse_edges(src: np.ndarray, dst: np.ndarray):
    return np.asarray(dst), np.asarray(src)


def to_bidirected(src: np.ndarray, dst: np.ndarray):
    """Union of edges and reversed edges, deduplicated, in first-seen
    order (dgl.to_bidirected)."""
    s = np.concatenate([src, dst]).astype(np.int64)
    d = np.concatenate([dst, src]).astype(np.int64)
    key = s * (max(int(s.max(initial=0)), int(d.max(initial=0))) + 1) + d
    _, idx = np.unique(key, return_index=True)
    idx.sort()
    return s[idx], d[idx]


def remove_self_loops(src: np.ndarray, dst: np.ndarray):
    keep = src != dst
    return src[keep], dst[keep]


def add_self_loops(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    loop = np.arange(num_nodes, dtype=src.dtype if src.size else np.int64)
    return np.concatenate([src, loop]), np.concatenate([dst, loop])


# ----------------------------------------------------------------------
# Host-side locality reordering
# ----------------------------------------------------------------------

def rcm_order(src: np.ndarray, dst: np.ndarray, num_nodes: int
              ) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the undirected support graph,
    ``perm[new_id] = old_id``: scipy's ``reverse_cuthill_mckee``, or
    :func:`_rcm_numpy` where scipy is missing. Relabelling by it puts each
    node's neighbours in a narrow id band, so the row gathers read nearby
    rows. Apply with :func:`permute_nodes` before :func:`build_graph`."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    try:
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except ImportError:
        return _rcm_numpy(src, dst, num_nodes)
    a = coo_matrix(
        (np.ones(2 * len(src), np.int8),
         (np.concatenate([src, dst]), np.concatenate([dst, src]))),
        shape=(num_nodes, num_nodes)).tocsr()
    return np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True),
                      np.int64)


def _rcm_numpy(src: np.ndarray, dst: np.ndarray, num_nodes: int
               ) -> np.ndarray:
    """NumPy RCM: a BFS from a least-degree unvisited node of each
    component, neighbours visited in increasing-degree order, then the
    whole order reversed."""
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    order = np.argsort(s, kind="stable")
    s, d = s[order], d[order]
    deg = np.bincount(s, minlength=num_nodes)
    ptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(deg, out=ptr[1:])

    visited = np.zeros(num_nodes, bool)
    out = np.empty(num_nodes, np.int64)
    pos = 0
    for seed in np.argsort(deg, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        out[pos] = seed
        head = pos
        pos += 1
        while head < pos:
            u = out[head]
            head += 1
            nbr = d[ptr[u]:ptr[u + 1]]
            nbr = nbr[~visited[nbr]]
            if nbr.size:
                nbr = np.unique(nbr)
                nbr = nbr[np.argsort(deg[nbr], kind="stable")]
                visited[nbr] = True
                out[pos:pos + nbr.size] = nbr
                pos += nbr.size
    return out[::-1].copy()


def permute_nodes(src: np.ndarray, dst: np.ndarray, perm: np.ndarray):
    """Relabel endpoints under ``perm`` (``perm[new_id] = old_id``).

    Returns ``(new_src, new_dst, relabel)`` with ``relabel[old] = new``;
    node data moves as ``x_new = x_old[perm]``, results map back as
    ``y_old = y_new[relabel]``."""
    perm = np.asarray(perm, np.int64)
    relabel = np.empty_like(perm)
    relabel[perm] = np.arange(len(perm))
    return (relabel[np.asarray(src, np.int64)],
            relabel[np.asarray(dst, np.int64)], relabel)


def bandwidth(src: np.ndarray, dst: np.ndarray) -> float:
    """Mean |src - dst| id distance, the locality figure RCM lowers."""
    if len(src) == 0:
        return 0.0
    return float(np.mean(np.abs(np.asarray(src, np.int64)
                                - np.asarray(dst, np.int64))))


# ----------------------------------------------------------------------
# DropEdge mask (device side)
# ----------------------------------------------------------------------

def drop_edge_mask(generator: Optional[torch.Generator], graph,
                   rate: float) -> torch.Tensor:
    """Bernoulli(1 - rate) keep-mask over the padded edges, False on
    padding, drawn from ``generator`` (on the graph's device; None draws
    from the device's default generator): the static-shape form of DGL's
    ``DropEdge``. ``graph`` is a GraphBatch or a FastGraph. Rate 0 returns
    the edge mask. On one rank's run lo:hi of a whole graph's e edges (a
    graph with ``edge_run`` (lo, hi, e), ``parallel/full_graph.py``) the
    draw is made at the whole graph's e edges and the run kept, so each
    rank keeps the single-device mask's edges."""
    if rate <= 0.0:
        return graph.edge_mask
    run = getattr(graph, "edge_run", None)
    lo, hi, e = run if run is not None else (0, graph.e_pad, graph.e_pad)
    keep = torch.rand(e, generator=generator,
                      device=graph.device)[lo:hi] < 1.0 - rate
    return keep & graph.edge_mask
