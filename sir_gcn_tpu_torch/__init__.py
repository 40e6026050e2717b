"""sir_gcn_tpu_torch — the PyTorch + CUDA port of ``sir_gcn_tpu``.

A second package beside the JAX one, for NVIDIA Hopper (sm_90a): the same
module names, PyTorch idiom inside, and hand-written CUDA kernels
(``csrc/``) where the JAX package has Pallas TPU kernels. It imports torch
and numpy, and nothing of JAX or of ``sir_gcn_tpu``.
"""

from .graph import (
    GraphBatch,
    add_self_loops,
    bandwidth,
    batch_graphs,
    build_graph,
    drop_edge_mask,
    permute_nodes,
    rcm_order,
    remove_self_loops,
    reverse_edges,
    to_bidirected,
)
from .ops.ell import FastGraph, build_fast_graph

__version__ = "0.1.0"
