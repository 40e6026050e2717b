"""Distribution (port of ``sir_gcn_tpu/parallel``): process groups and
meshes, data parallelism over batched graphs, the node-partitioned
full-graph SIR aggregates (all-gather and boundary-only halo exchange) on
the port's kernels, and the row-sharded full graph on the CSR aggregate
for every model. One process a rank; see ``multihost``."""

from .collectives import rank_sum, sum_gradients
from .data_parallel import (
    make_dp_train_step,
    make_dp_train_step_stateful,
    rank_batches,
)
from .ell_distributed import (
    ShardedFastGraph,
    build_sharded_fast_graph,
    make_sharded_sir_aggregate,
)
from .full_graph import NodeShard, ShardedGraph, shard_full_graph
from .halo import (
    HaloFastGraph,
    HaloGraph,
    build_halo_fast_graph,
    build_halo_graph,
    halo_sir_aggregate,
)
from .mesh import make_mesh
from .multihost import initialize_multihost, spawn_ranks
