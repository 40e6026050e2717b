"""Hand-written CUDA kernels of the ELL fast path (port of
``sir_gcn_tpu/ops/pallas``). ``on_cuda`` takes the place of
``pallas_available``: tensors on a CUDA device take the kernels."""

from .kernels import (
    LAUNCHES,
    ell_act_reduce,
    ell_act_reduce2,
    ell_act_reduce2_edge,
    ell_act_reduce_edge,
    ell_act_reduce_plain,
    ell_edge_act_reduce2,
    ell_edge_act_reduce2_plain,
    ell_edge_src_bwd,
    ell_edge_src_bwd_plain,
    ell_max_bwd,
    ell_max_bwd_plain,
    ell_max_fwd,
    ell_max_fwd_plain,
    ell_max_wincount,
    ell_max_wincount_plain,
    ell_scaled_reduce,
    ell_scaled_reduce_plain,
    ell_src_bwd,
    ell_src_bwd_edge,
    ell_src_bwd_plain,
    on_cuda,
    reset_launch_counts,
)
