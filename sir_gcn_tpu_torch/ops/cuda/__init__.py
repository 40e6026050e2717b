"""Hand-written CUDA kernels of the ELL fast path (port of
``sir_gcn_tpu/ops/pallas``) and of the timing lab (``lab``, port of the
Pallas kernels of ``tools/kernel_lab.py`` and ``tools/gather_dma.py``).
``on_cuda`` takes the place of ``pallas_available``: tensors on a CUDA
device take the kernels."""

from .kernels import (
    LAUNCHES,
    ell_act_reduce,
    ell_act_reduce2,
    ell_act_reduce2_edge,
    ell_act_reduce_bwd,
    ell_act_reduce_bwd_plain,
    ell_act_reduce_edge,
    ell_act_reduce_plain,
    ell_act_reduce_rowwise,
    ell_edge_act_reduce2,
    ell_edge_act_reduce2_plain,
    ell_edge_src_bwd,
    ell_edge_src_bwd_plain,
    ell_geq_reduce,
    ell_geq_reduce_plain,
    ell_layout,
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
    ell_src_bwd_fused,
    ell_src_bwd_fused_plain,
    ell_src_bwd_plain,
    ell_src_bwd_rowwise,
    on_cuda,
    reset_launch_counts,
)
from .lab import (
    lab_copy,
    lab_copy32,
    lab_gather,
    lab_pass,
    lab_pass2,
    lab_tile_sum,
    lab_v1,
    lab_v2,
    lab_v3,
    lab_v4,
    lab_v5,
    lab_v6,
)
