"""Hand-written CUDA kernels of the ELL fast path (port of
``sir_gcn_tpu/ops/pallas``). ``on_cuda`` takes the place of
``pallas_available``: tensors on a CUDA device take the kernels."""

from .kernels import (
    LAUNCHES,
    ell_act_reduce,
    ell_act_reduce2,
    ell_act_reduce_plain,
    ell_src_bwd,
    ell_src_bwd_plain,
    on_cuda,
    reset_launch_counts,
)
