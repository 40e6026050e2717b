from . import message_passing
from .ell import FastGraph, build_fast_graph
from .message_passing import (
    copy_src_aggregate,
    get_edge_dtype,
    set_edge_dtype,
    sir_aggregate,
)
from .pool import avg_pool, get_pool, sum_pool
