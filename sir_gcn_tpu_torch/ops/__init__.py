from . import message_passing
from .ell import FastGraph, build_fast_graph
from .message_passing import get_edge_dtype, set_edge_dtype, sir_aggregate
