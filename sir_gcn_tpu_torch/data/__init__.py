from .loaders import (
    NodeClassificationData,
    load_node_classification,
    synthetic_node_classification,
)
from .synthetic import powerlaw_edges
