from .batching import GraphCollection
from .loaders import (
    NodeClassificationData,
    has_cache,
    load_graph_cache,
    load_node_classification,
    synthetic_molecules,
    synthetic_node_classification,
    synthetic_ogb_molecules,
)
from .prefetch import prefetch
from .synthetic import (
    DictionaryLookupDataset,
    HeteroEdgeCountDataset,
    powerlaw_edges,
)
