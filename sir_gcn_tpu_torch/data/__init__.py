from .batching import GraphCollection
from .loaders import (
    NodeClassificationData,
    load_node_classification,
    synthetic_node_classification,
)
from .synthetic import (
    DictionaryLookupDataset,
    HeteroEdgeCountDataset,
    powerlaw_edges,
)
