from .conv import SIRConv, SIREConv, expand_as_pair
from .layers import Embed, Linear, dropout
from .norm import GraphBatchNorm, GraphIdentity, MaskedBatchNorm, get_norm
from .utils import MLP
from .zoo import (
    GATv2Conv,
    GINConv,
    GINEConv,
    GraphConv,
    PNAConv,
    SAGEConv,
    pna_delta,
)
