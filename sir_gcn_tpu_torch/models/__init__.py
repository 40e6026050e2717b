from .conv import SIRConv, SIRConvBase, SIREConv, SIREConvBase, expand_as_pair
from .encoders import AtomEncoder, BondEncoder
from .layers import Embed, Linear, dropout
from .norm import (
    ContraNorm,
    GraphBatchNorm,
    GraphContraNorm,
    GraphIdentity,
    GraphLayerNorm,
    GraphNorm,
    Identity,
    LayerNorm,
    MaskedBatchNorm,
    get_norm,
)
from .utils import MLP, CentralityEncoder, VirtualNode
from .zoo import (
    GATv2Conv,
    GINConv,
    GINEConv,
    GraphConv,
    PNAConv,
    SAGEConv,
    pna_delta,
)
