from .conv import SIRConv, SIREConv, expand_as_pair
from .layers import Embed, Linear, dropout
from .norm import GraphBatchNorm, GraphIdentity, MaskedBatchNorm, get_norm
