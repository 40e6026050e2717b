from .conv import SIRConv, expand_as_pair
from .layers import Linear, dropout
from .norm import GraphBatchNorm, GraphIdentity, MaskedBatchNorm, get_norm
