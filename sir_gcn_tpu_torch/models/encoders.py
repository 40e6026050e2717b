"""OGB-compatible molecular feature encoders (port of
``sir_gcn_tpu/models/encoders.py``).

The reference uses ``ogb.graphproppred.mol_encoder.AtomEncoder`` and
``BondEncoder`` (``benchmark-datasets/ogbg-molhiv/model.py:7``): one
embedding table per categorical feature column, the embeddings summed.
The cardinalities are OGB's published ``get_atom_feature_dims()`` and
``get_bond_feature_dims()`` for the mol datasets.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import Embed

ATOM_FEATURE_DIMS = (119, 5, 12, 12, 10, 6, 6, 2, 2)
BOND_FEATURE_DIMS = (5, 6, 2)


class _SumEncoder(nn.Module):
    """Sum over the columns of ``feats`` [..., len(dims)] of each
    column's embedding."""

    dims: tuple = ()

    def __init__(self, embedding_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embeddings = nn.ModuleList(
            Embed(card, embedding_dim, generator=generator)
            for card in self.dims)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        out = 0.0
        for i, emb in enumerate(self.embeddings):
            out = out + emb(feats[..., i].long())
        return out


class AtomEncoder(_SumEncoder):
    dims = ATOM_FEATURE_DIMS


class BondEncoder(_SumEncoder):
    dims = BOND_FEATURE_DIMS
