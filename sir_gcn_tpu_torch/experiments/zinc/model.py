"""ZINC task models (port of ``experiments/zinc/model.py``; reference
``benchmark-datasets/zinc/model.py``): the SIR model with an atom-type
embedding, and with ``use_edge_feats`` the SIREConv2 path (a bond-type
embedding as W_E, model.py:12-15); the GIN baseline."""

from __future__ import annotations

from typing import Optional

import torch

from ...models import Embed
from ..common_models import GraphGINModel, GraphSIRModel


def make_sir_model(input_dim, edge_dim, hidden_dim, output_dim,
                   use_edge_feats=False,
                   generator: Optional[torch.Generator] = None, **kwargs):
    encoder = Embed(input_dim, hidden_dim, generator=generator)
    edge_encoder = None
    if use_edge_feats:
        def edge_encoder(i):
            return Embed(edge_dim, hidden_dim, generator=generator)

    return GraphSIRModel(encoder, hidden_dim, hidden_dim, output_dim,
                         edge_encoder=edge_encoder, generator=generator,
                         **kwargs)


def make_gin_model(input_dim, edge_dim, hidden_dim, output_dim,
                   generator: Optional[torch.Generator] = None, **kwargs):
    encoder = Embed(input_dim, hidden_dim, generator=generator)
    return GraphGINModel(encoder, hidden_dim, hidden_dim, output_dim,
                         generator=generator, **kwargs)
