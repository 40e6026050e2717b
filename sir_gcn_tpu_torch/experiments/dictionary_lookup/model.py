"""DictionaryLookup task models (port of
``experiments/dictionary_lookup/model.py``; reference
``synthetic-datasets/dictionary-lookup/model.py``).

``SIRModel``: key and value embeddings summed, a SIRConv stack whose σ is
the paper's MLP-augmented activation ReLU ∘ Linear ∘ ReLU (model.py:17),
one Linear shared by every layer (the reference's single
``self.activation``), then a bias-free classifier. The five baselines
(``_BaselineModel``): the embeddings summed, ReLU, the conv stack and the
bias-free classifier; all sit at or near chance on this task.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...models import (
    MLP,
    Embed,
    GATv2Conv,
    GINConv,
    GraphConv,
    Linear,
    PNAConv,
    SAGEConv,
    SIRConv,
)
from ...models.layers import dropout as apply_dropout


class MLPActivation(nn.Module):
    """σ(z) = ReLU(Linear(ReLU(z))), one module that every SIRConv of the
    model holds: ``parameters()`` yields its weights once."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = Linear(dim, dim, generator=generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.linear(torch.relu(z)))


class _Embeddings(nn.Module):
    """The key and value embeddings of (key_id, val_id) features, summed."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.key_embedding = Embed(input_dim + 1, hidden_dim,
                                   generator=generator)
        self.val_embedding = Embed(input_dim + 1, hidden_dim,
                                   generator=generator)

    def embed(self, feats: torch.Tensor) -> torch.Tensor:
        return (self.key_embedding(feats[:, 0])
                + self.val_embedding(feats[:, 1]))


class SIRModel(_Embeddings):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 1, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_dim, hidden_dim, generator)
        self.dropout = dropout
        self.activation = MLPActivation(hidden_dim, generator)
        self.convs = nn.ModuleList(
            SIRConv(hidden_dim, hidden_dim, hidden_dim, self.activation,
                    generator=generator)
            for _ in range(num_layers))
        self.classifier = Linear(hidden_dim, output_dim, bias=False,
                                 generator=generator)

    def forward(self, graph, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [N_pad, output_dim] from int features [N_pad, 2]."""
        x = self.embed(feats)
        for conv in self.convs:
            x = apply_dropout(conv(graph, x, generator=generator),
                              self.dropout, self.training, generator)
        return self.classifier(x)


class _BaselineModel(_Embeddings):
    """Embeddings, ReLU, the conv stack, the bias-free classifier
    (reference model.py:38-170); subclasses give the conv."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 1, dropout: float = 0.0,
                 num_heads: int = 1, mlp_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_dim, hidden_dim, generator)
        self.dropout = dropout
        self.convs = nn.ModuleList(
            self.conv(hidden_dim, num_heads, mlp_layers, generator)
            for _ in range(num_layers))
        self.classifier = Linear(hidden_dim, output_dim, bias=False,
                                 generator=generator)

    def conv(self, h, num_heads, mlp_layers, generator) -> nn.Module:
        raise NotImplementedError

    def post(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def forward(self, graph, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(self.embed(feats))
        for conv in self.convs:
            x = apply_dropout(self.post(conv(graph, x)), self.dropout,
                              self.training, generator)
        return self.classifier(x)


class GCNModel(_BaselineModel):
    def conv(self, h, num_heads, mlp_layers, generator):
        return GraphConv(h, h, generator=generator)


class SAGEModel(_BaselineModel):
    def conv(self, h, num_heads, mlp_layers, generator):
        return SAGEConv(h, h, generator=generator)


class GATModel(_BaselineModel):
    def conv(self, h, num_heads, mlp_layers, generator):
        return GATv2Conv(h, h, num_heads, generator=generator)

    def post(self, x):
        return x.mean(1)  # the mean over heads (reference model.py:112)


class GINModel(_BaselineModel):
    def conv(self, h, num_heads, mlp_layers, generator):
        return GINConv(MLP(h, h, h, mlp_layers, 0.0, "none", torch.relu,
                           include_last=True, with_graph=False,
                           generator=generator))


class PNAModel(_BaselineModel):
    def conv(self, h, num_heads, mlp_layers, generator):
        return PNAConv(h, h, generator=generator)


MODELS = {"SIR": SIRModel, "GCN": GCNModel, "SAGE": SAGEModel,
          "GAT": GATModel, "GIN": GINModel, "PNA": PNAModel}
