"""ogbg-molhiv task models (port of ``experiments/ogbg_molhiv/model.py``;
reference ``benchmark-datasets/ogbg-molhiv/model.py``): AtomEncoder ->
SIRConv stack + norm + LeakyReLU(0.2) (+ identity residual) -> pooling ->
the EGC-style MLP readout [h, h/2, h/4, out] (model.py:50-86). The richer
commented variant's VirtualNode, CentralityEncoder, random features and
BondEncoder (model.py:89-150) sit behind flags. The GIN baseline has
GINEConv, BondEncoder and VirtualNode (model.py:153-212).

``nfeats_perturb`` is added to the atom embedding: FLAG's perturbation.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...models import (
    MLP,
    AtomEncoder,
    BondEncoder,
    CentralityEncoder,
    GINEConv,
    Linear,
    MaskedBatchNorm,
    SIRConv,
    SIREConv,
    VirtualNode,
    get_norm,
)
from ...models.layers import dropout as apply_dropout
from ...ops.pool import get_pool, sum_pool
from ..common_models import _edge_mask, leaky_relu02


class MLPEgc(nn.Module):
    """EGC-style MLP: BatchNorm, activation and dropout between layers, a
    plain last linear (reference molhiv model.py:13-46). ``widths`` are
    the layers' output widths."""

    def __init__(self, input_dim: int, widths: tuple, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        dims = (input_dim,) + tuple(widths)
        self.linears = nn.ModuleList(
            Linear(dims[i], dims[i + 1], generator=generator)
            for i in range(len(widths)))
        self.norms = nn.ModuleList(MaskedBatchNorm(w) for w in widths[:-1])

    def forward(self, feats: torch.Tensor,
                mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        for i, linear in enumerate(self.linears):
            feats = linear(feats)
            if i < len(self.norms):
                feats = leaky_relu02(self.norms[i](feats, mask))
                feats = apply_dropout(feats, self.dropout, self.training,
                                      generator)
        return feats


def _virtual_node(use_vn, hidden_dim, num_layers, vn_layers, vn_dropout,
                  vn_residual, generator) -> VirtualNode:
    """The VN hooks; the VN MLP exists where a layer after the first reads
    it, as in flax, which makes parameters only where they are used."""
    mod_emb = (MLP(hidden_dim, hidden_dim, hidden_dim, vn_layers, vn_dropout,
                   "none", leaky_relu02, include_last=False,
                   with_graph=True, generator=generator)
               if use_vn and num_layers > 1 else None)
    return VirtualNode(use_vn, hidden_dim, vn_residual, mod_emb=mod_emb,
                       mod_pool=sum_pool, generator=generator)


class SIRModel(nn.Module):
    """``readout_layers=0`` (default) keeps the active reference model's
    fixed EGC readout after pooling (model.py:70-71,86); above 0 it takes
    the richer variant's per-node readout MLPs, with
    ``jumping_knowledge`` one summed readout per layer, pooled after
    (model.py:126-149). ``resid_layers > 0`` replaces the identity
    residual with the richer variant's MLP residual (model.py:120)."""

    def __init__(self, hidden_dim: int, output_dim: int, num_layers: int = 1,
                 input_dropout: float = 0.0, edge_dropout: float = 0.0,
                 dropout: float = 0.0, norm: str = "none",
                 readout_layers: int = 0, readout_dropout: float = 0.0,
                 readout_pooling: str = "sum",
                 jumping_knowledge: bool = False,
                 virtual_node: bool = False, vn_layers: int = 0,
                 vn_dropout: float = 0.0, vn_residual: bool = False,
                 rand_feat: bool = False, max_degree: int = 0,
                 residual: bool = False, resid_layers: int = 0,
                 resid_dropout: float = 0.0, feat_dropout: float = 0.0,
                 agg_type: str = "sum", use_edge_feats: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h = hidden_dim
        self.input_dropout = input_dropout
        self.edge_dropout = edge_dropout
        self.dropout = dropout
        self.jumping_knowledge = jumping_knowledge
        self.virtual_node = virtual_node
        self.rand_feat = rand_feat
        self.residual = residual
        self.use_edge_feats = use_edge_feats
        self.pool = get_pool(readout_pooling)
        self.embedding = AtomEncoder(h, generator=generator)
        # the reference's commented variant: CentralityEncoder(..., 'in')
        # (model.py:105), in-degree only
        self.centrality = CentralityEncoder(max_degree, h, direction="in",
                                            generator=generator)
        self.vn = _virtual_node(virtual_node, h, num_layers, vn_layers,
                                vn_dropout, vn_residual, generator)
        self.resids = nn.ModuleList(
            MLP(h, h, h, resid_layers, resid_dropout, "none", leaky_relu02,
                include_last=False, with_graph=False, generator=generator)
            for _ in range(num_layers if residual and resid_layers else 0))
        self.convs = nn.ModuleList(
            SIREConv(h, 0, h, h, leaky_relu02, feat_dropout,
                     agg_type=agg_type,
                     edge_encoder=BondEncoder(h, generator=generator),
                     generator=generator)
            if use_edge_feats else
            SIRConv(h, h, h, leaky_relu02, feat_dropout, agg_type=agg_type,
                    generator=generator)
            for _ in range(num_layers))
        self.norms = nn.ModuleList(get_norm(norm, True, h)
                                   for _ in range(num_layers))
        if readout_layers > 0:
            self.readouts = nn.ModuleList(
                MLP(h, h, output_dim, readout_layers, readout_dropout,
                    "none", leaky_relu02, include_last=False,
                    with_graph=False, generator=generator)
                for _ in range(num_layers + 1 if jumping_knowledge else 1))
            self.readout = None
        else:
            self.readouts = None
            self.readout = MLPEgc(h, (h // 2, h // 4, output_dim),
                                  generator=generator)

    def forward(self, graph, nfeats: torch.Tensor,
                efeats: Optional[torch.Tensor] = None, nfeats_perturb=0.0, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.embedding(nfeats) + nfeats_perturb
        if self.rand_feat and self.training:
            # the commented variant, model.py:118-120: random features
            x = x + (torch.rand(x.shape, generator=generator,
                                device=x.device, dtype=x.dtype) * 2.0 - 1.0)
        x = self.centrality(graph, x)
        x = apply_dropout(x, self.input_dropout, self.training, generator)
        vnfeat = None
        xs = [x] if self.jumping_knowledge else []
        last = len(self.convs) - 1
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            if self.virtual_node:
                x, vnfeat = self.vn.node_emb(graph, x, vnfeat)
            emask = _edge_mask(self, graph, generator)
            resid = (self.resids[i](x, generator=generator)
                     if len(self.resids) else x)
            if self.use_edge_feats:
                x = conv(graph, x, efeats, edge_mask=emask,
                         generator=generator)
            else:
                x = conv(graph, x, edge_mask=emask, generator=generator)
            x = leaky_relu02(norm(graph, x))
            if self.residual:
                x = x + resid
            x = apply_dropout(x, self.dropout, self.training, generator)
            if self.jumping_knowledge:
                xs.append(x)
            if self.virtual_node and i < last:
                vnfeat = self.vn.vn_emb(graph, x, vnfeat,
                                        generator=generator)
        if self.readouts is not None:
            heads = xs if self.jumping_knowledge else [x]
            score = sum(readout(hd, generator=generator)
                        for readout, hd in zip(self.readouts, heads))
            return self.pool(graph, score)
        return self.readout(self.pool(graph, x), graph.graph_mask,
                            generator=generator)


class GINModel(nn.Module):
    """GIN baseline with GINEConv, BondEncoder and VirtualNode (reference
    model.py:153-212)."""

    def __init__(self, hidden_dim: int, output_dim: int, num_layers: int = 1,
                 input_dropout: float = 0.0, dropout: float = 0.0,
                 norm: str = "bn", readout_pooling: str = "mean",
                 virtual_node: bool = False, vn_layers: int = 2,
                 vn_dropout: float = 0.0, vn_residual: bool = False,
                 mlp_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h = hidden_dim
        self.input_dropout = input_dropout
        self.virtual_node = virtual_node
        self.pool = get_pool(readout_pooling)
        self.embedding = AtomEncoder(h, generator=generator)
        self.vn = _virtual_node(virtual_node, h, num_layers, vn_layers,
                                vn_dropout, vn_residual, generator)
        self.bonds = nn.ModuleList(BondEncoder(h, generator=generator)
                                   for _ in range(num_layers))
        self.mlps = nn.ModuleList(
            MLP(h, h, h, mlp_layers, dropout, norm, leaky_relu02,
                with_graph=True, generator=generator)
            for _ in range(num_layers))
        self.convs = nn.ModuleList(GINEConv(apply_func=lambda x: x)
                                   for _ in range(num_layers))
        self.readout = Linear(h, output_dim, generator=generator)

    def forward(self, graph, nfeats: torch.Tensor,
                efeats: Optional[torch.Tensor] = None, nfeats_perturb=0.0, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.embedding(nfeats) + nfeats_perturb
        x = apply_dropout(x, self.input_dropout, self.training, generator)
        vnfeat = None
        last = len(self.convs) - 1
        for i, (conv, bond, mlp) in enumerate(zip(self.convs, self.bonds,
                                                  self.mlps)):
            if self.virtual_node:
                x, vnfeat = self.vn.node_emb(graph, x, vnfeat)
            x = mlp(graph, conv(graph, x, bond(efeats)), generator=generator)
            if self.virtual_node and i < last:
                vnfeat = self.vn.vn_emb(graph, x, vnfeat,
                                        generator=generator)
        return self.readout(self.pool(graph, x))


MODELS = {"SIR": SIRModel, "GIN": GINModel}
