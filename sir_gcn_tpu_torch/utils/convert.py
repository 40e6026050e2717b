"""Weight bridge: fill a port model from the JAX package's flax variables.

The flax variable tree arrives as nested dicts of NumPy arrays. For the
ogbn-arxiv ``SIRModel`` it holds

    params/embedding/Dense_0/{kernel,bias}
    params/conv_i/linear_{query,relation}/Dense_0/{kernel,bias}
    params/conv_i/linear_key/Dense_0/kernel
    params/conv_i/relation_{kernel,bias}     (max convs, instead of
                                              linear_relation)
    params/GraphBatchNorm_i/MaskedBatchNorm_0/{weight,bias}
    batch_stats/GraphBatchNorm_i/MaskedBatchNorm_0/{mean,var}
    params/readout/Dense_0/{kernel,bias}

A ``SIRConv`` or ``SIREConv`` on its own holds its conv's keys under
``params/``; a ``SIREConv`` adds

    params/linear_edge/Dense_0/kernel        [De, H] (the default W_E)
    params/edge_encoder/embedding            [T, H]  (an ``Embed`` encoder,
                                                      instead of linear_edge)

and an ``Embed`` on its own holds ``params/embedding``.

The zoo convs hold, under ``params/`` on their own or under
``params/conv_i/`` in a model,

    GraphConv    weight/Dense_0/kernel, bias
    GATv2Conv    fc_src/Dense_0, fc_dst/Dense_0 (share_weights=False),
                 res_fc/Dense_0 (a projected residual), attn [H, F]
    SAGEConv     fc_pool/Dense_0, fc_self/Dense_0/kernel, fc_neigh/Dense_0
    PNAConv      M/Dense_0, U/Dense_0 (one tower), or M_t, U_t and
                 mixing/Dense_0 (towers t)
    GINConv      eps (learn_eps), apply_func/... (an MLP given as the
    GINEConv     apply function, on its own)

and an ``MLP`` ``linear_j/Dense_0`` with, for norm 'bn',
``{GraphBatchNorm_j/MaskedBatchNorm_0 | MaskedBatchNorm_j}/{weight,bias}``
and their ``batch_stats`` ``mean`` and ``var``.

The DictionaryLookup models hold ``params/{key,val}_embedding/embedding``,
``params/conv_i/...`` and ``params/classifier/Dense_0/kernel``; SIR adds
the shared σ's ``params/activation_linear/Dense_0`` (filled once). The
HeteroEdgeCount models hold ``params/embedding/embedding``,
``params/conv_i/...`` and ``params/regression/Dense_0/kernel``. A GIN
model's MLPs are the model's own, ``params/mlp_i/...``, beside a
parameter-free ``conv_i``.

The norms sit under their class's flax name with the index of their
layer (``GraphNorm_i``, ``GraphContraNorm_i/ContraNorm_0/norm``,
``GraphBatchNorm_i/MaskedBatchNorm_0``,
``GraphLayerNorm_i/LayerNorm_0/LayerNorm_0``; without a graph
``ContraNorm_j/norm``, ``MaskedBatchNorm_j``, ``LayerNorm_j/LayerNorm_0``):
GraphNorm holds ``weight``, ``bias`` and ``mean_scale``, each BatchNorm
``weight``, ``bias`` and the ``batch_stats`` ``mean`` and ``var``, flax's
LayerNorm ``scale`` (the torch ``weight``) and ``bias``.

With the label trick the arxiv models' input is the features and the
one-hot labels, D + C wide: build the port model with that ``input_dim``
and its ``embedding`` (SIR) or first conv (GAT) takes the [D + C, H]
kernels as any other width. The ogbn-arxiv SIRModel with jumping
knowledge holds ``readout_i``
MLPs (the input features' head first) instead of ``readout``, and with
MLP residuals ``resid_i``; its GATModel holds ``conv_i`` (GATv2Conv), the
norms and the readouts. The heterophilous SIRModel holds
``input_linear``, ``conv_i``, ``linear_i``, the norms (``{class}_j``, the
last after the blocks) and ``output_linear``.

The batched-graph models (``experiments/common_models.py``) hold
``node_encoder/embedding`` (an ``Embed`` encoder), ``resid_i``,
``conv_i`` (SIREConv's edge encoder ``conv_i/edge_encoder_i``), the
norms, ``comb_i`` (GIN's MLPs) and ``readout_i``. The molhiv models hold
``embedding/embedding_k/embedding`` (AtomEncoder),
``centrality/encoder_{in,out}/embedding``, ``vn/init_emb/embedding``,
``vn_mlp``, ``conv_i`` (with ``conv_i/bond_i/embedding_k`` for its
BondEncoder), ``bond_i`` and ``mlp_i`` (GIN), and ``readout`` (the
MLPEgc's ``linear_k`` and BatchNorms ``norm_k``, or GIN's Linear) or
``readout_i``.

A flax ``kernel`` is [in, out] and a torch ``weight`` [out, in], so Dense
kernels are transposed (``linear_edge``'s [De, H] kernel is the weight
[H, De]); a max conv's ``relation_kernel`` and an ``embedding`` table keep
the JAX layout in both. A key that is missing or left over raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models import (
    MLP,
    AtomEncoder,
    BondEncoder,
    CentralityEncoder,
    ContraNorm,
    Embed,
    GATv2Conv,
    GINConv,
    GINEConv,
    GraphBatchNorm,
    GraphContraNorm,
    GraphConv,
    GraphIdentity,
    GraphLayerNorm,
    GraphNorm,
    Identity,
    LayerNorm,
    Linear,
    MaskedBatchNorm,
    PNAConv,
    SAGEConv,
    SIRConv,
    SIREConv,
    VirtualNode,
)
from ..models.encoders import _SumEncoder


def _flatten(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _linear(path, mod: Linear) -> dict:
    slots = {path + ("Dense_0", "kernel"): (mod.weight, True)}
    if mod.bias is not None:
        slots[path + ("Dense_0", "bias")] = (mod.bias, False)
    return slots


def _embed(path, mod: Embed) -> dict:
    return {path + ("embedding",): (mod.embedding, False)}


def _sum_encoder(path, enc: _SumEncoder) -> dict:
    """An AtomEncoder or BondEncoder: one table per feature column."""
    slots = {}
    for k, emb in enumerate(enc.embeddings):
        slots.update(_embed(path + (f"embedding_{k}",), emb))
    return slots


def _conv_slots(path, conv, edge_name: str = "edge_encoder") -> dict:
    """flax path -> (torch tensor, transpose) for a SIRConv or SIREConv;
    a SIREConv's edge encoder (an ``Embed`` or a ``BondEncoder``) under
    ``edge_name``."""
    slots = {}
    for name in ("linear_query", "linear_key"):
        slots.update(_linear(path + (name,), getattr(conv, name)))
    if isinstance(conv, SIREConv):
        enc = conv.edge_encoder
        if enc is None:
            slots.update(_linear(path + ("linear_edge",), conv.linear_edge))
        elif isinstance(enc, Embed):
            slots.update(_embed(path + (edge_name,), enc))
        elif isinstance(enc, _SumEncoder):
            slots.update(_sum_encoder(path + (edge_name,), enc))
        else:
            raise TypeError(f"no bridge for the edge encoder "
                            f"{type(enc).__name__}")
    if conv.agg_type == "max":
        slots[path + ("relation_kernel",)] = (conv.relation_kernel, False)
        if conv.relation_bias is not None:
            slots[path + ("relation_bias",)] = (conv.relation_bias, False)
    else:
        slots.update(_linear(path + ("linear_relation",),
                             conv.linear_relation))
    return slots


def _batch_norm(params, stats, bn: MaskedBatchNorm) -> dict:
    return {params + ("weight",): (bn.weight, False),
            params + ("bias",): (bn.bias, False),
            stats + ("mean",): (bn.running_mean, False),
            stats + ("var",): (bn.running_var, False)}


def _norm_slots(path, norm) -> dict:
    """flax path -> (torch tensor, transpose) for a norm whose own flax
    path is ``path`` = ("params", ...)."""
    stats = ("batch_stats",) + path[1:]
    if isinstance(norm, GraphNorm):
        slots = {path + ("weight",): (norm.weight, False)}
        for name in ("bias", "mean_scale"):
            if getattr(norm, name) is not None:
                slots[path + (name,)] = (getattr(norm, name), False)
        return slots
    if isinstance(norm, MaskedBatchNorm):
        return _batch_norm(path, stats, norm)
    if isinstance(norm, LayerNorm):
        node = path + ("LayerNorm_0",)
        return {node + ("scale",): (norm.weight, False),
                node + ("bias",): (norm.bias, False)}
    inner = {GraphBatchNorm: "MaskedBatchNorm_0", ContraNorm: "norm",
             GraphContraNorm: "ContraNorm_0", GraphLayerNorm: "LayerNorm_0"}
    if type(norm) in inner:
        return _norm_slots(path + (inner[type(norm)],), norm.norm)
    if isinstance(norm, (Identity, GraphIdentity)):
        return {}
    raise TypeError(f"no bridge for the norm {type(norm).__name__}")


def _named_norm(path, j: int, norm) -> dict:
    """A norm made in a flax compact method, as ``{class name}_{j}``."""
    return _norm_slots(path + (f"{type(norm).__name__}_{j}",), norm)


def _mlp_slots(path, mlp: MLP) -> dict:
    """``path`` = ("params", ...) of an MLP."""
    slots = {}
    for j, linear in enumerate(mlp.linears):
        slots.update(_linear(path + (f"linear_{j}",), linear))
    for j, norm in enumerate(mlp.norms):
        slots.update(_named_norm(path, j, norm))
    return slots


def _zoo_slots(path, conv) -> dict:
    """flax path -> (torch tensor, transpose) for a zoo conv."""
    slots = {}
    if isinstance(conv, GraphConv):
        slots.update(_linear(path + ("weight",), conv.linear))
        if conv.bias is not None:
            slots[path + ("bias",)] = (conv.bias, False)
    elif isinstance(conv, GATv2Conv):
        for name in ("fc_src", "fc_dst", "res_fc"):
            if getattr(conv, name) is not None:
                slots.update(_linear(path + (name,), getattr(conv, name)))
        slots[path + ("attn",)] = (conv.attn, False)
    elif isinstance(conv, SAGEConv):
        for name in ("fc_pool", "fc_self", "fc_neigh"):
            slots.update(_linear(path + (name,), getattr(conv, name)))
    elif isinstance(conv, PNAConv):
        one = conv.num_towers == 1
        for t in range(conv.num_towers):
            slots.update(_linear(path + ("M" if one else f"M_{t}",),
                                 conv.M[t]))
            slots.update(_linear(path + ("U" if one else f"U_{t}",),
                                 conv.U[t]))
        if conv.mixing is not None:
            slots.update(_linear(path + ("mixing",), conv.mixing))
    elif isinstance(conv, (GINConv, GINEConv)):
        if isinstance(conv.eps, nn.Parameter):
            slots[path + ("eps",)] = (conv.eps, False)
        if isinstance(conv.apply_func, MLP):
            slots.update(_mlp_slots(path + ("apply_func",),
                                    conv.apply_func))
        elif isinstance(conv.apply_func, nn.Module):
            raise TypeError(f"no bridge for the apply function "
                            f"{type(conv.apply_func).__name__}")
    else:
        raise TypeError(f"no bridge for {type(conv).__name__}")
    return slots


def _harness_slots(model, embeddings: tuple, head: str) -> dict:
    """flax path -> (torch tensor, transpose) for a DictionaryLookup or
    HeteroEdgeCount model."""
    slots = {}
    for name in embeddings:
        slots.update(_embed(("params", name), getattr(model, name)))
    sigma = getattr(model, "activation", None)
    if sigma is not None:  # DictionaryLookup SIR's shared σ-MLP
        slots.update(_linear(("params", "activation_linear"), sigma.linear))
    for i, conv in enumerate(model.convs):
        if isinstance(conv, (SIRConv, SIREConv)):
            slots.update(_conv_slots(("params", f"conv_{i}"), conv))
        elif isinstance(conv, GINConv):
            slots.update(_mlp_slots(("params", f"mlp_{i}"), conv.apply_func))
        else:
            slots.update(_zoo_slots(("params", f"conv_{i}"), conv))
    slots.update(_linear(("params", head), getattr(model, head)))
    return slots


def _readout_slots(model) -> dict:
    """The jumping-knowledge readouts ``readout_i`` of an ogbn-arxiv model,
    or its linear ``readout``."""
    p = ("params",)
    if getattr(model, "jumping_knowledge", False):
        slots = {}
        for i, mlp in enumerate(model.readouts):
            slots.update(_mlp_slots(p + (f"readout_{i}",), mlp))
        return slots
    return _linear(p + ("readout",), model.readout)


def _sir_model_slots(model) -> dict:
    """flax path -> (torch tensor, transpose) for an ogbn-arxiv SIRModel."""
    slots = _linear(("params", "embedding"), model.embedding)
    for i, mlp in enumerate(getattr(model, "resids", ())):
        slots.update(_mlp_slots(("params", f"resid_{i}"), mlp))
    for i, conv in enumerate(model.convs):
        slots.update(_conv_slots(("params", f"conv_{i}"), conv))
    for i, norm in enumerate(model.norms):
        slots.update(_named_norm(("params",), i, norm))
    slots.update(_readout_slots(model))
    return slots


def _gat_model_slots(model) -> dict:
    """flax path -> (torch tensor, transpose) for the ogbn-arxiv
    GATModel."""
    slots = {}
    for i, (conv, norm) in enumerate(zip(model.convs, model.norms)):
        slots.update(_zoo_slots(("params", f"conv_{i}"), conv))
        slots.update(_named_norm(("params",), i, norm))
    slots.update(_readout_slots(model))
    return slots


def _hetero_model_slots(model) -> dict:
    """flax path -> (torch tensor, transpose) for the heterophilous
    SIRModel: ``input_linear``, ``conv_i``, ``linear_i``,
    ``output_linear`` and the norms, the last one after the blocks."""
    p = ("params",)
    slots = _linear(p + ("input_linear",), model.input_linear)
    for i, (conv, linear) in enumerate(zip(model.convs, model.linears)):
        slots.update(_conv_slots(p + (f"conv_{i}",), conv))
        slots.update(_linear(p + (f"linear_{i}",), linear))
    for j, norm in enumerate(model.norms):
        slots.update(_named_norm(p, j, norm))
    slots.update(_linear(p + ("output_linear",), model.output_linear))
    return slots


def _graph_model_slots(model) -> dict:
    """flax path -> (torch tensor, transpose) for a GraphSIRModel,
    GraphGINModel or GraphGATModel."""
    from ..experiments.common_models import GraphGINModel

    p = ("params",)
    slots = {}
    if isinstance(model.encoder, Embed):
        slots.update(_embed(p + ("node_encoder",), model.encoder))
    for i, mlp in enumerate(getattr(model, "resids", ())):
        slots.update(_mlp_slots(p + (f"resid_{i}",), mlp))
    if isinstance(model, GraphGINModel):
        for i, comb in enumerate(model.combs):
            slots.update(_mlp_slots(p + (f"comb_{i}",), comb))
    else:
        for i, (conv, norm) in enumerate(zip(model.convs, model.norms)):
            if isinstance(conv, GATv2Conv):
                slots.update(_zoo_slots(p + (f"conv_{i}",), conv))
            else:
                slots.update(_conv_slots(p + (f"conv_{i}",), conv,
                                         f"edge_encoder_{i}"))
            slots.update(_named_norm(p, i, norm))
    for i, mlp in enumerate(model.readouts):
        slots.update(_mlp_slots(p + (f"readout_{i}",), mlp))
    return slots


def _vn_slots(vn: VirtualNode, path, mlp_path) -> dict:
    """A VirtualNode at ``path``, its MLP at ``mlp_path``."""
    slots = {}
    if vn.init_emb is not None:
        slots.update(_embed(path + ("init_emb",), vn.init_emb))
    if vn.mod_emb is not None:
        slots.update(_mlp_slots(mlp_path, vn.mod_emb))
    return slots


def _molhiv_slots(model) -> dict:
    """flax path -> (torch tensor, transpose) for the molhiv SIRModel or
    GINModel."""
    from ..experiments.ogbg_molhiv.model import GINModel

    p = ("params",)
    slots = _sum_encoder(p + ("embedding",), model.embedding)
    slots.update(_vn_slots(model.vn, p + ("vn",), p + ("vn_mlp",)))
    if isinstance(model, GINModel):
        for i, (bond, mlp) in enumerate(zip(model.bonds, model.mlps)):
            slots.update(_sum_encoder(p + (f"bond_{i}",), bond))
            slots.update(_mlp_slots(p + (f"mlp_{i}",), mlp))
        slots.update(_linear(p + ("readout",), model.readout))
        return slots
    for name in ("encoder_in", "encoder_out"):
        enc = getattr(model.centrality, name)
        if enc is not None:
            slots.update(_embed(p + ("centrality", name), enc))
    for i, mlp in enumerate(model.resids):
        slots.update(_mlp_slots(p + (f"resid_{i}",), mlp))
    for i, (conv, norm) in enumerate(zip(model.convs, model.norms)):
        slots.update(_conv_slots(p + (f"conv_{i}",), conv, f"bond_{i}"))
        slots.update(_named_norm(p, i, norm))
    if model.readouts is not None:
        for i, mlp in enumerate(model.readouts):
            slots.update(_mlp_slots(p + (f"readout_{i}",), mlp))
    else:
        slots.update(_egc_slots(p + ("readout",), model.readout))
    return slots


def _egc_slots(path, egc) -> dict:
    """An MLPEgc: ``linear_k`` and the BatchNorms ``norm_k``."""
    slots = {}
    for k, linear in enumerate(egc.linears):
        slots.update(_linear(path + (f"linear_{k}",), linear))
    for k, bn in enumerate(egc.norms):
        slots.update(_norm_slots(path + (f"norm_{k}",), bn))
    return slots


def _slots(model: nn.Module) -> dict:
    from ..experiments import common_models
    from ..experiments.heterophilous import model as hetero
    from ..experiments.ogbg_molhiv import model as molhiv
    from ..experiments.ogbn_arxiv import model as arxiv

    p = ("params",)
    if isinstance(model, hetero.SIRModel):
        return _hetero_model_slots(model)
    if isinstance(model, arxiv.GATModel):
        return _gat_model_slots(model)
    if isinstance(model, (common_models.GraphSIRModel,
                          common_models.GraphGINModel,
                          common_models.GraphGATModel)):
        return _graph_model_slots(model)
    if isinstance(model, (molhiv.SIRModel, molhiv.GINModel)):
        return _molhiv_slots(model)
    if isinstance(model, molhiv.MLPEgc):
        return _egc_slots(p, model)
    if isinstance(model, VirtualNode):
        return _vn_slots(model, p, p + ("mod_emb",))
    if isinstance(model, CentralityEncoder):
        return {k: v for name in ("encoder_in", "encoder_out")
                if getattr(model, name) is not None
                for k, v in _embed(p + (name,), getattr(model, name)).items()}
    if isinstance(model, (AtomEncoder, BondEncoder)):
        return _sum_encoder(p, model)
    if isinstance(model, (GraphNorm, MaskedBatchNorm, LayerNorm, ContraNorm,
                          GraphBatchNorm, GraphContraNorm, GraphLayerNorm,
                          Identity, GraphIdentity)):
        return _norm_slots(p, model)
    if isinstance(model, (SIRConv, SIREConv)):
        return _conv_slots(("params",), model)
    if isinstance(model, Embed):
        return _embed(("params",), model)
    if isinstance(model, MLP):
        return _mlp_slots(("params",), model)
    if isinstance(model, (GraphConv, GATv2Conv, SAGEConv, PNAConv, GINConv,
                          GINEConv)):
        return _zoo_slots(("params",), model)
    if hasattr(model, "key_embedding"):
        return _harness_slots(model, ("key_embedding", "val_embedding"),
                              "classifier")
    if isinstance(getattr(model, "embedding", None), Embed):
        return _harness_slots(model, ("embedding",), "regression")
    return _sir_model_slots(model)


def load_jax_variables(model: nn.Module, variables: dict) -> None:
    """Copy the flax ``variables`` of a JAX model or layer into its port
    ``model``, in place: the ogbn-arxiv ``SIRModel`` (with its
    jumping-knowledge readouts and MLP residuals) and ``GATModel``, the
    heterophilous ``SIRModel``, the twelve
    DictionaryLookup and HeteroEdgeCount models, the batched-graph
    models (``GraphSIRModel``, ``GraphGINModel``, ``GraphGATModel``), the
    molhiv ``SIRModel``, ``GINModel`` and ``MLPEgc``, ``SIRConv``,
    ``SIREConv``, a zoo conv, ``MLP``, a norm, ``VirtualNode`` (its MLP
    as ``mod_emb``), ``CentralityEncoder``, ``AtomEncoder``,
    ``BondEncoder`` or ``Embed``. A model with the
    arxiv ``SIRModel``'s attribute names (``embedding`` a ``Linear``,
    ``convs``, ``norms``, ``readout``), such as the benchmark's SIREConv
    model, takes that layout."""
    slots = _slots(model)
    given = _flatten(variables)
    missing = sorted("/".join(k) for k in slots.keys() - given.keys())
    extra = sorted("/".join(k) for k in given.keys() - slots.keys())
    if missing or extra:
        raise KeyError(f"flax variables do not match the model: missing "
                       f"{missing}, left over {extra}")
    with torch.no_grad():
        for key, (tensor, transpose) in slots.items():
            value = np.asarray(given[key], np.float32)
            if transpose:
                value = value.T
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f"{'/'.join(key)} has shape {value.shape}, "
                                 f"the model expects {tuple(tensor.shape)}")
            tensor.copy_(torch.tensor(value))
