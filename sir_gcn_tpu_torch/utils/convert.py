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

A flax ``kernel`` is [in, out] and a torch ``weight`` [out, in], so Dense
kernels are transposed (``linear_edge``'s [De, H] kernel is the weight
[H, De]); a max conv's ``relation_kernel`` and an ``embedding`` table keep
the JAX layout in both. A key that is missing or left over raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models import Embed, GraphBatchNorm, Linear, SIRConv, SIREConv


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


def _conv_slots(path, conv) -> dict:
    """flax path -> (torch tensor, transpose) for a SIRConv or SIREConv."""
    slots = {}
    for name in ("linear_query", "linear_key"):
        slots.update(_linear(path + (name,), getattr(conv, name)))
    if isinstance(conv, SIREConv):
        if conv.edge_encoder is None:
            slots.update(_linear(path + ("linear_edge",), conv.linear_edge))
        elif isinstance(conv.edge_encoder, Embed):
            slots.update(_embed(path + ("edge_encoder",), conv.edge_encoder))
        else:
            raise TypeError(f"no bridge for the edge encoder "
                            f"{type(conv.edge_encoder).__name__}")
    if conv.agg_type == "max":
        slots[path + ("relation_kernel",)] = (conv.relation_kernel, False)
        if conv.relation_bias is not None:
            slots[path + ("relation_bias",)] = (conv.relation_bias, False)
    else:
        slots.update(_linear(path + ("linear_relation",),
                             conv.linear_relation))
    return slots


def _sir_model_slots(model) -> dict:
    """flax path -> (torch tensor, transpose) for an ogbn-arxiv SIRModel."""
    slots = _linear(("params", "embedding"), model.embedding)
    for i, conv in enumerate(model.convs):
        slots.update(_conv_slots(("params", f"conv_{i}"), conv))
    for i, norm in enumerate(model.norms):
        if isinstance(norm, GraphBatchNorm):
            bn, node = norm.norm, (f"GraphBatchNorm_{i}", "MaskedBatchNorm_0")
            slots[("params",) + node + ("weight",)] = (bn.weight, False)
            slots[("params",) + node + ("bias",)] = (bn.bias, False)
            slots[("batch_stats",) + node + ("mean",)] = (bn.running_mean,
                                                          False)
            slots[("batch_stats",) + node + ("var",)] = (bn.running_var,
                                                         False)
    slots.update(_linear(("params", "readout"), model.readout))
    return slots


def _slots(model: nn.Module) -> dict:
    if isinstance(model, (SIRConv, SIREConv)):
        return _conv_slots(("params",), model)
    if isinstance(model, Embed):
        return _embed(("params",), model)
    return _sir_model_slots(model)


def load_jax_variables(model: nn.Module, variables: dict) -> None:
    """Copy the flax ``variables`` of a JAX ``SIRModel``, ``SIRConv``,
    ``SIREConv`` or ``Embed`` into its port ``model``, in place. A model
    with ``SIRModel``'s attribute names (``embedding``, ``convs``,
    ``norms``, ``readout``), such as the benchmark's SIREConv model, takes
    the ``SIRModel`` layout."""
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
