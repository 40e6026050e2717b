"""Weight bridge: fill a port model from the JAX package's flax variables.

The flax variable tree arrives as nested dicts of NumPy arrays. For the
ogbn-arxiv ``SIRModel`` it holds

    params/embedding/Dense_0/{kernel,bias}
    params/conv_i/linear_{query,relation}/Dense_0/{kernel,bias}
    params/conv_i/linear_key/Dense_0/kernel
    params/GraphBatchNorm_i/MaskedBatchNorm_0/{weight,bias}
    batch_stats/GraphBatchNorm_i/MaskedBatchNorm_0/{mean,var}
    params/readout/Dense_0/{kernel,bias}

A flax ``kernel`` is [in, out] and a torch ``weight`` [out, in], so kernels
are transposed. A key that is missing or left over raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models import GraphBatchNorm, Linear


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


def _sir_model_slots(model) -> dict:
    """flax path -> (torch tensor, transpose) for an ogbn-arxiv SIRModel."""
    slots = _linear(("params", "embedding"), model.embedding)
    for i, conv in enumerate(model.convs):
        for name in ("linear_query", "linear_key", "linear_relation"):
            slots.update(_linear(("params", f"conv_{i}", name),
                                 getattr(conv, name)))
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


def load_jax_variables(model: nn.Module, variables: dict) -> None:
    """Copy the flax ``variables`` of the JAX ``SIRModel`` into ``model``
    (the port's ogbn-arxiv ``SIRModel``), in place."""
    slots = _sir_model_slots(model)
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
