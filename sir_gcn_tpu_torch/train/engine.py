"""Shared training engine (port of ``sir_gcn_tpu/train/engine.py``):
seeding, AdamW with an LR-scale slot, parameter count."""

from __future__ import annotations

import random

import numpy as np
import torch
from torch import nn


def set_seed(seed: int) -> None:
    """Seed the host RNGs and torch's default generators (reference
    ``train.py:14-24``). Init and dropout take explicit generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def make_adamw(params, lr: float, weight_decay: float = 0.0
               ) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` (betas 0.9/0.999, eps 1e-8, decoupled weight
    decay), which computes the update of the JAX package's optax chain.
    Each group keeps its base rate in ``base_lr`` for :func:`set_lr_scale`."""
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    for group in opt.param_groups:
        group["base_lr"] = group["lr"]
    return opt


def set_lr_scale(opt: torch.optim.Optimizer, scale: float) -> None:
    """Set every group's rate to ``base_lr * scale`` (warmup x plateau)."""
    for group in opt.param_groups:
        group["lr"] = group["base_lr"] * scale


def param_count(model: nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))
