"""Shared training engine (port of ``sir_gcn_tpu/train/engine.py``):
the device choice, seeding, AdamW with an LR-scale slot, parameter count,
the n-runs summary and the host-side epoch driver. The JAX package's
``TrainState`` has no counterpart: the model and its optimizer hold that
state."""

from __future__ import annotations

import random
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from .schedulers import ReduceLROnPlateau, warmup_scale


def resolve_device(cpu: bool) -> torch.device:
    """The CUDA card, or the CPU when asked for; never a silent fallback."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run "
                           "on the CPU")
    return torch.device("cuda")


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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


def l1_l2_regularizer(model: nn.Module, l1: float, l2: float):
    """Reference ``regularizer`` (``benchmark-datasets/ogbn-arxiv/
    train.py:66-69``): l1 * sum|w| + l2 * sum w^2 over every parameter;
    the float 0.0 when both are 0."""
    reg = 0.0
    if l1 > 0:
        reg = reg + l1 * sum(p.abs().sum() for p in model.parameters())
    if l2 > 0:
        reg = reg + l2 * sum(p.square().sum() for p in model.parameters())
    return reg


def param_count(model: nn.Module) -> int:
    """Parameters of ``model``, each shared one counted once."""
    return int(sum(p.numel() for p in model.parameters()))


def aggregate_runs(name: str, values: list[float]) -> tuple[float, float]:
    """n-runs mean ± std summary (reference ``train.py:295-300``)."""
    m, s = float(np.mean(values)), float(np.std(values))
    print(f"{name}: {values}")
    print(f"Average {name}: {m:.6f} ± {s:.6f}")
    return m, s


class EpochDriver:
    """Host-side epoch control: warmup, plateau scheduling, best-result
    selection and the log cadence, the ``run`` skeleton shared by the
    reference harnesses."""

    def __init__(self, *, epochs: int, warmup: int = 0, factor: float = 0.5,
                 patience: int = 10, log_every: int = 20,
                 better: Callable[[float, float], bool] = lambda a, b: a < b):
        self.epochs = epochs
        self.warmup = warmup
        self.plateau = ReduceLROnPlateau(factor=factor, patience=patience)
        self.log_every = log_every
        self.better = better
        self.best_metric: Optional[float] = None
        self.best_payload: Any = None

    def lr_scale(self, epoch: int) -> float:
        """The scale to train this epoch at, set before its steps: the
        reference sets the warmup LR at the top of each epoch
        (ogbn-arxiv train.py:189-190), so epoch 1 trains at lr / warmup."""
        return warmup_scale(epoch, self.warmup) * self.plateau.scale

    def plateau_step(self, epoch: int, metric: float) -> None:
        """Advance the plateau scheduler after this epoch's evaluation
        (train.py:193). In warmup the reference's warmup_lr overwrites the
        LR at the top of the next epoch, so a plateau reduction made in
        warmup never takes effect: the scale is reset."""
        self.plateau.step(metric)
        if epoch + 1 <= self.warmup:
            self.plateau.scale = 1.0

    def consider(self, metric: float, payload: Any) -> bool:
        """Keep ``payload`` if ``metric`` is the best so far."""
        if self.best_metric is None or self.better(metric, self.best_metric):
            self.best_metric = metric
            self.best_payload = payload
            return True
        return False

    def should_log(self, epoch: int) -> bool:
        return epoch == self.epochs or epoch % self.log_every == 0
