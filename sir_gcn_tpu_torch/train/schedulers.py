"""LR schedule utilities (port of ``sir_gcn_tpu/train/schedulers.py``):
linear warmup and torch-style ReduceLROnPlateau, both as LR scales."""

from __future__ import annotations


def warmup_scale(epoch: int, warmup: int) -> float:
    """Linear warmup multiplier for epoch (1-indexed like the reference)."""
    if warmup <= 0:
        return 1.0
    return min(1.0, epoch / warmup)


class ReduceLROnPlateau:
    """Host-side plateau scheduler producing an LR scale (mode 'min',
    relative threshold, as ``torch.optim.lr_scheduler.ReduceLROnPlateau``
    in the reference harnesses)."""

    def __init__(self, factor: float = 0.5, patience: int = 10,
                 threshold: float = 1e-4, min_scale: float = 0.0):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_scale = min_scale
        self.best = float("inf")
        self.num_bad = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.num_bad = 0
        return self.scale
