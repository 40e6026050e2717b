"""Tracing and step timing (port of ``sir_gcn_tpu/utils/profiling.py``):
``profile_trace`` records a ``torch.profiler`` trace of the CPU and, on a
card, of CUDA; ``StepTimer`` times steps on the host clock, each ending in
a device sync, so a step's time covers its device work."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def profile_trace(logdir: str, device: Optional[torch.device] = None):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA's
    when ``device`` is a card) and write a Chrome trace,
    ``logdir/trace.json``. Yields the profiler, whose ``key_averages()``
    give time by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Host-clock step timer that drops the first ``warmup`` steps. Each
    step ends in ``torch.cuda.synchronize`` on a CUDA ``device``, so its
    time includes the work it queued on the card.

        timer = StepTimer(device=device)
        for batch in batches:
            with timer:
                step(batch)
        timer.mean_ms
    """

    def __init__(self, warmup: int = 3,
                 device: Optional[torch.device] = None):
        self.warmup = warmup
        self.device = device
        self.times: list[float] = []
        self._t0 = None
        self._count = 0

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    @property
    def mean_ms(self) -> float:
        return 1e3 * sum(self.times) / max(len(self.times), 1)
