"""Checkpoint / resume (port of ``sir_gcn_tpu/utils/checkpoint.py``).

The reference keeps no model checkpoint (SURVEY §5); the JAX package
saves orbax checkpoints of its train state. The port writes one
``torch.save`` file per step, ``step_<n>.pt`` under the run's directory,
atomically: a temporary file in the same directory, then ``os.replace``,
so a run cut while saving leaves the last complete step readable. A
payload holds tensors, numbers, strings and their containers (a model's
and an optimizer's ``state_dict``, a generator's state), so it loads with
``weights_only=True``.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional

import torch

_NAME = re.compile(r"step_(\d+)\.pt")


def _file(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step}.pt")


def save_checkpoint(path: str, payload: Any, step: int = 0) -> str:
    """Save ``payload`` as step ``step`` under the directory ``path``
    (made if missing); returns the directory's absolute path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, _file(path, step))
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def load_checkpoint(path: str, step: Optional[int] = None) -> Any:
    """The payload saved as ``step`` (the latest if None) under ``path``,
    its tensors on the CPU."""
    path = os.path.abspath(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    return torch.load(_file(path, step), map_location="cpu",
                      weights_only=True)


def latest_step(path: str) -> Optional[int]:
    """The latest saved step under ``path``, or None if there is none."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.fullmatch, os.listdir(path))
             if m]
    return max(steps, default=None)
