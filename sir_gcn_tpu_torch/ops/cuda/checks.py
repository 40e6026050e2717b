"""What a comparison of two computations of a kernel's output leaves out:
the centered_relu gates that two summation orders may set on either side
of the relu. ``chip_smoke.py`` holds the kernels to their plain versions
with it, ``tools/ell_ab.py`` one build to another."""

from __future__ import annotations

import torch

# (slot, feature) whose centered_relu gate m = z - alpha * mean(z) lies
# within this of 0 (relative to 1 + |alpha * mean|) may take the other side
# of the relu in two computations that sum the mean in another order, which
# moves m by about 1e-8
NEAR_GATE = 1e-5


def near_gate(z: torch.Tensor, scale: torch.Tensor, act) -> torch.Tensor:
    """[S, H] bool: the (slot, feature) of a valid slot (``scale`` not 0)
    whose centered_relu gate, at the slot values ``z`` [S, H] f32, lies
    within ``NEAR_GATE`` of 0."""
    c = act.param * (z.sum(-1, keepdim=True) / z.shape[1])
    return ((z - c).abs() <= NEAR_GATE * (1 + c.abs())) & (scale != 0)[:, None]


def slot_rows(plan, slots: torch.Tensor) -> torch.Tensor:
    """[R] bool: the rows of ``plan`` that hold a slot flagged in
    ``slots`` [S]."""
    ptr = plan.row_ptr.long()
    rows = torch.zeros(ptr.numel() - 1, dtype=torch.bool, device=slots.device)
    slot_row = torch.repeat_interleave(
        torch.arange(rows.numel(), device=slots.device), ptr.diff())
    rows[slot_row[slots]] = True
    return rows
