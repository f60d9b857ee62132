"""Dihedral-group (D4) image transforms for geometric self-ensembling.

The counterpart of ``highresnet_tpu/ops/dihedral.py``. Every transform acts
on the last two axes, so one function serves (B, L, H, W) LR stacks and
(B, H', W') SR outputs. Element ``t`` in [0, 8) is ``rot90`` applied
``t % 4`` times, then a horizontal flip if ``t >= 4``; the inverse undoes
the flip first, then rotates back. Rotations by 90 and 270 degrees need
H == W; ``SAFE_SUBGROUP`` keeps the shape of rectangular inputs.
"""

from __future__ import annotations

import torch

#: identity, rot180, flip-H, flip-H after rot180 (= flip-V): shape-preserving
SAFE_SUBGROUP = (0, 2, 4, 6)


def _check(t: int) -> None:
    if not 0 <= t < 8:
        raise ValueError(f"dihedral index must be in [0, 8), got {t}")


def dihedral_fwd(x: torch.Tensor, t: int) -> torch.Tensor:
    """Apply D4 element ``t`` to the last two axes of ``x``."""
    _check(t)
    x = torch.rot90(x, k=t % 4, dims=(-2, -1))
    return torch.flip(x, dims=(-1,)) if t >= 4 else x


def dihedral_inv(x: torch.Tensor, t: int) -> torch.Tensor:
    """Undo ``dihedral_fwd(_, t)``: flip back first, then rotate back."""
    _check(t)
    if t >= 4:
        x = torch.flip(x, dims=(-1,))
    return torch.rot90(x, k=-(t % 4), dims=(-2, -1))
