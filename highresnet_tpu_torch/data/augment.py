"""Train-time dihedral augmentation (D4: rotations x flips).

The port's own copy of ``highresnet_tpu/data/augment.py``, imports pointed at
``highresnet_tpu_torch``; the port imports nothing of the JAX package.

The reference trains on raw patches only (src/DataLoader.py:120-140 draws a
random crop but never flips/rotates). Standard SR practice augments with the
8-element dihedral group; because LR views and the HR target of one scene
share a square pixel grid and a corner-aligned 3x scale, any D4 element
applied to the WHOLE image plane preserves the LR<->HR correspondence
exactly (per-view sub-pixel offsets rotate with the plane). Off by default
(`training.augment_dihedral: false`) to preserve reference-exact protocols;
it is a documented extension, not a parity item.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from highresnet_tpu_torch.data.probav import ImageSet


def dihedral(img: np.ndarray, k: int) -> np.ndarray:
    """Apply element ``k`` (0..7) of the dihedral group D4 to the last two
    axes: k & 3 = number of 90-degree rotations, k & 4 = horizontal flip
    first. Returns a C-contiguous copy (rot90/flip return negative-stride
    views, which device transports reject or silently copy anyway)."""
    if not 0 <= k < 8:
        raise ValueError(f"dihedral k must be in [0, 8), got {k}")
    if k & 4:
        img = img[..., ::-1]
    if k & 3:
        img = np.rot90(img, k & 3, axes=(-2, -1))
    return np.ascontiguousarray(img)


def dihedral_imageset(s: ImageSet, k: int) -> ImageSet:
    """One D4 element applied consistently to lr stack, hr and hr_map."""
    if k == 0:
        return s
    return dataclasses.replace(
        s,
        lr=dihedral(s.lr, k),
        hr=None if s.hr is None else dihedral(s.hr, k),
        hr_map=None if s.hr_map is None else dihedral(s.hr_map, k),
    )


def random_dihedral_imageset(s: ImageSet, rng: np.random.Generator) -> ImageSet:
    return dihedral_imageset(s, int(rng.integers(8)))
