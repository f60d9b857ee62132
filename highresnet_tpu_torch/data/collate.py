"""Static-shape batch collation.

The port's own copy of ``highresnet_tpu/data/collate.py``, imports pointed at
``highresnet_tpu_torch``; the port imports nothing of the JAX package.

Pads/truncates every scene's view stack to exactly `min_L` views so every
batch is a fixed (B, min_L, H, W) — the property that makes the whole train
step a single compiled XLA program (no recompiles, no dynamic shapes).
Semantics mirror the reference collateFunction (src/utils.py:49-113):
scenes with more views are truncated to the first min_L, scenes with fewer
are zero-padded with alpha=0 marking the padding.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from highresnet_tpu_torch.data.probav import ImageSet


class Batch(NamedTuple):
    lrs: np.ndarray  # (B, min_L, h, w) float32
    alphas: np.ndarray  # (B, min_L) float32 {0,1}
    hrs: Optional[np.ndarray]  # (B, H, W) float32, or None for test scenes
    hr_maps: Optional[np.ndarray]  # (B, H, W) float32
    names: List[str]


def collate(imagesets: Sequence[ImageSet], min_l: int) -> Batch:
    lrs, alphas, hrs, maps, names = [], [], [], [], []
    have_hr = True
    for s in imagesets:
        l, h, w = s.lr.shape
        if l >= min_l:
            lrs.append(s.lr[:min_l])
            alphas.append(np.ones(min_l, np.float32))
        else:
            pad = np.zeros((min_l - l, h, w), np.float32)
            lrs.append(np.concatenate([s.lr, pad], axis=0))
            alphas.append(
                np.concatenate([np.ones(l, np.float32), np.zeros(min_l - l, np.float32)])
            )
        if s.hr is None:
            have_hr = False
        else:
            hrs.append(s.hr)
        maps.append(s.hr_map)
        names.append(s.name)

    return Batch(
        lrs=np.stack(lrs),
        alphas=np.stack(alphas),
        hrs=np.stack(hrs) if have_hr and hrs else None,
        hr_maps=np.stack(maps) if all(m is not None for m in maps) else None,
        names=names,
    )
