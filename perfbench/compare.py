"""The numbers that decide ``correct``, each the gap between what the
program produced and what the plain reference works out from the same
inputs and weights."""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

import numpy as np


def image_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """Worst image of a stack: max |got - ref| over the image, as a share
    of max |ref| over it."""
    got = np.asarray(got, np.float64).reshape(len(ref), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    scale = np.maximum(np.abs(ref).max(axis=1), 1e-30)
    return float((np.abs(got - ref).max(axis=1) / scale).max())


def loss_gap(got: Sequence[float], ref: Sequence[float]) -> float:
    """Worst step of |loss - ref| / |ref|."""
    return max(abs(g - r) / max(abs(r), 1e-30) for g, r in zip(got, ref))


def median_leaf(norms: Dict[str, float]) -> float:
    """The median of the leaves' norms, over the leaves that are not zero
    (ShiftNet's layers get no gradient at the first step, while its last
    layer starts at zero)."""
    return float(np.median([v for v in norms.values() if v > 0] or [0.0]))


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              keys: Iterable[str] | None = None) -> np.ndarray:
    """Each leaf's |norm - ref norm| over the larger of the leaf's ref norm
    and the median leaf's (the leaves in ``keys``; all without); a leaf
    the program lacks reads as norm 0."""
    keys = list(ref if keys is None else keys)
    median = median_leaf({k: ref[k] for k in keys})
    return np.array([abs(got.get(k, 0.0) - ref[k]) / max(ref[k], median, 1e-30) for k in keys])


def moving_leaves(grad_norms: Sequence[Dict[str, float]], share: float = 1e-3) -> list:
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's at some step: the others move under Adam by round-off
    alone (the bias of a conv before a batch norm, or of the last conv
    under the bias-corrected loss, has no gradient in exact arithmetic)."""
    medians = [median_leaf(g) for g in grad_norms]
    return [k for k in grad_norms[0]
            if any(g[k] >= share * m for g, m in zip(grad_norms, medians))]
