"""Proba-V scene loading: discovery, clearance sampling, patching.

The port's own copy of ``highresnet_tpu/data/probav.py``, imports pointed at
``highresnet_tpu_torch``; the port imports nothing of the JAX package.

On-disk contract (same as the reference's src/DataLoader.py:73-148 and
src/utils.py:31-45):
scene dirs `<root>/{train,test}/{RED,NIR}/imgset*/` holding `LR*.png` +
`QM*.png` (uint16/uint8), `SM.png`, optional `HR.png`, and a precomputed
`clearance.npy` (one score per view = sum of its QM mask).

Design changes vs the reference (intentional):
- `sample_clearest` draws via Gumbel-top-k over beta-scaled normalized
  clearances. This is distributionally identical to sequential
  softmax-without-replacement (Plackett–Luce) but numerically stable —
  the reference's direct `exp(beta*c/c.max())` overflows for large beta
  (flagged FIXME at DataLoader.py:66).
- Missing `clearance.npy` is computed on the fly (and optionally cached)
  instead of hard-erroring.
- Everything returns NumPy float32 ready for `device_put`; no torch.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from os.path import basename, exists, isfile, join
from typing import Dict, List, Optional, Sequence

import numpy as np

from highresnet_tpu_torch.utils.imageio import img_as_float32, imread_u16

CHANNEL_DIRS = ("RED", "NIR")


def get_patch(img: np.ndarray, x: int, y: int, size: int) -> np.ndarray:
    """Square crop at top-left (x, y), broadcast over leading dims."""
    return img[..., x : x + size, y : y + size]


def sample_clearest(
    clearances: np.ndarray,
    n: Optional[int] = None,
    beta: float = 50.0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Sample `n` view indices without replacement, P(i) ∝ softmax(beta·c/c.max).

    Gumbel-top-k: argtop-k of (logits + Gumbel noise) is an exact sample
    from the Plackett–Luce distribution induced by the softmax weights —
    the same law as numpy's sequential choice(replace=False), minus the
    overflow of exponentiating beta directly.
    """
    rng = rng or np.random.default_rng()
    c = np.asarray(clearances, np.float64)
    logits = beta * c / max(c.max(), 1e-12)
    gumbel = rng.gumbel(size=logits.shape)
    order = np.argsort(-(logits + gumbel))
    return order[: len(order) if n is None else n]


@dataclass
class ImageSet:
    """All assets of one scene."""

    name: str
    lr: np.ndarray  # (L, h, w) float32 in [0,1]
    hr: Optional[np.ndarray]  # (H, W) float32 in [0,1] or None (test)
    hr_map: Optional[np.ndarray]  # (H, W) float32 {0,1}
    clearances: np.ndarray = field(default_factory=lambda: np.zeros(0))

    def __repr__(self):
        lines = [f"{'name':>10} : {self.name}"]
        for k in ("lr", "hr", "hr_map", "clearances"):
            v = getattr(self, k)
            if v is not None:
                lines.append(f"{k:>10} : {v.shape} {type(v).__name__} ({v.dtype})")
        return "\n".join(lines)


def _view_ids(scene_dir: str) -> np.ndarray:
    ids = [basename(p)[2:-4] for p in glob.glob(join(scene_dir, "QM*.png"))]
    return np.sort(np.array(ids))


def compute_clearance_scores(scene_dir: str) -> np.ndarray:
    """Per-view clearance = sum of the QM mask (reference save_clearance.py:22-27)."""
    ids = _view_ids(scene_dir)
    return np.array(
        [imread_u16(join(scene_dir, f"QM{i}.png")).astype(np.uint64).sum() for i in ids],
        dtype=np.float64,
    )


def save_clearance_scores(scene_dirs: Sequence[str]) -> None:
    """Precompute clearance.npy for each scene (offline prep step)."""
    for d in scene_dirs:
        np.save(join(d, "clearance.npy"), compute_clearance_scores(d))


def load_clearances(scene_dir: str, n_views: int, cache: bool = False) -> np.ndarray:
    path = join(scene_dir, "clearance.npy")
    if isfile(path):
        return np.load(path)
    scores = compute_clearance_scores(scene_dir)
    if cache:
        try:
            np.save(path, scores)
        except OSError:
            pass
    if len(scores) != n_views:
        scores = np.zeros(n_views)
    return scores


def read_imageset(
    scene_dir: str,
    create_patches: bool = False,
    patch_size: int = 64,
    top_k: Optional[int] = None,
    beta: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> ImageSet:
    """Load one scene; optionally clearance-sample views and random-crop.

    top_k > 0: sample that many views ∝ clearance (training).
    top_k None/-1: load all views sorted by clearance, descending (eval).

    When a packed.npz cache exists (data/pack.py), assets come from one
    decode-free buffer read instead of per-view PNG decodes.
    """
    rng = rng or np.random.default_rng()

    from highresnet_tpu_torch.data.pack import load_pack

    pack = load_pack(scene_dir)
    if pack is not None:
        clearances = pack["clearances"]
    else:
        ids = _view_ids(scene_dir)
        clearances = load_clearances(scene_dir, len(ids))

    if top_k is not None and top_k > 0:
        k = min(top_k, len(clearances))
        sel = sample_clearest(clearances, n=k, beta=beta, rng=rng)
    else:
        sel = np.argsort(clearances)[::-1]
    clearances = clearances[sel]

    if pack is not None:
        lr = pack["lr"][sel]
        hr_map = pack["sm"].astype(np.float32) if "sm" in pack else None
        hr = pack["hr"] if "hr" in pack else None
    else:
        ids = ids[sel]
        lr = np.stack([imread_u16(join(scene_dir, f"LR{i}.png")) for i in ids]).astype(np.uint16)
        hr_map = None
        sm_path = join(scene_dir, "SM.png")
        if exists(sm_path):
            hr_map = (imread_u16(sm_path) > 0).astype(np.float32)
        hr = None
        hr_path = join(scene_dir, "HR.png")
        if exists(hr_path):
            hr = imread_u16(hr_path).astype(np.uint16)

    if create_patches:
        # patch_size == image size is accepted as a no-op crop at offset 0.
        # This deliberately EXTENDS the reference, whose
        # np.random.randint(low=0, high=0) raises ValueError for that case
        # (DataLoader.py:132) — full-frame "patches" are useful for tiny
        # synthetic scenes. A LARGER patch_size is a misconfiguration that
        # must fail here, not as an opaque shape error deep inside the
        # compiled train step
        max_x = lr.shape[1] - patch_size
        max_y = lr.shape[2] - patch_size
        if max_x < 0 or max_y < 0:
            raise ValueError(
                f"patch_size={patch_size} exceeds the LR image size "
                f"{lr.shape[1]}x{lr.shape[2]} of scene {basename(scene_dir)!r}"
            )
        x = int(rng.integers(0, max_x)) if max_x > 0 else 0
        y = int(rng.integers(0, max_y)) if max_y > 0 else 0
        lr = get_patch(lr, x, y, patch_size)
        if hr_map is not None:
            hr_map = get_patch(hr_map, 3 * x, 3 * y, 3 * patch_size)
        if hr is not None:
            hr = get_patch(hr, 3 * x, 3 * y, 3 * patch_size)

    return ImageSet(
        name=basename(scene_dir),
        lr=img_as_float32(lr),
        hr=None if hr is None else img_as_float32(hr),
        hr_map=hr_map,
        clearances=clearances,
    )


def discover_scenes(data_dir: str, channels: Sequence[str] = CHANNEL_DIRS) -> List[str]:
    """List scene dirs under <data_dir>/{RED,NIR} (reference utils.py:31-45)."""
    dirs: List[str] = []
    for ch in channels:
        path = join(data_dir, ch)
        if not os.path.isdir(path):
            continue
        for name in sorted(os.listdir(path)):
            full = join(path, name)
            if os.path.isdir(full):
                dirs.append(full)
    return dirs


def read_baseline_cpsnr(path: str) -> Dict[str, float]:
    """Parse the ESA norm.csv (space-delimited `scene score` rows)."""
    scores: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                scores[parts[0].strip()] = float(parts[1])
    return scores


def train_val_split(scene_dirs: Sequence[str], val_proportion: float = 0.10, seed: int = 1):
    """Deterministic shuffled split.

    Uses sklearn's train_test_split with random_state=seed when available so
    the fold assignment matches the reference exactly
    (src/train.py:263-265); falls back to an equivalent local shuffle.
    """
    try:
        from sklearn.model_selection import train_test_split

        return train_test_split(
            list(scene_dirs), test_size=val_proportion, random_state=seed, shuffle=True
        )
    except ImportError:  # pragma: no cover
        dirs = list(scene_dirs)
        rng = np.random.RandomState(seed)
        idx = rng.permutation(len(dirs))
        n_val = int(np.ceil(len(dirs) * val_proportion))
        val = [dirs[i] for i in idx[:n_val]]
        train = [dirs[i] for i in idx[n_val:]]
        return train, val


class SceneDataset:
    """Indexable collection of scenes (int / name / slice indexing)."""

    def __init__(
        self,
        scene_dirs: Sequence[str],
        create_patches: bool = False,
        patch_size: int = 64,
        top_k: int = -1,
        beta: float = 0.0,
        seed: Optional[int] = None,
    ):
        self.scene_dirs = list(scene_dirs)
        self.name_to_dir = {basename(d): d for d in self.scene_dirs}
        self.create_patches = create_patches
        self.patch_size = patch_size
        self.top_k = top_k
        self.beta = beta
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.scene_dirs)

    def __getitem__(self, index):
        if isinstance(index, int):
            dirs = [self.scene_dirs[index]]
        elif isinstance(index, str):
            dirs = [self.name_to_dir[index]]
        elif isinstance(index, slice):
            dirs = self.scene_dirs[index]
        else:
            raise KeyError("index must be int, str, or slice")
        sets = [
            read_imageset(
                d,
                create_patches=self.create_patches,
                patch_size=self.patch_size,
                top_k=self.top_k,
                beta=self.beta,
                rng=self._rng,
            )
            for d in dirs
        ]
        return sets[0] if len(sets) == 1 else sets

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
