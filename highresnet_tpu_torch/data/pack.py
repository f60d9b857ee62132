"""Pre-packed scene cache: one uncompressed .npz per scene.

The port's own copy of ``highresnet_tpu/data/pack.py``, imports pointed at
``highresnet_tpu_torch``; the port imports nothing of the JAX package.

The full-training config reads thousands of small 16-bit PNGs per epoch
with per-item random sampling (SURVEY.md §7 risk: "Input pipeline
throughput"). Packing each scene's assets into a single uncompressed .npz
replaces per-view PNG decode with one straight buffer read; the loaders
pick the pack up automatically when present.

    python -m highresnet_tpu.cli.pack_dataset --prefix data/
"""

from __future__ import annotations

import os
from os.path import join
from typing import Optional, Sequence

import numpy as np

PACK_NAME = "packed.npz"


def pack_scene(scene_dir: str) -> str:
    """Write <scene_dir>/packed.npz with all assets (uint16/uint8 + clearance)."""
    from highresnet_tpu_torch.data.probav import _view_ids, load_clearances
    from highresnet_tpu_torch.utils.imageio import imread_u16

    ids = _view_ids(scene_dir)
    lr = np.stack([imread_u16(join(scene_dir, f"LR{i}.png")) for i in ids]).astype(np.uint16)
    clearances = load_clearances(scene_dir, len(ids))
    payload = {"ids": ids.astype("U16"), "lr": lr, "clearances": clearances}

    sm_path = join(scene_dir, "SM.png")
    if os.path.exists(sm_path):
        payload["sm"] = (imread_u16(sm_path) > 0).astype(np.uint8)
    hr_path = join(scene_dir, "HR.png")
    if os.path.exists(hr_path):
        payload["hr"] = imread_u16(hr_path).astype(np.uint16)

    # write-then-rename: a process killed mid-pack must never leave a
    # truncated packed.npz (it would be newer than its PNGs, so the
    # staleness guard would serve it and np.load would crash every
    # later run — a permanent crash loop under a relaunch supervisor)
    out = join(scene_dir, PACK_NAME)
    tmp = out + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)  # uncompressed: decode-free reads
    os.replace(tmp, out)
    return out


def pack_scenes(scene_dirs: Sequence[str]) -> None:
    for d in scene_dirs:
        pack_scene(d)


def _pack_is_stale(scene_dir: str, pack_mtime: float) -> bool:
    """True if any source asset (PNG / clearance.npy) postdates the pack.

    A stat() per asset is negligible next to the decode the pack avoids;
    without this, edited or re-generated scenes would be silently served
    from the old cache.
    """
    try:
        with os.scandir(scene_dir) as it:
            for entry in it:
                name = entry.name
                if name == PACK_NAME:
                    continue
                if name.endswith(".png") or name == "clearance.npy":
                    if entry.stat().st_mtime > pack_mtime:
                        return True
    except OSError:
        return True
    return False


def load_pack(scene_dir: str) -> Optional[dict]:
    """Load a scene's pack if present and fresh, else None."""
    path = join(scene_dir, PACK_NAME)
    try:
        pack_mtime = os.stat(path).st_mtime
    except OSError:
        return None
    if _pack_is_stale(scene_dir, pack_mtime):
        import warnings

        warnings.warn(
            f"{path} is older than its source assets; ignoring the pack "
            f"(re-run highresnet_tpu.cli.pack_dataset)"
        )
        return None
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
