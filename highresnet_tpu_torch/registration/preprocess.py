"""Scene preprocessing: HR -> LR-grid projection and per-view alignment.

The counterpart of ``highresnet_tpu/registration/preprocess.py``:

1. the HR frame is Lanczos-downscaled by the SR factor onto the LR grid
   (``ops.lanczos.lanczos_resample_2d``) and its SM mask box-averaged and
   binarised;
2. every LR view is registered against that reference by the masked-NCC
   grid search, on ``device``;
3. the aligned views, their masks and each view's shift (JSON) are written
   to ``<scene>/<out_subdir>/``.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Dict, Tuple

import numpy as np
import torch

from highresnet_tpu_torch.data.probav import read_imageset
from highresnet_tpu_torch.ops.lanczos import lanczos_resample_2d
from highresnet_tpu_torch.registration.search import apply_shift_to_template, compute_shift_ncc
from highresnet_tpu_torch.runtime import as_tensor
from highresnet_tpu_torch.utils.display import save_image, save_shift


@torch.inference_mode()
def downscale_hr(hr, hr_map: np.ndarray, scale: int = 3,
                 device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """HR and its mask on the LR grid (Lanczos for the image, a box mean
    binarised at 0.5 for the mask), as numpy."""
    lr_ref = lanczos_resample_2d(as_tensor(hr, device), scale).cpu().numpy()
    h, w = hr_map.shape
    mask_small = (
        hr_map[: h - h % scale, : w - w % scale]
        .reshape(h // scale, scale, w // scale, scale)
        .mean(axis=(1, 3))
    )
    return lr_ref, (mask_small > 0.5).astype(np.float32)


def preprocess_imgset(scene_dir: str, scale: int = 3, out_subdir: str = "aligned",
                      points_per_dim: int = 5, max_recursions: int = 6,
                      device="cuda") -> Dict[str, Tuple[float, float]]:
    """Align every LR view of a scene to its Lanczos-downscaled HR frame.

    Returns {view index: (dy, dx)} of the applied shifts; writes the aligned
    images, masks and shift JSONs under <scene_dir>/<out_subdir>/."""
    imset = read_imageset(scene_dir, top_k=None)
    if imset.hr is None:
        raise ValueError(f"{scene_dir} has no HR.png; nothing to align against")

    ref, ref_mask = downscale_hr(imset.hr, imset.hr_map, scale, device)
    out_dir = join(scene_dir, out_subdir)
    os.makedirs(out_dir, exist_ok=True)
    save_image(ref * 65535.0, join(out_dir, "REF.png"), dtype=np.float32)

    ref_t = as_tensor(ref, device)
    ref_mask_t = as_tensor(ref_mask, device)
    shifts: Dict[str, Tuple[float, float]] = {}
    for i, view in enumerate(imset.lr):
        view_t = as_tensor(view, device)
        view_mask = torch.ones_like(view_t)
        dy, dx = compute_shift_ncc(ref_t, view_t, ref_mask_t, view_mask,
                                   points_per_dim=points_per_dim, max_recursions=max_recursions)
        aligned, aligned_mask = apply_shift_to_template(dx, dy, view_t, view_mask)
        save_image(aligned.cpu().numpy() * 65535.0, join(out_dir, f"LR{i:03d}.png"),
                   dtype=np.float32)
        save_image(aligned_mask.cpu().numpy() > 0.5, join(out_dir, f"QM{i:03d}.png"),
                   dtype=np.bool_)
        save_shift((dy, dx), join(out_dir, f"shift{i:03d}.json"))
        shifts[f"{i:03d}"] = (dy, dx)
    return shifts
