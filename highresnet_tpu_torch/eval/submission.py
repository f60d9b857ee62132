"""Kelvin competition submission writer.

Super-resolves every test scene, saves 16-bit PNGs named <scene>.png, and
archives them into submission.zip. Unlike the JAX writer it honours
``single_view_policy`` (ROADMAP hazard H5).
"""

from __future__ import annotations

import os
from zipfile import ZipFile

from highresnet_tpu_torch.eval.evaluator import get_sr_and_score
from highresnet_tpu_torch.utils.imageio import img_as_uint16, imsave_u16


def generate_submission_file(
    forward, imset_dataset, out: str = "submission", min_l: int = 16,
    single_view_policy: str = "warn",
) -> str:
    os.makedirs(out, exist_ok=True)
    for imset in imset_dataset:
        sr, _ = get_sr_and_score(imset, forward, min_l=min_l,
                                 single_view_policy=single_view_policy)
        imsave_u16(os.path.join(out, imset.name + ".png"), img_as_uint16(sr))

    archive = os.path.join(out, "submission.zip")
    with ZipFile(archive, mode="w") as zf:
        for img in sorted(os.listdir(out)):
            if img.startswith("imgset") and img.endswith(".png"):
                zf.write(os.path.join(out, img), arcname=img)
    return archive
