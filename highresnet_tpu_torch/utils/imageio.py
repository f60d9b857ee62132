"""16-bit grayscale PNG IO and dtype ladders.

The port's own copy of ``highresnet_tpu/utils/imageio.py``, imports pointed at
``highresnet_tpu_torch``; the port imports nothing of the JAX package.

The Proba-V dataset stores LR/HR frames as 16-bit grayscale PNGs and masks
as 8-bit PNGs. The reference uses skimage (img_as_float / img_as_uint);
skimage is not a dependency here, so the exact conversions are implemented
directly:

  uint16 -> float32 in [0, 1]: x / 65535
  uint8  -> float32 in [0, 1]: x / 255
  float [0, 1] -> uint16: round(x * 65535)
"""

from __future__ import annotations

import numpy as np

try:  # cv2 is the fastest PNG codec available in this image
    import cv2

    _HAVE_CV2 = True
except ImportError:  # pragma: no cover
    _HAVE_CV2 = False

from PIL import Image


def imread_u16(path) -> np.ndarray:
    """Read a grayscale PNG preserving bit depth (uint8 or uint16)."""
    path = str(path)
    if _HAVE_CV2:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is not None:
            if img.ndim == 3:  # paletted/RGB masks -> first channel
                img = img[..., 0]
            return img
    return np.asarray(Image.open(path))


def imsave_u16(path, img: np.ndarray) -> None:
    """Write a uint16 (or uint8) grayscale PNG."""
    path = str(path)
    img = np.ascontiguousarray(img)
    if _HAVE_CV2 and cv2.imwrite(path, img):
        return
    Image.fromarray(img).save(path)  # pragma: no cover


def img_as_float32(img: np.ndarray) -> np.ndarray:
    """Normalize integer images to float32 in [0, 1] (skimage semantics)."""
    if img.dtype == np.uint16:
        return (img / np.float32(65535.0)).astype(np.float32)
    if img.dtype == np.uint8:
        return (img / np.float32(255.0)).astype(np.float32)
    if img.dtype == np.bool_:
        return img.astype(np.float32)
    return img.astype(np.float32)


def img_as_uint16(img: np.ndarray) -> np.ndarray:
    """Convert float [0, 1] to uint16 with rounding (skimage img_as_uint)."""
    if img.dtype == np.uint16:
        return img
    img = np.clip(img, 0.0, 1.0)
    return np.round(img * 65535.0).astype(np.uint16)
