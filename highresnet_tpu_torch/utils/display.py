"""Display and persistence helpers of the registration and preprocessing toolkit.

The port's own copy of ``highresnet_tpu/utils/display.py``, on the host:
percentile rescaling, 8-bit stretches, the summed VGG diff heatmap, PNG and
shift-JSON writers, and the matplotlib plots (imported only inside the
functions that draw, so headless use needs no matplotlib). ``_resize`` is
JAX's cubic resize through ``ops/resize.py::resize_cubic`` on the CPU, not
``F.interpolate`` (ROADMAP hazard H2).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

import torch

from highresnet_tpu_torch.ops.resize import resize_cubic
from highresnet_tpu_torch.utils.imageio import imread_u16, imsave_u16


def rescale_intensity(image: np.ndarray, in_range, out_range=(0.0, 1.0)) -> np.ndarray:
    """Linear intensity rescale with clipping (skimage.exposure semantics)."""
    lo, hi = float(in_range[0]), float(in_range[1])
    olo, ohi = float(out_range[0]), float(out_range[1])
    if hi <= lo:
        return np.full_like(np.asarray(image, np.float64), olo)
    x = (np.asarray(image, np.float64) - lo) / (hi - lo)
    return np.clip(x, 0.0, 1.0) * (ohi - olo) + olo


def min_max_scale(image: np.ndarray) -> np.ndarray:
    lo, hi = np.min(image), np.max(image)
    return (image - lo) / (hi - lo + 1e-8)


def contrast_stretch_8bit(image: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Percentile (1..99) contrast stretch to uint8, optionally mask-windowed."""
    if mask is None:
        p1, p99 = np.percentile(image, 1), np.percentile(image, 99)
    else:
        m = mask if mask.dtype == bool else mask > 0.5
        valid = image[m]
        if valid.size == 0:
            return np.zeros_like(image, dtype=np.uint8)
        p1, p99 = np.percentile(valid, 1), np.percentile(valid, 99)
    return rescale_intensity(image, (p1, p99), (0, 255)).astype(np.uint8)


def process_image_for_display(image: np.ndarray, p2: float = 1, p98: float = 99) -> np.ndarray:
    """Per-channel percentile stretch to [0, 1] for visualization."""
    if image.ndim == 3:
        chans = [
            rescale_intensity(
                image[..., c],
                (np.percentile(image[..., c], p2), np.percentile(image[..., c], p98)),
            )
            for c in range(image.shape[2])
        ]
        return np.stack(chans, axis=2)
    return rescale_intensity(image, (np.percentile(image, p2), np.percentile(image, p98)))


def _resize(img: np.ndarray, shape) -> np.ndarray:
    """``jax.image.resize(img, shape, "cubic")`` on the CPU."""
    return resize_cubic(torch.from_numpy(np.asarray(img, np.float32)), shape).numpy()


def compute_sum_of_layers(diff_features: Optional[Dict], normalize: bool = True) -> np.ndarray:
    """Sum the per-layer VGG |diff| maps (from registration.metrics.perceptual_loss)
    into one heatmap at the largest layer resolution."""
    if diff_features is None:
        return np.zeros((10, 10), float)
    activations = [v for k, v in diff_features.items() if k.endswith("_diff")]
    if not activations:
        return np.zeros((10, 10), float)
    max_h = max(a.shape[0] for a in activations)
    max_w = max(a.shape[1] for a in activations)
    total = np.zeros((max_h, max_w))
    for a in activations:
        peak = np.max(np.abs(a))
        if normalize and peak > 0:
            a = a / peak
        if a.shape != (max_h, max_w):
            a = _resize(a, (max_h, max_w))
        total += a
    if normalize:
        peak = np.max(np.abs(total))
        if peak > 0:
            total /= peak
    return total


def save_image(image: np.ndarray, path: str, dtype=np.float32, easy_display: bool = False) -> None:
    """Save with the reference's dtype ladder: float->uint16 [0,65535] clip,
    bool->0/255 uint8; easy_display stretches + 12x nearest-upscales to uint8."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if easy_display:
        image = process_image_for_display(image, p2=1, p98=99)
        image = np.kron(image, np.ones((12, 12) if image.ndim == 2 else (12, 12, 1)))
        image = rescale_intensity(image, (image.min(), image.max()), (0, 255)).astype(np.uint8)
        dtype = np.uint8
    if dtype == np.bool_:
        imsave_u16(path, image.astype(np.uint8) * 255)
    elif dtype in (np.float32, np.float64):
        imsave_u16(path, np.clip(image, 0, 65535).astype(np.uint16))
    elif dtype == np.uint8:
        imsave_u16(path, np.clip(image, 0, 255).astype(np.uint8))
    elif dtype == np.uint16:
        imsave_u16(path, np.clip(image, 0, 65535).astype(np.uint16))
    else:
        imsave_u16(path, image)


def save_shift(shift, path: str) -> None:
    """Persist a (dy, dx) shift as JSON ({'delta_y':..., 'delta_x':...})."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"delta_y": float(shift[0]), "delta_x": float(shift[1])}, f)


def load_shift(path: str):
    with open(path) as f:
        d = json.load(f)
    return d["delta_y"], d["delta_x"]


def read_image(path: str) -> np.ndarray:
    return imread_u16(path)


# ---------------------------------------------------------------------------
# matplotlib-gated plots
# ---------------------------------------------------------------------------

def plot_metrics_vs_shifts(shift_x, shift_y, ssim, mse, pl, highlight_last: bool = False, show: bool = True):
    """3x2 grid: SSIM/MSE/PerceptualLoss vs shift X and Y (reference layout)."""
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(3, 2, figsize=(14, 18))
    for idx, (name, values) in enumerate(
        [("SSIM", ssim), ("MSE", mse), ("Perceptual Loss", pl)]
    ):
        for col, (shifts, style) in enumerate([(shift_x, "bo-"), (shift_y, "rs--")]):
            ax = axs[idx, col]
            ax.plot(shifts, values, style, label=name)
            if highlight_last and len(shifts):
                ax.scatter(shifts[-1], values[-1], color="k", zorder=5, label="Final Value")
            ax.set_xlabel(f"Shift {'X' if col == 0 else 'Y'} (pixels)")
            ax.set_ylabel(name)
            ax.set_title(f"{name} vs. Shift {'X' if col == 0 else 'Y'}")
            ax.grid(True, linestyle="--", alpha=0.6)
    fig.tight_layout()
    if show:
        plt.show()
    return fig


def imsetshow(imageset, k=None, show_map=True, show_histogram=True, figsize=None, show=True, **kwargs):
    """Multi-panel scene view: HR + status map + LR views + 16-bit histograms
    (capability of src/utils.py:116-190)."""
    import matplotlib.pyplot as plt

    lr = np.asarray(imageset.lr)
    hr = None if imageset.hr is None else np.asarray(imageset.hr)
    hr_map = None if imageset.hr_map is None else np.asarray(imageset.hr_map)
    n_lr = k if k is not None else lr.shape[0]
    has_hr = hr is not None
    n_rows = 1 + bool(show_map and has_hr) + bool(show_histogram)
    n_cols = n_lr + int(has_hr)

    fig = plt.figure(figsize=(3 * n_cols, 3 * n_rows) if figsize is None else figsize)
    col = 0
    if has_hr:
        ax = fig.add_subplot(n_rows, n_cols, 1, xticks=[], yticks=[])
        im = ax.imshow(hr, **kwargs)
        fig.colorbar(im, ax=ax, fraction=0.046)
        ax.set_title("HR")
        if show_map and hr_map is not None:
            ax2 = fig.add_subplot(n_rows, n_cols, n_cols + 1, xticks=[], yticks=[])
            ax2.imshow(hr_map, **kwargs)
            ax2.set_title(f"HR status map ({100 * hr_map.mean():.0f}%)")
        if show_histogram:
            axh = fig.add_subplot(n_rows, n_cols, (n_rows - 1) * n_cols + 1, yticks=[])
            axh.hist(hr.ravel(), bins=256)
            axh.set_title("histogram")
        col = 1
    for i in range(n_lr):
        ax = fig.add_subplot(n_rows, n_cols, col + i + 1, xticks=[], yticks=[])
        im = ax.imshow(lr[i], **kwargs)
        fig.colorbar(im, ax=ax, fraction=0.046)
        ax.set_title(f"LR-{i}" + " (reference)" * (i == 0))
        if show_histogram:
            axh = fig.add_subplot(n_rows, n_cols, (n_rows - 1) * n_cols + col + i + 1, yticks=[])
            axh.hist(lr[i].ravel(), bins=256)
    fig.tight_layout()
    if show:
        plt.show()
    return fig
