"""Synthetic Proba-V-format dataset generator.

The port's own copy of ``highresnet_tpu/data/synth.py``, imports pointed at
``highresnet_tpu_torch``; the port imports nothing of the JAX package.

Writes scene directories in the exact on-disk layout the loaders expect
(LR*.png / QM*.png / SM.png / HR.png, 16-bit grayscale), so the full
pipeline — clearance precompute, sampling, collation, training, eval,
submission — runs end-to-end with no Proba-V download. HR content is a
smooth random field; LR views are 3x-decimated, sub-pixel-jittered, noisy
copies, which gives MFSR training signal (more views -> recoverable detail).
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np

from highresnet_tpu_torch.utils.imageio import imsave_u16

GENERATING_MARKER = ".generating"


def _smooth_field(rng: np.random.Generator, size: int, octaves: int = 4) -> np.ndarray:
    """Multi-octave smooth random field in [0, 1]."""
    out = np.zeros((size, size))
    for o in range(octaves):
        n = max(2, size >> (octaves - 1 - o))
        coarse = rng.normal(size=(n, n))
        # bilinear upsample to full size
        xi = np.linspace(0, n - 1, size)
        x0 = np.floor(xi).astype(int)
        x1 = np.minimum(x0 + 1, n - 1)
        fx = xi - x0
        rows = coarse[x0][:, x0] * (1 - fx)[None, :] + coarse[x0][:, x1] * fx[None, :]
        rows1 = coarse[x1][:, x0] * (1 - fx)[None, :] + coarse[x1][:, x1] * fx[None, :]
        up = rows * (1 - fx)[:, None] + rows1 * fx[:, None]
        out += up / (2**o)
    out -= out.min()
    out /= max(out.max(), 1e-9)
    return out


def _bandlimited_detail(rng: np.random.Generator, size: int) -> np.ndarray:
    """Zero-mean unit-std random field band-limited to ~4-10 HR-px wavelengths.

    The band covers the two regimes where multi-frame SR has an edge over
    single-view interpolation:

    - 3-6 px wavelengths sit above the LR Nyquist (6 HR px): 3x decimation
      ALIASES them, with an alias phase set by each view's sub-pixel shift,
      so several shifted views carry complementary measurements no single
      view contains;
    - 6-12 px wavelengths survive decimation but arrive attenuated by the
      3x box prefilter: a trained model can deconvolve that attenuation
      (and average sensor noise across views) while plain bicubic cannot.

    Wavelengths at the box prefilter's first null (~3 px) are avoided:
    nothing survives into any view there, so they are unrecoverable and
    would only add an equal PSNR penalty to every method.
    """
    from scipy.ndimage import gaussian_filter

    noise = rng.normal(size=(size, size))
    band = gaussian_filter(noise, 0.7) - gaussian_filter(noise, 2.5)
    band -= band.mean()
    band /= max(band.std(), 1e-9)
    return band


def make_scene(
    scene_dir: str,
    rng: np.random.Generator,
    n_views: int = 8,
    lr_size: int = 32,
    with_hr: bool = True,
    noise: float = 0.01,
    detail: float = 0.0,
    hr_shift: float = 0.0,
    hr_shift_sigma: float = 0.0,
) -> None:
    """detail > 0 mixes in band-limited sub-LR-Nyquist structure that 3x
    decimation aliases away — recoverable from multiple shifted views but
    not from any single one (makes MFSR-vs-interpolation gaps visible).
    detail == 0 keeps the raw multi-octave field (whose finest octave is
    pixel-scale white noise — deliberately irrecoverable texture).

    hr_shift > 0 writes the HR ground truth at a random sub-pixel offset
    (uniform in ±hr_shift HR px) relative to the LR views' frame. Real
    Proba-V HR is collected separately from the LR series and is NOT
    co-registered with it — the very reason the reference trains with a
    registered loss and scores with shift_cPSNR. hr_shift == 0 keeps the
    frames aligned (where loss-time registration is provably a no-op).

    hr_shift_sigma > 0 draws the per-scene HR offset from a zero-mean
    Gaussian (truncated at ±2.4 sigma, inside the Lanczos warp window for
    sigma <= 1.25) instead of the uniform law — the structured,
    mostly-small, occasionally-multi-pixel misalignment profile of real
    Proba-V acquisitions. This is the regime where the paper's registered
    loss (Table 4, paper txt:831-837) has an edge: an unregistered model
    must learn the conditional mean over the offset law (a sigma-wide
    blur), while a registered model can stay sharp in the LR frame and pay
    only the sub-pixel residual that shift_cPSNR's integer search cannot
    remove. Mutually exclusive with hr_shift."""
    os.makedirs(scene_dir, exist_ok=True)
    hr_size = 3 * lr_size
    hr = _smooth_field(rng, hr_size)
    if detail > 0:
        from scipy.ndimage import gaussian_filter

        # smooth away the field's pixel-scale white-noise octave: it is
        # information-theoretically unrecoverable and would put the same
        # hard PSNR ceiling on every method, drowning the MFSR signal
        hr = gaussian_filter(hr, 1.0)
        band = _bandlimited_detail(rng, hr_size)
        hr = np.clip((1 - detail) * hr + detail * (0.5 + 0.35 * band), 0, 1)

    for v in range(n_views):
        dy, dx = rng.integers(-2, 3, size=2)
        shifted = np.roll(hr, (int(dy), int(dx)), axis=(0, 1))
        lr = shifted.reshape(lr_size, 3, lr_size, 3).mean(axis=(1, 3))
        lr = np.clip(lr + rng.normal(scale=noise, size=lr.shape), 0, 1)
        qm = (rng.random((lr_size, lr_size)) > 0.05).astype(np.uint8) * 255
        imsave_u16(join(scene_dir, f"LR{v:03d}.png"), np.round(lr * 65535).astype(np.uint16))
        imsave_u16(join(scene_dir, f"QM{v:03d}.png"), qm)

    sm = (rng.random((hr_size, hr_size)) > 0.02).astype(np.uint8) * 255
    imsave_u16(join(scene_dir, "SM.png"), sm)
    if with_hr:
        if hr_shift > 0 and hr_shift_sigma > 0:
            raise ValueError("hr_shift and hr_shift_sigma are mutually exclusive")
        if hr_shift > 0 or hr_shift_sigma > 0:
            from scipy.ndimage import shift as ndi_shift

            if hr_shift > 0:
                gy, gx = rng.uniform(-hr_shift, hr_shift, size=2)
            else:
                lim = 2.4 * hr_shift_sigma
                gy, gx = np.clip(rng.normal(0.0, hr_shift_sigma, size=2), -lim, lim)
            # grid-wrap matches the views' np.roll periodicity
            hr = np.clip(
                ndi_shift(hr, (gy, gx), order=3, mode="grid-wrap"), 0, 1
            )
        imsave_u16(join(scene_dir, "HR.png"), np.round(hr * 65535).astype(np.uint16))


def make_synthetic_dataset(
    root: str,
    n_scenes_per_channel: int = 2,
    n_views: int = 8,
    lr_size: int = 32,
    seed: int = 0,
    splits=("train", "test"),
    write_norm_csv: bool = True,
    detail: float = 0.0,
    hr_shift: float = 0.0,
    hr_shift_sigma: float = 0.0,
) -> str:
    """Create <root>/{train,test}/{RED,NIR}/imgset####/ with PNG assets."""
    os.makedirs(root, exist_ok=True)
    # in-progress marker: its presence marks the tree as synthetic-generated
    # even if this process is killed mid-write, so clear_synthetic_dataset
    # can tell "partial synthetic dataset" apart from "somebody's real data"
    with open(join(root, GENERATING_MARKER), "w") as f:
        f.write("in progress\n")
    rng = np.random.default_rng(seed)
    idx = 0
    names = []
    for split in splits:
        with_hr = split == "train"
        for ch in ("RED", "NIR"):
            for _ in range(n_scenes_per_channel):
                name = f"imgset{idx:04d}"
                make_scene(
                    join(root, split, ch, name),
                    rng,
                    n_views=n_views,
                    lr_size=lr_size,
                    with_hr=with_hr,
                    detail=detail,
                    hr_shift=hr_shift,
                    hr_shift_sigma=hr_shift_sigma,
                )
                if with_hr:
                    names.append(name)
                idx += 1
    if write_norm_csv:
        with open(join(root, "norm.csv"), "w") as f:
            for name in names:
                f.write(f"{name} {45.0 + rng.random() * 5:.6f}\n")
    # commit marker: a killed generator leaves no marker, so callers can
    # detect (and regenerate) a partial dataset instead of training on it —
    # a truncated scene dir crashes view sampling with an empty clearance
    # array, or silently trains on fewer scenes than the protocol claims
    with open(join(root, ".complete"), "w") as f:
        f.write("ok\n")
    os.remove(join(root, GENERATING_MARKER))
    return root


def synthetic_dataset_complete(root: str) -> bool:
    """True iff make_synthetic_dataset ran to completion under ``root``."""
    return os.path.exists(join(root, ".complete"))


def clear_synthetic_dataset(root: str, force: bool = False) -> None:
    """Remove ONLY what make_synthetic_dataset (and derived caches) wrote —
    train/, test/, norm.csv, markers, .epoch_cache — leaving everything
    else under ``root`` (checkpoint dirs, reports) intact: a rebuild with
    the same seed/args reproduces the identical dataset, so resumable runs
    keep their progress across a regeneration.

    Refuses to touch a ``train/`` tree that carries no generation marker
    (neither .complete nor .generating) unless ``force=True``: pointing an
    experiment at a real dataset must never silently delete it.
    """
    import shutil

    if not os.path.isdir(root):
        return
    marked = synthetic_dataset_complete(root) or os.path.exists(
        join(root, GENERATING_MARKER)
    )
    if os.path.isdir(join(root, "train")) and not marked and not force:
        raise RuntimeError(
            f"{root}/train exists but carries no synthetic-generation marker; "
            "refusing to delete what may be real data. Pass --regen (force) "
            "to rebuild, or point --root elsewhere."
        )
    for name in ("train", "test", ".epoch_cache"):
        shutil.rmtree(join(root, name), ignore_errors=True)
    for name in ("norm.csv", ".complete", GENERATING_MARKER):
        try:
            os.remove(join(root, name))
        except OSError:
            pass
