"""Synthetic Proba-V-like scenes, made on the device from a seed in bulk.

The look follows ``highresnet_tpu_torch/data/synth.py::make_scene`` without
writing files: the HR image is a four-octave smooth random field (octave
o: a grid of max(2, S >> (3 - o)) normals, bilinearly upsampled, weighted
1 / 2^o) scaled to [0, 1]; each LR view is the HR image rolled by a whole
number of HR pixels in [-2, 2] on each axis, averaged over 3 x 3 blocks,
plus normal noise of std ``noise``, clipped to [0, 1]. The HR truth is
then moved by a sub-pixel offset drawn from a normal of std
``hr_shift_sigma`` truncated at 2.4 sigma (a periodic shift through the
Fourier transform, as the views' rolls are periodic), so registered
training has a misalignment to learn that stays inside the warp's window.
The HR quality map clears 98% of pixels. A scene has between
``min_views`` and L real views; the rest of its L are zero with alpha 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _field(g: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    out = torch.zeros(n, 1, size, size, device=device)
    for o in range(4):
        k = max(2, size >> (3 - o))
        coarse = torch.randn(n, 1, k, k, generator=g, device=device)
        out += F.interpolate(coarse, size=(size, size), mode="bilinear",
                             align_corners=True) / 2 ** o
    out = out[:, 0]
    lo = out.amin(dim=(1, 2), keepdim=True)
    hi = out.amax(dim=(1, 2), keepdim=True)
    return (out - lo) / torch.clamp(hi - lo, min=1e-9)


def _fourier_shift(img: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """img (N, S, S) moved by d (N, 2) = (dy, dx) pixels, periodically."""
    s = img.shape[-1]
    f = torch.fft.fftfreq(s, device=img.device)
    phase = -2 * math.pi * (d[:, 0, None, None] * f[None, :, None]
                            + d[:, 1, None, None] * f[None, None, :])
    return torch.fft.ifft2(torch.fft.fft2(img) * torch.polar(torch.ones_like(phase), phase)).real


def scenes(g: torch.Generator, n: int, views: int, lr_size: int, device, *,
           min_views: int, noise: float = 0.01, hr_shift_sigma: float = 1.0):
    """(lrs (n, views, h, h), alphas (n, views), hrs (n, 3h, 3h), hr_maps)
    float32 on ``device``."""
    hr_size = 3 * lr_size
    hr = _field(g, n, hr_size, device)
    rolls = torch.randint(-2, 3, (n, views, 2, 1), generator=g, device=device)
    idx = (torch.arange(hr_size, device=device) - rolls) % hr_size  # torch.roll's source rows
    full = (n, views, hr_size, hr_size)
    lrs = torch.gather(hr[:, None].expand(full), 2, idx[:, :, 0, :, None].expand(full))
    lrs = torch.gather(lrs, 3, idx[:, :, 1, None, :].expand(full))
    lrs = lrs.reshape(n, views, lr_size, 3, lr_size, 3).mean(dim=(3, 5))
    lrs = torch.clamp(lrs + noise * torch.randn(lrs.shape, generator=g, device=device), 0, 1)
    real = torch.randint(min_views, views + 1, (n, 1), generator=g, device=device)
    alphas = (torch.arange(views, device=device)[None] < real).float()
    lrs = lrs * alphas[:, :, None, None]
    lim = 2.4 * hr_shift_sigma
    d = torch.clamp(hr_shift_sigma * torch.randn(n, 2, generator=g, device=device), -lim, lim)
    hrs = torch.clamp(_fourier_shift(hr, d), 0, 1)
    hr_maps = (torch.rand(n, hr_size, hr_size, generator=g, device=device) > 0.02).float()
    return lrs, alphas, hrs, hr_maps
