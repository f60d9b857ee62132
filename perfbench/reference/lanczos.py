"""Sub-pixel Lanczos-3 warp in plain PyTorch.

shift(img (B, H, W), d (B, 2) as (dy, dx), int_range) resamples each image
at (i + dy, j + dx). Each axis takes a normalised 7-tap Lanczos-3 kernel at
taps -3..3 minus the offset (a zero argument of the sinc taken as 1e-6),
over the image reflect-padded by 3 (the edge pixel not repeated), rows
first, then columns. With ``int_range`` K > 0 the rounded shift, clipped
to ±K, first moves the image by whole pixels over a reflect pad of K, and
the taps take the rest. The rounded part carries no gradient.
"""

from __future__ import annotations

import math

import torch

A = 3
TAPS = 7
EPS = 1e-6


def kernel(d: torch.Tensor) -> torch.Tensor:
    """(B,) offsets -> (B, 7) normalised taps."""
    t = torch.arange(TAPS, dtype=d.dtype, device=d.device) - TAPS // 2
    x = math.pi * (t - d[:, None])
    x = torch.where(x == 0, torch.full_like(x, EPS), x)
    k = torch.sin(x) / x * torch.sin(x / A) / (x / A)
    return k / k.sum(dim=1, keepdim=True)


def _reflect(img: torch.Tensor, p: int) -> torch.Tensor:
    """Reflect-pad the last two axes by p, from slices and flips (their
    backward is deterministic on every device)."""
    img = torch.cat([img[:, 1:p + 1].flip(1), img, img[:, -p - 1:-1].flip(1)], dim=1)
    return torch.cat([img[:, :, 1:p + 1].flip(2), img, img[:, :, -p - 1:-1].flip(2)], dim=2)


def _taps(img: torch.Tensor, ky: torch.Tensor, kx: torch.Tensor) -> torch.Tensor:
    _, h, w = img.shape
    pad = _reflect(img, TAPS // 2)
    rows = sum(ky[:, t, None, None] * pad[:, t:t + h] for t in range(TAPS))
    return sum(kx[:, t, None, None] * rows[:, :, t:t + w] for t in range(TAPS))


def shift(img: torch.Tensor, d: torch.Tensor, int_range: int = 0) -> torch.Tensor:
    if int_range:
        whole = torch.clamp(torch.round(d.detach()), -int_range, int_range)
        d = d - whole
        _, h, w = img.shape
        pad, r = _reflect(img, int_range), int_range
        img = torch.stack([pad[b, r + dy:r + dy + h, r + dx:r + dx + w]
                           for b, (dy, dx) in enumerate(whole.long().tolist())])
    return _taps(img, kernel(d[:, 0]), kernel(d[:, 1]))
