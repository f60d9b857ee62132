"""Sub-pixel Lanczos shift resampling on tensors: the plain PyTorch version.

The counterpart of ``highresnet_tpu/ops/lanczos.py``, with its contract:

- ``lanczos_kernel(dx, a, n)``: normalised 1-D Lanczos-a kernels at tap
  positions ``linspace(-(n-1)/2, (n-1)/2, n) - dx``, with a 1e-6 guard at
  the sinc singularity;
- ``lanczos_shift(img, shift)``: each (H, W) image resampled at ``i + d``
  for its own (dy, dx), by a separable 7-tap pass (vertical, then
  horizontal) over a field reflect-padded by 3. ``int_range=K > 0`` first
  moves each image by the rounded integer part of its shift (clipped to
  ±K, exact) and leaves the 7-tap pass the fractional rest.

The reflect pad is built from slices and flips, never ``F.pad(mode=
"reflect")``: PyTorch's reflection-pad backward on CUDA refuses
deterministic mode. The integer move is a sum of 2K+1 masked slices per
axis (a one-hot select, exact, no gather), so its backward is slices too.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-6


def lanczos_kernel(dx: torch.Tensor, a: int = 3, n: int = 7) -> torch.Tensor:
    """(...,) sub-pixel offsets -> (..., n) normalised kernels."""
    half = (n - 1) // 2
    taps = torch.linspace(-half, half, n, dtype=dx.dtype, device=dx.device)
    pi_x = math.pi * (taps - dx[..., None])
    pi_x = torch.where(pi_x == 0, torch.full_like(pi_x, _EPS), pi_x)
    k = (torch.sin(pi_x) / pi_x) * (torch.sin(pi_x / a) / (pi_x / a))
    return k / torch.sum(k, dim=-1, keepdim=True)


def reflect_pad(img: torch.Tensor, p: int) -> torch.Tensor:
    """np.pad(mode="reflect") by ``p`` on the last two axes (needs p < H, W)."""
    h, w = img.shape[-2:]
    if p >= h or p >= w:
        raise ValueError(f"a reflect pad of {p} needs H, W > {p}, got {h}x{w}")
    img = torch.cat(
        [img[..., 1 : p + 1, :].flip(-2), img, img[..., h - 1 - p : h - 1, :].flip(-2)], dim=-2
    )
    return torch.cat(
        [img[..., 1 : p + 1].flip(-1), img, img[..., w - 1 - p : w - 1].flip(-1)], dim=-1
    )


def _integer_move(img: torch.Tensor, d_int: torch.Tensor, r: int) -> torch.Tensor:
    """out[b, i, j] = img[b, i + dy_b, j + dx_b] on a field reflect-padded by r."""
    _, h, w = img.shape
    padded = reflect_pad(img, r)
    dy, dx = d_int[:, 0, None, None], d_int[:, 1, None, None]
    rows = sum((dy == d).to(img.dtype) * padded[:, r + d : r + d + h] for d in range(-r, r + 1))
    return sum((dx == d).to(img.dtype) * rows[:, :, r + d : r + d + w] for d in range(-r, r + 1))


def separable_pass(img: torch.Tensor, ky: torch.Tensor, kx: torch.Tensor) -> torch.Tensor:
    """Reflect pad by n//2, vertical n-tap pass, then horizontal; (B, H, W)."""
    _, h, w = img.shape
    n = ky.shape[-1]
    pad = reflect_pad(img, n // 2)
    rows = ky[:, 0, None, None] * pad[:, 0:h]
    for t in range(1, n):
        rows = rows + ky[:, t, None, None] * pad[:, t : t + h]
    out = kx[:, 0, None, None] * rows[:, :, 0:w]
    for t in range(1, n):
        out = out + kx[:, t, None, None] * rows[:, :, t : t + w]
    return out


def lanczos_shift(
    img: torch.Tensor, shift: torch.Tensor, a: int = 3, n: int = 7, int_range: int = 0
) -> torch.Tensor:
    """Shift (B, H, W) images by per-image (dy, dx) offsets (B, 2)."""
    if int_range:
        r = int(int_range)
        d_int = torch.clamp(torch.round(shift.detach()), -r, r)
        shift = shift - d_int  # fractional rest, in [-0.5, 0.5] inside the range
        img = _integer_move(img, d_int.to(torch.int64), r)
    ky = lanczos_kernel(shift[:, 0].to(img.dtype), a=a, n=n)  # (B, n)
    kx = lanczos_kernel(shift[:, 1].to(img.dtype), a=a, n=n)
    return separable_pass(img, ky, kx)


def lanczos_shift_views(img: torch.Tensor, shift: torch.Tensor, a: int = 3, n: int = 7):
    """Shift a (B, L, H, W) stack by per-view offsets (B, L, 2)."""
    b, l, h, w = img.shape
    out = lanczos_shift(img.reshape(b * l, h, w), shift.reshape(b * l, 2), a=a, n=n)
    return out.reshape(b, l, h, w)
