"""x8 dihedral test-time augmentation with phase-correlation alignment, in
plain PyTorch.

SR of one scene = the mean of its eight dihedral SRs, each the forward of
the transformed views with the transform undone on the output, and each
but the first moved onto the first by its phase-correlation shift:

- D4 element t: rotate the last two axes by 90 degrees t mod 4 times,
  then, for t >= 4, flip the last axis; its inverse flips first, then
  rotates back;
- phase correlation (Guizar-Sicairos et al., Opt. Lett. 33, 2008):
  both images less their mean, times a symmetric 2-D Hann window; the
  cross-power spectrum F(ref)·conj(F(mov)) divided by its modulus (at
  least 1e-12), its Nyquist row and column zeroed for even sizes; the
  integer peak of its inverse transform, signed; then the modulus of the
  spectrum's inverse DFT evaluated on a grid of ceil(1.5·u) points a side
  at 1/u px steps (u = 100), starting half the grid below the integer
  peak, whose argmax is the shift d with mov(i) = ref(i + d);
- the image is moved by -d with the Lanczos-3 warp.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import lanczos

UPSAMPLE = 100


def dihedral(x: torch.Tensor, t: int) -> torch.Tensor:
    x = torch.rot90(x, k=t % 4, dims=(-2, -1))
    return torch.flip(x, dims=(-1,)) if t >= 4 else x


def dihedral_inverse(x: torch.Tensor, t: int) -> torch.Tensor:
    if t >= 4:
        x = torch.flip(x, dims=(-1,))
    return torch.rot90(x, k=-(t % 4), dims=(-2, -1))


def hann(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64)
    return (0.5 - 0.5 * torch.cos(2 * math.pi * k / (n - 1))).float().to(device)


def phase_shift(ref: torch.Tensor, mov: torch.Tensor, u: int = UPSAMPLE) -> torch.Tensor:
    """(B, H, W) pairs -> (B, 2) shifts (dy, dx) with mov(i) = ref(i + d)."""
    b, h, w = ref.shape
    win = hann(h, ref.device)[:, None] * hann(w, ref.device)[None, :]
    a = (ref - ref.mean(dim=(-2, -1), keepdim=True)) * win
    c = (mov - mov.mean(dim=(-2, -1), keepdim=True)) * win
    cross = torch.fft.fft2(a) * torch.conj(torch.fft.fft2(c))
    cross = cross / torch.clamp(cross.abs(), min=1e-12)
    if h % 2 == 0:
        cross[:, h // 2, :] = 0
    if w % 2 == 0:
        cross[:, :, w // 2] = 0
    peak = torch.fft.ifft2(cross).abs().reshape(b, -1).argmax(dim=1)
    py, px = (peak // w).float(), (peak % w).float()
    py = torch.where(py > h // 2, py - h, py)
    px = torch.where(px > w // 2, px - w, px)
    n = int(math.ceil(1.5 * u))
    grid = torch.arange(n, dtype=torch.float32, device=ref.device) / u
    sy = (py - (n // 2) / u)[:, None] + grid
    sx = (px - (n // 2) / u)[:, None] + grid
    fy = torch.fft.fftfreq(h, device=ref.device)
    fx = torch.fft.fftfreq(w, device=ref.device)
    ey = torch.exp(2j * math.pi * sy[:, :, None] * fy).to(torch.complex64)  # (B, n, H)
    ex = torch.exp(2j * math.pi * fx[:, None] * sx[:, None, :]).to(torch.complex64)  # (B, W, n)
    zoom = (ey @ cross @ ex).abs().reshape(b, -1).argmax(dim=1)
    rows = torch.arange(b, device=ref.device)
    return torch.stack([sy[rows, zoom // n], sx[rows, zoom % n]], dim=-1)


def tta(forward, lrs: torch.Tensor, alphas: torch.Tensor, transforms: int = 8) -> torch.Tensor:
    """``forward(lrs, alphas)`` -> (B, H', W'); the aligned mean of its
    ``transforms`` dihedral SRs."""
    srs = [dihedral_inverse(forward(dihedral(lrs, t), alphas), t) for t in range(transforms)]
    anchor, rest = srs[0], torch.cat(srs[1:])
    d = phase_shift(anchor.repeat(transforms - 1, 1, 1), rest)
    aligned = lanczos.shift(rest, -d)
    return torch.cat([anchor, aligned]).reshape(transforms, *anchor.shape).mean(dim=0)
