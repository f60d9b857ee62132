"""Phase cross-correlation (PCC) shift estimates and alignment, batched.

The counterpart of ``highresnet_tpu/registration/search.py::_pcc`` and
``pcc_align_batch``, the part of the JAX registration toolkit that the
registered checkpoint ensemble and TTA need:

- ``_pcc(ref, mov, upsample_factor)``: per image pair, the whitened
  cross-power spectrum with its Nyquist row and column zeroed for even
  sizes, the coarse integer peak of its inverse FFT, then a matrix-DFT zoom
  of a 1.5 px window around that peak at ``1 / upsample_factor`` px
  (Guizar-Sicairos). complex64 throughout; the zoom's two products are
  batched complex matrix products.
- ``pcc_align_batch(ref, mov)``: each image mean-removed and Hann-windowed
  before the estimate, then ``mov`` warped by ``-d`` through
  ``lanczos_shift_fused``: the Lanczos kernel (K3) on CUDA, its plain
  version on the CPU. K3 computes ``lanczos_shift`` at ``int_range=0``,
  which is what the JAX function applies.

Ties of the two argmax searches go to the first index, as in JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from highresnet_tpu_torch.ops.lanczos_fused import lanczos_shift_fused


def _pcc(ref: torch.Tensor, mov: torch.Tensor, upsample_factor: int = 1000) -> torch.Tensor:
    """(B, H, W) pairs -> (B, 2) shifts (dy, dx) with mov(i) == ref(i + d)."""
    b, h, w = ref.shape
    cross = torch.fft.fft2(ref) * torch.conj(torch.fft.fft2(mov))
    cross = cross / torch.clamp(cross.abs(), min=1e-12)
    # the Nyquist row and column: conjugate-asymmetric under non-integer
    # shifts of real images, they bias the whitened sub-pixel peak
    if h % 2 == 0:
        cross[:, h // 2, :] = 0
    if w % 2 == 0:
        cross[:, :, w // 2] = 0
    peak = torch.argmax(torch.fft.ifft2(cross).abs().reshape(b, -1), dim=1)
    py, px = peak // w, peak % w
    dy = torch.where(py > h // 2, py - h, py).to(torch.float32)
    dx = torch.where(px > w // 2, px - w, px).to(torch.float32)

    uf = upsample_factor
    region = int(math.ceil(1.5 * uf))  # a 1.5 px neighbourhood
    off = region // 2
    steps = torch.arange(region, dtype=torch.float32, device=ref.device) / uf
    sy = (dy - off / uf)[:, None] + steps  # (B, region) candidate dy
    sx = (dx - off / uf)[:, None] + steps
    fy = torch.fft.fftfreq(h, device=ref.device)
    fx = torch.fft.fftfreq(w, device=ref.device)
    two_pi = 2.0 * math.pi
    phase_y = two_pi * sy[:, :, None] * fy  # (B, region, H)
    phase_x = two_pi * fx[:, None] * sx[:, None, :]  # (B, W, region)
    ey = torch.polar(torch.ones_like(phase_y), phase_y)
    ex = torch.polar(torch.ones_like(phase_x), phase_x)
    zoom = torch.matmul(torch.matmul(ey, cross), ex).abs().reshape(b, -1)
    zpeak = torch.argmax(zoom, dim=1)
    rows = torch.arange(b, device=ref.device)
    return torch.stack([sy[rows, zpeak // region], sx[rows, zpeak % region]], dim=-1)


def hann_window(n: int, device) -> torch.Tensor:
    """``np.hanning(n)`` (symmetric) as float32."""
    return torch.from_numpy(np.hanning(n).astype(np.float32)).to(device)


def pcc_align_batch(ref: torch.Tensor, mov: torch.Tensor, upsample_factor: int = 100):
    """Translate each ``mov[b]`` onto ``ref[b]``; returns (aligned, d).

    ref, mov: (B, H, W). ``d`` (B, 2) is the estimated (dy, dx) with
    ``mov(i) == ref(i + d)``, so the warp by ``-d`` lands mov on ref's grid.
    The Hann window matters: these are non-circular shifts of bounded
    images, and the wrap-around edge biases the whitened phase."""
    ref = ref.to(torch.float32)
    mov = mov.to(torch.float32)
    h, w = ref.shape[-2:]
    win = hann_window(h, ref.device)[:, None] * hann_window(w, ref.device)[None, :]

    def prep(im):
        return (im - im.mean(dim=(-2, -1), keepdim=True)) * win

    d = _pcc(prep(ref), prep(mov), upsample_factor=upsample_factor)
    return lanczos_shift_fused(mov.contiguous(), -d), d
