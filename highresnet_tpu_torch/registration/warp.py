"""Sub-pixel warps of the registration toolkit, batched over candidates.

The counterpart of ``highresnet_tpu/registration/warp.py``:

- ``cubic_shift_batch``: separable cubic convolution (Keys, a = -0.5, 4
  taps) with a constant-zero boundary, for images;
- ``linear_shift_batch``: separable linear interpolation, zero boundary,
  for masks;
- ``shift_template_batch``: one template and its mask warped by N
  candidate shifts, the masks binarised at 0.5.

Shift convention (scipy.ndimage.shift): output(i) = input(i - d), so a
positive shift moves content down the axis. Each axis is one pass, x first,
then y. A shift's integer part becomes a per-image offset into a
zero-padded field (a gather of each tap's window; clipped to [-W, W], where
the window already lies wholly in the padding); its fractional part becomes
the taps, computed from ``1 - frac`` in float32 as JAX does. Neither
``F.grid_sample(mode="bicubic")`` nor ``F.interpolate`` is used: both take
a = -0.75 and other borders (ROADMAP hazard H2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from highresnet_tpu_torch.runtime import as_tensor


def _cubic_kernel(t: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    """Keys weights for the taps at offsets (-1, 0, 1, 2) -> (..., 4)."""
    d = torch.stack([t + 1.0, t, 1.0 - t, 2.0 - t], dim=-1)
    absd = d.abs()
    absd2 = absd * absd
    absd3 = absd * absd2
    w_near = (a + 2.0) * absd3 - (a + 3.0) * absd2 + 1.0
    w_far = a * absd3 - 5.0 * a * absd2 + 8.0 * a * absd - 4.0 * a
    return torch.where(absd <= 1.0, w_near, w_far)


def _linear_kernel(t: torch.Tensor) -> torch.Tensor:
    return torch.stack([1.0 - t, t], dim=-1)


def _shift_last_axis(img, shift, kernel_fn, n_taps: int, lo_tap: int) -> torch.Tensor:
    """(B, H, W) shifted along the last axis by per-image amounts (B,)."""
    b, h, w = img.shape
    int_s = torch.floor(shift)
    # the sample i - shift has its floor at i - int_s - 1 for frac > 0, so
    # the kernel's offset inside the tap window is 1 - frac (continuous at 0)
    weights = kernel_fn(1.0 - (shift - int_s))  # (B, n_taps)
    int_s = torch.clamp(int_s.to(torch.int64), -w, w)
    pad = w + n_taps
    padded = F.pad(img, (pad, pad))
    # tap j of output i reads padded[pad + i - int_s - lo_tap + j]
    first = (pad - lo_tap - int_s)[:, None] + torch.arange(w, device=img.device)  # (B, W)
    out = None
    for j in range(n_taps):
        tap = torch.gather(padded, 2, (first + j)[:, None, :].expand(b, h, w))
        term = weights[:, j, None, None] * tap
        out = term if out is None else out + term
    return out


def _shift_batch(img, shifts, kernel_fn, n_taps: int, lo_tap: int, device) -> torch.Tensor:
    img = as_tensor(img, device)
    shifts = as_tensor(shifts, img.device).to(img.device)
    out = _shift_last_axis(img, shifts[:, 1], kernel_fn, n_taps, lo_tap)  # x
    out = _shift_last_axis(out.transpose(1, 2), shifts[:, 0], kernel_fn, n_taps, lo_tap)  # y
    return out.transpose(1, 2)


@torch.inference_mode()
def cubic_shift_batch(img, shifts, device="cuda") -> torch.Tensor:
    """(B, H, W) images shifted by (B, 2) = (dy, dx); cubic, zero boundary."""
    return _shift_batch(img, shifts, _cubic_kernel, 4, 2, device)


@torch.inference_mode()
def linear_shift_batch(img, shifts, device="cuda") -> torch.Tensor:
    """(B, H, W) bilinear shift with a zero boundary (for masks)."""
    return _shift_batch(img, shifts, _linear_kernel, 2, 1, device)


@torch.inference_mode()
def shift_template_batch(template, mask, shifts, device="cuda"):
    """One (H, W) template and mask warped by (N, 2) candidate (dy, dx)
    shifts: (images (N, H, W), masks (N, H, W) binarised at 0.5)."""
    template = as_tensor(template, device)
    mask = as_tensor(mask, template.device)
    n = shifts.shape[0]
    imgs = template[None].expand(n, *template.shape)
    masks = mask[None].expand(n, *mask.shape)
    warped = cubic_shift_batch(imgs, shifts)
    wmasks = linear_shift_batch(masks, shifts)
    return warped, (wmasks > 0.5).to(torch.float32)
