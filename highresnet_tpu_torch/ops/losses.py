"""Training losses: ESA cMSE / cPSNR with a detached brightness bias.

The counterpart of ``highresnet_tpu/ops/losses.py``:

  nclear = sum(mask)
  bias   = detach( sum(mask * (hr - sr)) / nclear )
  cMSE   = sum(mask * (sr + bias - hr)^2) / nclear
  cPSNR  = -10 * log10(cMSE)

Per-image functions take (..., H, W) and reduce the last two axes.

``cl1_loss`` is RAMS's own criterion (Salvetti et al. 2020), a
brightness-corrected masked L1 that searches the registration itself: the
SR cropped by ``border`` px on each side against each of the
(2·border + 1)² crops of the HR and its mask of that size, with the bias
b = Σm(hr − sr) / Σm not detached, Σ|m·hr − m·(m·sr + b)| / Σm, and the
minimum over the crops.
"""

from __future__ import annotations

import numpy as np
import torch

LOSS_METRICS = ("cPSNR", "cMSE", "masked_MSE")  # the registered criteria, as JAX's
CL1 = "cL1"  # RAMS's criterion, taken apart from them


def masked_mse_loss(sr: torch.Tensor, hr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over ALL pixels (masked-out zeros included) of (mask·sr − mask·hr)²."""
    return torch.mean(torch.square(mask * sr - mask * hr), dim=(-2, -1))


def cmse(sr: torch.Tensor, hr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Bias-corrected masked MSE, per image."""
    nclear = torch.sum(mask, dim=(-2, -1))
    bias = (torch.sum(mask * (hr - sr), dim=(-2, -1)) / nclear).detach()
    err = sr + bias[..., None, None] - hr
    return torch.sum(mask * torch.square(err), dim=(-2, -1)) / nclear


def cpsnr_loss(sr: torch.Tensor, hr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-image cPSNR in dB (higher is better); the bias is detached."""
    return -10.0 * torch.log10(cmse(sr, hr, mask))


def get_loss(sr, hr, mask, metric: str = "cMSE") -> torch.Tensor:
    """Per-image training criterion, selected by name (one of LOSS_METRICS)."""
    if metric == "masked_MSE":
        return masked_mse_loss(sr, hr, mask)
    if metric == "cMSE":
        return cmse(sr, hr, mask)
    if metric == "cPSNR":
        return cpsnr_loss(sr, hr, mask)
    raise ValueError(f"unknown loss metric {metric!r}; expected one of {LOSS_METRICS}")


def registered_loss(sr_shifted, hr, mask, shifts, lam: float, metric: str = "cPSNR",
                    mean=torch.mean):
    """mean(criterion) + lam · mean(shifts)²; −cPSNR for the default metric.

    The regulariser is lambda times the SQUARE OF THE MEAN of all shift
    components: it penalises a net translation, not the shifts' size. A
    data-parallel step passes as ``mean`` the mean over every rank's shifts.
    """
    per_image = get_loss(sr_shifted, hr, mask, metric=metric)
    if metric == "cPSNR":
        per_image = -per_image
    return torch.mean(per_image) + lam * torch.square(mean(shifts))


def cl1_loss(sr: torch.Tensor, hr: torch.Tensor, mask: torch.Tensor, border: int = 3):
    """Per-image cL1 of (B, H, W) SR, HR and mask (the module notes): the
    minimum over the (2·border + 1)² shifts of the HR crop."""
    h, w = sr.shape[-2] - 2 * border, sr.shape[-1] - 2 * border
    sr = sr[..., None, None, border:border + h, border:border + w]
    hr = hr.unfold(-2, h, 1).unfold(-2, w, 1)  # (B, shifts, shifts, h, w), views of the HR
    mask = mask.unfold(-2, h, 1).unfold(-2, w, 1)
    n = torch.sum(mask, dim=(-2, -1))
    hr_m, sr_m = mask * hr, mask * sr
    bias = torch.sum(hr_m - sr_m, dim=(-2, -1)) / n
    l1 = torch.sum(torch.abs(hr_m - mask * (sr_m + bias[..., None, None])), dim=(-2, -1)) / n
    return torch.amin(l1.flatten(-2), dim=-1)


def crop_mask(patch_size: int, crop: int) -> np.ndarray:
    """(3P, 3P) float32 mask that zeroes a ``crop``-wide border of the SR frame."""
    size = 3 * patch_size
    m = np.ones((size, size), dtype=np.float32)
    if crop > 0:
        m[:crop, :] = 0.0
        m[-crop:, :] = 0.0
        m[:, :crop] = 0.0
        m[:, -crop:] = 0.0
    return m
