"""Training losses: ESA cMSE / cPSNR with a detached brightness bias.

The counterpart of ``highresnet_tpu/ops/losses.py``:

  nclear = sum(mask)
  bias   = detach( sum(mask * (hr - sr)) / nclear )
  cMSE   = sum(mask * (sr + bias - hr)^2) / nclear
  cPSNR  = -10 * log10(cMSE)

Per-image functions take (..., H, W) and reduce the last two axes.
"""

from __future__ import annotations

import numpy as np
import torch

LOSS_METRICS = ("cPSNR", "cMSE", "masked_MSE")


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
