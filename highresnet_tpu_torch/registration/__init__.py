"""Registration toolkit: batched warps, masked metrics, shift searches,
scene preprocessing, the headless session and its Qt app."""

from highresnet_tpu_torch.registration.metrics import (
    masked_mi,
    masked_ml1e,
    masked_mse,
    masked_ncc,
    masked_ssim,
    perceptual_loss,
)
from highresnet_tpu_torch.registration.search import (
    apply_shift_to_template,
    compute_shift_ncc,
    compute_shift_pcc,
    compute_shift_pl,
    compute_shift_point_matching,
    compute_shift_with_metric,
)

__all__ = [
    "masked_ncc",
    "masked_mse",
    "masked_ml1e",
    "masked_ssim",
    "masked_mi",
    "perceptual_loss",
    "apply_shift_to_template",
    "compute_shift_ncc",
    "compute_shift_pl",
    "compute_shift_pcc",
    "compute_shift_point_matching",
    "compute_shift_with_metric",
]
