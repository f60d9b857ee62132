"""Masked registration metrics, batched over a leading candidate axis.

The counterpart of ``highresnet_tpu/registration/metrics.py``: masked NCC,
normalised masked MSE and mean L1 error, masked SSIM, normalised mutual
information and the VGG perceptual loss. Each of the five masked metrics
takes (ref, mov, ref_mask, mov_mask) of shape (..., H, W), broadcast
against each other, and reduces the last two axes: a reference (H, W)
against N warped candidates (N, H, W) is one call that returns (N,) scores,
and one pair is the N = 1 case with a 0-d result. numpy inputs go to
``device``; tensors stay on their own device.

Mutual information counts its joint histogram exactly with
``torch.bincount`` without weights, which deterministic mode allows on
CUDA (``torch.histc`` and a weighted ``bincount`` refuse it).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from highresnet_tpu_torch.runtime import as_tensor

_EPS = 1e-8
_HW = (-2, -1)
LAYER_WEIGHTS = (1.0, 0.8, 0.6, 0.4, 0.2)


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=_HW, keepdim=True)


def as_tensors(ref, mov, ref_mask, mov_mask, device):
    """float32 tensors of the four arrays, on ref's device (numpy: ``device``)."""
    ref = as_tensor(ref, device)
    return (ref, as_tensor(mov, ref.device), as_tensor(ref_mask, ref.device),
            as_tensor(mov_mask, ref.device))


def _combined_mask(ref_mask: torch.Tensor, mov_mask: torch.Tensor) -> torch.Tensor:
    return (ref_mask > 0.5).to(torch.float32) * (mov_mask > 0.5).to(torch.float32)


@torch.inference_mode()
def masked_ncc(ref, mov, ref_mask, mov_mask, device="cuda") -> torch.Tensor:
    """Weighted normalised cross-correlation under ref_mask * mov_mask; NaN
    where the mask is empty or either image is constant under it."""
    ref, mov, ref_mask, mov_mask = as_tensors(ref, mov, ref_mask, mov_mask, device)
    w = ref_mask * mov_mask
    wsum = _sum(w)
    mu_r = _sum(ref * w) / wsum
    mu_m = _sum(mov * w) / wsum
    sig_r = torch.sqrt(_sum(w * torch.square(ref - mu_r)) / wsum)
    sig_m = torch.sqrt(_sum(w * torch.square(mov - mu_m)) / wsum)
    cov = _sum(w * (ref - mu_r) * (mov - mu_m)) / wsum
    ncc = cov / (sig_r * sig_m)
    bad = (wsum == 0) | (sig_r == 0) | (sig_m == 0)
    return torch.where(bad, torch.nan, ncc)[..., 0, 0]


def _masked_normalize(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero mean, unit std over the masked pixels."""
    n = _sum(mask)
    mean = _sum(img * mask) / n
    var = _sum(mask * torch.square(img - mean)) / n
    return (img - mean) / (torch.sqrt(var) + _EPS)


def _masked_error(ref, mov, ref_mask, mov_mask, use_masks, normalize, device, err):
    ref, mov, ref_mask, mov_mask = as_tensors(ref, mov, ref_mask, mov_mask, device)
    if use_masks:
        m = _combined_mask(ref_mask, mov_mask)
    else:
        m = torch.ones_like(ref)
    if normalize:
        ref = _masked_normalize(ref, m)
        mov = _masked_normalize(mov, m)
    return (_sum(m * err(ref - mov)) / _sum(m))[..., 0, 0]


@torch.inference_mode()
def masked_mse(ref, mov, ref_mask, mov_mask, use_masks: bool = True, normalize: bool = True,
               device="cuda") -> torch.Tensor:
    """Mean squared error over the combined mask, optionally on normalised images."""
    return _masked_error(ref, mov, ref_mask, mov_mask, use_masks, normalize, device, torch.square)


@torch.inference_mode()
def masked_ml1e(ref, mov, ref_mask, mov_mask, use_masks: bool = True, normalize: bool = True,
                device="cuda") -> torch.Tensor:
    """Mean L1 error over the combined mask, optionally on normalised images."""
    return _masked_error(ref, mov, ref_mask, mov_mask, use_masks, normalize, device, torch.abs)


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean over a size x size window of an edge-padded field, the window
    sums accumulated in JAX's order (rows outer, columns inner)."""
    pad = size // 2
    h, w = x.shape[-2:]
    rows = torch.arange(-pad, h + pad, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-pad, w + pad, device=x.device).clamp(0, w - 1)
    xp = x.index_select(-2, rows).index_select(-1, cols)
    acc = None
    for i in range(size):
        for j in range(size):
            win = xp[..., i : i + h, j : j + w]
            acc = win if acc is None else acc + win
    return acc / (size * size)


@torch.inference_mode()
def masked_ssim(ref, mov, ref_mask, mov_mask, use_masks: bool = True, win_size: int = 7,
                device="cuda") -> torch.Tensor:
    """SSIM of the mask-zeroed images: the data range taken from them, a
    uniform window, skimage's sample covariance, the border of half a
    window cropped before the mean."""
    ref, mov, ref_mask, mov_mask = as_tensors(ref, mov, ref_mask, mov_mask, device)
    if use_masks:
        m = _combined_mask(ref_mask, mov_mask)
        ref = ref * m
        mov = mov * m
    ref, mov = torch.broadcast_tensors(ref, mov)
    dmin = torch.minimum(ref.amin(dim=_HW, keepdim=True), mov.amin(dim=_HW, keepdim=True))
    dmax = torch.maximum(ref.amax(dim=_HW, keepdim=True), mov.amax(dim=_HW, keepdim=True))
    drange = dmax - dmin

    c1 = torch.square(0.01 * drange)
    c2 = torch.square(0.03 * drange)
    n = win_size * win_size
    cov_norm = n / (n - 1)
    ux = _uniform_filter(ref, win_size)
    uy = _uniform_filter(mov, win_size)
    uxx = _uniform_filter(ref * ref, win_size)
    uyy = _uniform_filter(mov * mov, win_size)
    uxy = _uniform_filter(ref * mov, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return s[..., pad:-pad, pad:-pad].mean(dim=_HW)


def _bucketize(x: torch.Tensor, bins: int) -> torch.Tensor:
    lo = x.amin(dim=_HW, keepdim=True)
    hi = x.amax(dim=_HW, keepdim=True)
    t = (x - lo) / torch.clamp(hi - lo, min=_EPS)
    return torch.clamp((t * bins).to(torch.int32), 0, bins - 1).to(torch.int64)


def joint_counts(ref, mov, ref_mask, mov_mask, use_masks: bool = True, bins: int = 100,
                 device="cuda") -> torch.Tensor:
    """(..., bins, bins) int64 joint histogram of the mask-zeroed images,
    each bucketed into ``bins`` equal bins over its own range."""
    ref, mov, ref_mask, mov_mask = as_tensors(ref, mov, ref_mask, mov_mask, device)
    if use_masks:
        m = _combined_mask(ref_mask, mov_mask)
        ref = ref * m
        mov = mov * m
    ref, mov = torch.broadcast_tensors(ref, mov)
    lead = ref.shape[:-2]
    joint = (_bucketize(ref, bins) * bins + _bucketize(mov, bins)).reshape(-1, ref.shape[-2:].numel())
    offsets = torch.arange(joint.shape[0], device=joint.device)[:, None] * (bins * bins)
    counts = torch.bincount((joint + offsets).reshape(-1), minlength=joint.shape[0] * bins * bins)
    return counts.reshape(*lead, bins, bins)


def _entropy(p: torch.Tensor, dims) -> torch.Tensor:
    return -torch.sum(torch.where(p > 0, p * torch.log(p), 0.0), dim=dims)


@torch.inference_mode()
def masked_mi(ref, mov, ref_mask, mov_mask, use_masks: bool = True, bins: int = 100,
              device="cuda") -> torch.Tensor:
    """Normalised mutual information (Studholme), (H(X) + H(Y)) / H(X, Y),
    from the ``bins`` x ``bins`` joint histogram of the mask-zeroed images."""
    counts = joint_counts(ref, mov, ref_mask, mov_mask, use_masks, bins, device).to(torch.float32)
    joint = counts / counts.sum(dim=(-2, -1), keepdim=True)
    hx = _entropy(joint.sum(dim=-1), -1)
    hy = _entropy(joint.sum(dim=-2), -1)
    return (hx + hy) / _entropy(joint, (-2, -1))


# the metrics that score a whole candidate stack in one call
BATCHED_METRICS = (masked_ncc, masked_mse, masked_ml1e, masked_ssim, masked_mi)


def nearest_indices(n_in: int, n_out: int, device) -> torch.Tensor:
    """Nearest-neighbour source rows of an n_in -> n_out resize, computed in
    float32 as JAX does (an int32 arange times a Python float)."""
    step = float(np.float32(n_in / n_out))
    return (torch.arange(n_out, device=device).to(torch.float32) * step).to(torch.int64)


@torch.inference_mode()
def perceptual_loss(ref, mov, ref_mask, mov_mask, extractor, return_diffs: bool = True,
                    device="cuda") -> Tuple[float, Dict]:
    """Masked VGG perceptual loss of one pair: both images multiplied by the
    combined mask, the extractor's taps of each, the mask nearest-resized to
    each tap, and the mask-normalised L1 between the taps, weighted by
    ``LAYER_WEIGHTS`` and normalised by their sum.

    Returns (loss, diffs): diffs holds each tap's loss, its channel-summed
    |diff| map and its resized mask (numpy, on the host)."""
    ref, mov, ref_mask, mov_mask = as_tensors(ref, mov, ref_mask, mov_mask, device)
    m = _combined_mask(ref_mask, mov_mask)
    ref_feats = extractor(ref * m)
    mov_feats = extractor(mov * m)

    total = 0.0
    wsum = 0.0
    diffs: Dict[str, object] = {}
    for i, name in enumerate(sorted(ref_feats, key=int)):
        rf, mf = ref_feats[name], mov_feats[name]  # (1, C, hf, wf)
        hf, wf = rf.shape[-2:]
        mr = m[nearest_indices(m.shape[0], hf, m.device)][:, nearest_indices(m.shape[1], wf, m.device)]
        mask_e = mr[None, None]
        num_valid = torch.clamp(torch.sum(mask_e) * rf.shape[1], min=1.0)
        l1 = torch.abs(rf * mask_e - mf * mask_e)
        layer_loss = torch.sum(l1) / num_valid
        w = LAYER_WEIGHTS[min(i, len(LAYER_WEIGHTS) - 1)]
        total = total + w * layer_loss
        wsum += w
        if return_diffs:
            diffs[f"{name}_loss"] = float(layer_loss)
            diffs[f"{name}_diff"] = (torch.sum(l1[0], dim=0) / num_valid).cpu().numpy()
            diffs[f"{name}_mask"] = mr.cpu().numpy()
    return float(total / wsum), diffs
