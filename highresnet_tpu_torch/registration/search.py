"""Shift searches of the registration toolkit, batched on the device.

The counterpart of ``highresnet_tpu/registration/search.py``:

- ``compute_shift_ncc``: coarse-to-fine grid search maximising the exact
  masked NCC under each candidate's combined mask (-inf where it is
  undefined), scale factor from ``points_per_dim - 2``;
- ``compute_shift_with_metric``: the same search over a metric, scale
  factor from ``points_per_dim - 1``, NaN scores counted as the worst;
- ``compute_shift_pl``: the same search minimising the masked VGG
  perceptual loss, each level's candidates featurised in two batched
  forwards (the reference stack under each candidate's mask, then the
  warped stack);
- ``compute_shift_pcc``: phase cross-correlation, sub-pixel by a
  matrix-DFT zoom at 1/1000 px (``_pcc``);
- ``compute_shift_point_matching``: ORB keypoints and a RANSAC translation
  (OpenCV, on the host);
- ``pcc_align_batch``: each image of a stack PCC-registered onto its anchor
  and warped by ``lanczos_shift_fused`` (the Lanczos kernel K3 on CUDA,
  its plain version on the CPU); the TTA and ensemble alignment.

Each grid level warps all ``points_per_dim``² candidates in one batched
warp and scores them in one call. Level bounds are best ± scale^level,
from a first width of 2 px; ``max_recursions`` levels always run. The grid
is JAX's ``linspace`` formula in float32; XLA reassociates it and contracts
it to FMAs when it compiles it, so the values agree with JAX's within one
float32 ulp of the grid's magnitude, not bit for bit. Ties go to the first
index, as in JAX. numpy inputs go to ``device``; tensors
stay on their own device.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from highresnet_tpu_torch.ops.lanczos_fused import lanczos_shift_fused
from highresnet_tpu_torch.registration import metrics as rm
from highresnet_tpu_torch.registration.warp import (
    cubic_shift_batch,
    linear_shift_batch,
    shift_template_batch,
)
from highresnet_tpu_torch.runtime import as_tensor


@torch.inference_mode()
def apply_shift_to_template(shift_x: float, shift_y: float, template_image, template_mask,
                            device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """One template and mask warped by (dx, dy), note the (x, y) order:
    (image, mask) tensors; the mask is in [0, 1], binarised by the caller."""
    img = as_tensor(template_image, device)
    shifts = torch.tensor([[shift_y, shift_x]], dtype=torch.float32, device=img.device)
    warped = cubic_shift_batch(img[None], shifts)[0]
    mask = linear_shift_batch(as_tensor(template_mask, img.device)[None], shifts)[0]
    return warped, mask


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace``'s formula in float32: start·(1 − i/div) + stop·(i/div)
    for i < div = num − 1, then stop itself (``torch.linspace`` uses another)."""
    step = torch.arange(num - 1, dtype=torch.float32, device=start.device) / (num - 1)
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


def _grid(bounds_y, bounds_x, points_per_dim: int) -> torch.Tensor:
    """(P², 2) candidate (dy, dx) shifts, dy major."""
    ys = _linspace(bounds_y[0], bounds_y[1], points_per_dim)
    xs = _linspace(bounds_x[0], bounds_x[1], points_per_dim)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)


def _level_grid(center: torch.Tensor, width: float, points_per_dim: int) -> torch.Tensor:
    half = width / 2
    return _grid((center[0] - half, center[0] + half), (center[1] - half, center[1] + half),
                 points_per_dim)


@torch.inference_mode()
def _mncc_grid_scores(ref, ref_mask, template, template_mask, center, width, points_per_dim):
    """(shifts, scores) of one level: the exact masked NCC of each candidate
    under its combined mask, -inf where it is undefined. Higher is better.

    Like JAX (an intentional fix of the reference, which normalised the
    reference under its full mask), both images are normalised under each
    candidate's combined mask."""
    shifts = _level_grid(center, width, points_per_dim)
    warped, wmasks = shift_template_batch(template, template_mask, shifts)
    scores = rm.masked_ncc(ref, warped, ref_mask, wmasks)
    return shifts, torch.where(torch.isnan(scores), -torch.inf, scores)


@torch.inference_mode()
def _metric_grid_scores(metric_fn, ref, ref_mask, template, template_mask, center, width,
                        points_per_dim, **metric_kwargs):
    """(shifts, scores) of one level under ``metric_fn``: the port's batched
    metrics score the whole stack in one call on its device; any other
    callable gets numpy arrays, one candidate at a time, on the host."""
    shifts = _level_grid(center, width, points_per_dim)
    warped, wmasks = shift_template_batch(template, template_mask, shifts)
    if metric_fn in rm.BATCHED_METRICS:
        return shifts, metric_fn(ref, warped, ref_mask, wmasks, **metric_kwargs)
    ref_np, rmask_np = ref.cpu().numpy(), ref_mask.cpu().numpy()
    warped_np, wmasks_np = warped.cpu().numpy(), wmasks.cpu().numpy()
    scores = [float(metric_fn(ref_np, warped_np[i], rmask_np, wmasks_np[i], **metric_kwargs))
              for i in range(len(warped_np))]
    return shifts, torch.tensor(scores, dtype=torch.float32, device=shifts.device)


@torch.inference_mode()
def _pl_grid_scores(extractor, ref, ref_mask, template, template_mask, center, width,
                    points_per_dim):
    """(shifts, scores) of one level: each candidate's masked perceptual loss
    from two batched VGG forwards. Lower is better."""
    shifts = _level_grid(center, width, points_per_dim)
    warped, wmasks = shift_template_batch(template, template_mask, shifts)
    combined = ref_mask[None] * wmasks  # (N, H, W)
    ref_feats = extractor.features_batched(ref[None] * combined)
    mov_feats = extractor.features_batched(warped * combined)
    total = 0.0
    wsum = 0.0
    for i, name in enumerate(sorted(ref_feats, key=int)):
        rf, mf = ref_feats[name], mov_feats[name]  # (N, C, hf, wf)
        hf, wf = rf.shape[-2:]
        ys = rm.nearest_indices(combined.shape[1], hf, combined.device)
        xs = rm.nearest_indices(combined.shape[2], wf, combined.device)
        mr = combined[:, ys][:, :, xs][:, None]  # (N, 1, hf, wf)
        nvalid = torch.sum(mr, dim=(1, 2, 3)) * rf.shape[1]
        l1 = torch.sum(torch.abs(rf * mr - mf * mr), dim=(1, 2, 3))
        w = rm.LAYER_WEIGHTS[min(i, len(rm.LAYER_WEIGHTS) - 1)]
        total = total + w * l1 / torch.clamp(nvalid, min=1.0)
        wsum += w
    return shifts, total / wsum


def _scale_factor(points_per_dim: int, minus: int) -> float:
    sf = 1.0 / (points_per_dim - minus)
    return min(max(sf, 0.25), 0.9) if sf < 1.0 else 0.9


def _search(level_scores: Callable, sf: float, max_recursions: int, device,
            minimize: bool) -> Tuple[float, float]:
    """Coarse to fine: each level's best candidate centres the next level,
    of width 2·sf^level; NaN scores count as the worst. One host read, at
    the end."""
    best = torch.zeros(2, dtype=torch.float32, device=device)
    for level in range(max_recursions):
        shifts, scores = level_scores(best, 2.0 * sf**level)
        if minimize:
            best = shifts[torch.argmin(torch.where(torch.isnan(scores), torch.inf, scores))]
        else:
            best = shifts[torch.argmax(torch.where(torch.isnan(scores), -torch.inf, scores))]
    dy, dx = best.tolist()
    return float(dy), float(dx)


@torch.inference_mode()
def compute_shift_ncc(ref_image, template_image, ref_mask, template_mask,
                      points_per_dim: int = 7, max_recursions: int = 10,
                      device="cuda") -> Tuple[float, float]:
    """Best (dy, dx) maximising the masked NCC; applied to the template
    (``apply_shift_to_template``) it aligns the template to the reference."""
    if points_per_dim < 3:
        raise ValueError("points_per_dim must be at least 3")
    if max_recursions < 3:
        raise ValueError("max_recursions must be at least 3")
    ref, template, rmask, tmask = rm.as_tensors(ref_image, template_image, ref_mask,
                                                template_mask, device)
    wsum = float(torch.sum(rmask))
    if wsum == 0:
        return 0.0, 0.0
    sig = float(torch.sqrt(torch.sum(rmask * torch.square(ref - torch.sum(ref * rmask) / wsum))
                           / wsum))
    if sig == 0:
        return 0.0, 0.0
    return _search(
        lambda center, width: _mncc_grid_scores(ref, rmask, template, tmask, center, width,
                                                points_per_dim),
        _scale_factor(points_per_dim, minus=2), max_recursions, ref.device, minimize=False,
    )


@torch.inference_mode()
def compute_shift_with_metric(metric_fn: Callable, minimize: bool = True, ref_image=None,
                              template_image=None, ref_mask=None, template_mask=None,
                              points_per_dim: int = 7, max_recursions: int = 10,
                              device="cuda", **metric_kwargs) -> Tuple[float, float]:
    """Coarse-to-fine search over a masked metric,
    ``metric_fn(ref, mov, ref_mask, mov_mask, **metric_kwargs)``.

    The port's own metrics (``metrics.BATCHED_METRICS``: masked NCC, MSE,
    mean L1 error, SSIM, MI) score each level's whole candidate stack in one
    call on the inputs' device. Any other callable takes the host route: it
    is called once per candidate on numpy arrays and must return a scalar.
    The choice is made by identity, never by catching an error."""
    ref, template, rmask, tmask = rm.as_tensors(ref_image, template_image, ref_mask,
                                                template_mask, device)
    return _search(
        lambda center, width: _metric_grid_scores(metric_fn, ref, rmask, template, tmask,
                                                  center, width, points_per_dim,
                                                  **metric_kwargs),
        _scale_factor(points_per_dim, minus=1), max_recursions, ref.device, minimize,
    )


@torch.inference_mode()
def compute_shift_pl(extractor, ref_image, template_image, ref_mask, template_mask,
                     points_per_dim: int = 7, max_recursions: int = 10,
                     device="cuda") -> Tuple[float, float]:
    """Coarse-to-fine search minimising the masked VGG perceptual loss;
    ``extractor`` (``models.vgg.VGGFeatureExtractor``) must be on the
    inputs' device."""
    ref, template, rmask, tmask = rm.as_tensors(ref_image, template_image, ref_mask,
                                                template_mask, device)
    return _search(
        lambda center, width: _pl_grid_scores(extractor, ref, rmask, template, tmask, center,
                                              width, points_per_dim),
        _scale_factor(points_per_dim, minus=1), max_recursions, ref.device, minimize=True,
    )


# ---------------------------------------------------------------------------
# Phase cross-correlation (Guizar-Sicairos upsampled-DFT refinement)
# ---------------------------------------------------------------------------

def _pcc(ref: torch.Tensor, mov: torch.Tensor, upsample_factor: int = 1000) -> torch.Tensor:
    """(B, H, W) pairs -> (B, 2) shifts (dy, dx) with mov(i) == ref(i + d).

    Per pair: the whitened cross-power spectrum with its Nyquist row and
    column zeroed for even sizes, the coarse integer peak of its inverse
    FFT, then a matrix-DFT zoom of a 1.5 px window around that peak at
    ``1 / upsample_factor`` px. complex64 throughout; the zoom's two
    products are batched complex matrix products."""
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


@torch.inference_mode()
def compute_shift_pcc(ref_image, shifted_image, ref_mask=None, shifted_mask=None,
                      device="cuda") -> Tuple[float, float]:
    """Fourier-domain shift estimate to 1/1000 px. The masks are accepted
    for the signature and unused, as in the reference (masked FFT inputs
    proved unreliable there); the images are not windowed, as in JAX."""
    ref = as_tensor(ref_image, device)
    dy, dx = _pcc(ref[None], as_tensor(shifted_image, ref.device)[None])[0].tolist()
    return float(dy), float(dx)


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


def compute_shift_point_matching(ref_image, tmplt_image, n_keypoints: int = 500,
                                 match_threshold: float = 0.75, ransac_threshold: float = 2.0,
                                 scale: int = 4) -> Tuple[float, float]:
    """ORB keypoints and a RANSAC translation at ``scale``x resolution, on
    the host (OpenCV): cubic up-resize, ORB detect and describe,
    cross-checked Hamming matches, RANSAC partial affine, its translation
    divided back by ``scale``. Tensors are read back to the host."""
    import cv2

    def prep(img):
        if isinstance(img, torch.Tensor):
            img = img.cpu().numpy()
        img = np.asarray(img, np.float32)
        rng = img.max() - img.min()
        u8 = ((img - img.min()) / (rng if rng > 0 else 1.0) * 255).astype(np.uint8)
        h, w = img.shape
        return cv2.resize(u8, (w * scale, h * scale), interpolation=cv2.INTER_CUBIC)

    im1, im2 = prep(ref_image), prep(tmplt_image)
    orb = cv2.ORB_create(nfeatures=n_keypoints, fastThreshold=10)
    k1, d1 = orb.detectAndCompute(im1, None)
    k2, d2 = orb.detectAndCompute(im2, None)
    if d1 is None or d2 is None or len(k1) < 4 or len(k2) < 4:
        raise ValueError("Not enough keypoints found for reliable alignment.")

    matcher = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
    matches = matcher.match(d1, d2)
    if len(matches) < 4:
        raise ValueError("Not enough matches found for reliable alignment.")

    src = np.float32([k2[m.trainIdx].pt for m in matches]).reshape(-1, 1, 2)
    dst = np.float32([k1[m.queryIdx].pt for m in matches]).reshape(-1, 1, 2)
    mat, _ = cv2.estimateAffinePartial2D(
        src, dst, method=cv2.RANSAC, ransacReprojThreshold=ransac_threshold, maxIters=1000
    )
    if mat is None:
        raise ValueError("RANSAC failed to find a robust model.")
    shift_x, shift_y = float(mat[0, 2]), float(mat[1, 2])
    return shift_y / scale, shift_x / scale
