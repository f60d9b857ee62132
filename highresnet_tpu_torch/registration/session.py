"""Headless registration session: the Qt app's engine without the widgets.

The counterpart of ``highresnet_tpu/registration/session.py``: load a
reference and template pair, nudge or solve sub-pixel shifts with any of
the seven search methods, accumulate the shift, keep metric histories
(ML1E, PL, SSIM, NMI, NCC), build 8-bit overlays and vote the best shift
across metrics. The images and masks live on the session's device as
float32 tensors; the searches and metrics run there, the overlays and the
ORB point matching on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from highresnet_tpu_torch.registration import metrics as rm
from highresnet_tpu_torch.registration import search as rs
from highresnet_tpu_torch.runtime import as_tensor, resolve_device
from highresnet_tpu_torch.utils.display import compute_sum_of_layers, contrast_stretch_8bit
from highresnet_tpu_torch.utils.imageio import imread_u16

OVERLAY_MODES = (
    "Red-Cyan",
    "Template Only",
    "Reference Only",
    "Blend",
    "Difference",
    "Checkerboard",
    "Masked Difference",
    "Template Mask",
    "Reference Mask",
)

SEARCH_METHODS = (
    "Fourier",
    "Point Matching",
    "NCC",
    "Perceptual Loss",
    "SSIM",
    "Mutual Information",
    "Mean L1 Error",
)

# the searches over one of the port's batched metrics: (metric, minimise?)
_METRIC_METHODS = {
    "SSIM": (rm.masked_ssim, False),
    "Mutual Information": (rm.masked_mi, False),
    "Mean L1 Error": (rm.masked_ml1e, True),
}


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


class RegistrationSession:
    def __init__(self, config: Optional[dict] = None, perceptual_model=None, device="cuda"):
        from highresnet_tpu_torch.config import DEFAULT_REGISTRATION_CONFIG

        self.device = resolve_device(device)
        self.config = dict(DEFAULT_REGISTRATION_CONFIG)
        if config:
            self.config.update(config)
        self.ref_image: Optional[torch.Tensor] = None
        self.ref_mask: Optional[torch.Tensor] = None
        self.template_image: Optional[torch.Tensor] = None
        self.template_mask: Optional[torch.Tensor] = None
        self._perceptual_model = perceptual_model
        self.reset_history()

    # -- loading ---------------------------------------------------------

    def _image_and_mask(self, image, mask) -> Tuple[torch.Tensor, torch.Tensor]:
        image = as_tensor(image, self.device)
        return image, torch.ones_like(image) if mask is None else as_tensor(mask, self.device)

    def _read(self, image_path: str, mask_path: Optional[str]):
        mask = (imread_u16(mask_path) > 0) if mask_path else None
        return self._image_and_mask(imread_u16(image_path), mask)

    def load_reference(self, image_path: str, mask_path: Optional[str] = None):
        self.ref_image, self.ref_mask = self._read(image_path, mask_path)

    def load_template(self, image_path: str, mask_path: Optional[str] = None):
        self.template_image, self.template_mask = self._read(image_path, mask_path)

    def set_arrays(self, ref, template, ref_mask=None, template_mask=None):
        self.ref_image, self.ref_mask = self._image_and_mask(ref, ref_mask)
        self.template_image, self.template_mask = self._image_and_mask(template, template_mask)

    # -- shift state -------------------------------------------------------

    @property
    def current_shift(self) -> Tuple[float, float]:
        return self.config["current_deltay"], self.config["current_deltax"]

    def nudge(self, dy: float = 0.0, dx: float = 0.0):
        """Arrow-key-style incremental nudging."""
        self.config["current_deltay"] += dy
        self.config["current_deltax"] += dx

    def shifted_template(self) -> Tuple[torch.Tensor, torch.Tensor]:
        dy, dx = self.current_shift
        if dy == 0.0 and dx == 0.0:
            return self.template_image, self.template_mask
        img, msk = rs.apply_shift_to_template(dx, dy, self.template_image, self.template_mask)
        return img, (msk > 0.5).to(torch.float32)

    # -- solve -------------------------------------------------------------

    def compute_and_apply_shift(self, method: str = "NCC", **kwargs) -> Tuple[float, float]:
        """Estimate the residual shift with ``method``, add it to the session's
        shift and record the metric history. Returns the new totals."""
        img, msk = self.shifted_template()
        pair = dict(ref_image=self.ref_image, template_image=img, ref_mask=self.ref_mask,
                    template_mask=msk)
        if method == "Fourier":
            dyx = rs.compute_shift_pcc(self.ref_image, img, self.ref_mask, msk)
        elif method == "Point Matching":
            dyx = rs.compute_shift_point_matching(_host(self.ref_image), _host(img), **kwargs)
        elif method == "NCC":
            dyx = rs.compute_shift_ncc(**pair, **kwargs)
        elif method == "Perceptual Loss":
            dyx = rs.compute_shift_pl(self._require_model(), **pair, **kwargs)
        elif method in _METRIC_METHODS:
            metric, minimize = _METRIC_METHODS[method]
            dyx = rs.compute_shift_with_metric(metric, minimize=minimize, **pair, **kwargs)
        else:
            raise ValueError(f"unknown method {method!r}; choose from {SEARCH_METHODS}")

        self.config["current_deltay"] += float(dyx[0])
        self.config["current_deltax"] += float(dyx[1])
        self.record_metrics()
        return self.current_shift

    def _require_model(self):
        if self._perceptual_model is None:
            from highresnet_tpu_torch.models.vgg import VGGFeatureExtractor

            self._perceptual_model = VGGFeatureExtractor(device=self.device)
        return self._perceptual_model

    # -- metric histories + voting -----------------------------------------

    def reset_history(self):
        self.history: Dict[str, List[float]] = {
            "shift_y": [], "shift_x": [], "ml1e": [], "pl": [],
            "ssim": [], "nmi": [], "ncc": [],
        }
        self.last_diff_features: Optional[dict] = None

    def record_metrics(self):
        """Evaluate every metric at the current shift and append it to the history."""
        img, msk = self.shifted_template()
        dy, dx = self.current_shift
        args = (self.ref_image, img, self.ref_mask, msk)
        pl, diffs = rm.perceptual_loss(*args, self._require_model())
        self.last_diff_features = diffs
        self.history["shift_y"].append(dy)
        self.history["shift_x"].append(dx)
        self.history["ml1e"].append(float(rm.masked_ml1e(*args)))
        self.history["pl"].append(pl)
        self.history["ssim"].append(float(rm.masked_ssim(*args)))
        self.history["nmi"].append(float(rm.masked_mi(*args)))
        self.history["ncc"].append(float(rm.masked_ncc(*args)))

    def vote_best_shift(self) -> Tuple[float, float]:
        """Multi-metric vote: each metric votes for the history index where
        it was best (ML1E and PL minimise; SSIM, NMI and NCC maximise); the
        plurality index's shift becomes the current shift."""
        if not self.history["pl"]:
            raise RuntimeError("no shifts recorded yet")
        votes: Dict[int, int] = {}
        for key, best_fn in [
            ("ml1e", np.argmin), ("pl", np.argmin),
            ("ssim", np.argmax), ("nmi", np.argmax), ("ncc", np.argmax),
        ]:
            idx = int(best_fn(self.history[key]))
            votes[idx] = votes.get(idx, 0) + 1
        winner = max(votes.items(), key=lambda kv: kv[1])[0]
        self.config["current_deltay"] = self.history["shift_y"][winner]
        self.config["current_deltax"] = self.history["shift_x"][winner]
        return self.current_shift

    # -- overlays ------------------------------------------------------------

    def overlay(self, mode: str = "Red-Cyan", checker: int = 32) -> np.ndarray:
        """An 8-bit picture of the current alignment, built on the host."""
        img, msk = (_host(t) for t in self.shifted_template())
        ref_mask = _host(self.ref_mask)
        ref8 = contrast_stretch_8bit(_host(self.ref_image))
        tpl8 = contrast_stretch_8bit(img, msk)
        if mode == "Red-Cyan":
            out = np.zeros((*ref8.shape, 3), np.uint8)
            out[..., 0] = tpl8
            out[..., 1] = ref8
            out[..., 2] = ref8
            return out
        if mode == "Template Only":
            return tpl8
        if mode == "Reference Only":
            return ref8
        if mode == "Blend":
            return ((ref8.astype(np.uint16) + tpl8.astype(np.uint16)) // 2).astype(np.uint8)
        if mode == "Difference":
            return np.abs(ref8.astype(np.int16) - tpl8.astype(np.int16)).astype(np.uint8)
        if mode == "Masked Difference":
            d = np.abs(ref8.astype(np.int16) - tpl8.astype(np.int16)).astype(np.uint8)
            return (d * (ref_mask * msk)).astype(np.uint8)
        if mode == "Checkerboard":
            yy, xx = np.indices(ref8.shape)
            board = ((yy // checker + xx // checker) % 2).astype(bool)
            out = ref8.copy()
            out[board] = tpl8[board]
            return out
        if mode == "Template Mask":
            return (msk * 255).astype(np.uint8)
        if mode == "Reference Mask":
            return (ref_mask * 255).astype(np.uint8)
        raise ValueError(f"unknown overlay mode {mode!r}; choose from {OVERLAY_MODES}")

    def vgg_diff_heatmap(self) -> np.ndarray:
        """Summed normalised VGG |diff| heatmap at the current shift."""
        if self.last_diff_features is None:
            self.record_metrics()
        return compute_sum_of_layers(self.last_diff_features)
