"""VGG19 feature extractor for the perceptual metrics, in NCHW.

The counterpart of ``highresnet_tpu/models/vgg.py``: VGG19's conv stack up
to ``features[28]``, tapping the conv outputs (before their ReLU) at the
torchvision feature indices {0, 5, 10, 19, 28}, with grayscale -> RGB
replication and ImageNet normalisation. The module keeps torchvision's
layout (``features.<index>`` holds each conv), so a torchvision ``vgg19``
state dict loads by name.

Taps are NCHW, (B, C, h, w); the JAX extractor returns NHWC.

Weights load from a torchvision-style state dict, as ``.pth`` or ``.npz``
(``cli.export_vgg_weights`` writes one), or from the JAX extractor's flax
params through ``models.convert.vgg_state_dict_from_flax``. Without a file
the convs are drawn from a seeded ``torch.Generator`` on the CPU (lecun
normal kernels, zero biases, flax's defaults), so every device gets the
same weights from one seed.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from highresnet_tpu_torch.models.layers import lecun_normal_
from highresnet_tpu_torch.runtime import as_tensor, resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# (out_channels, tap?) per conv; "M" is a 2x2 max-pool
_VGG19_PLAN = [
    (64, True), (64, False), "M",
    (128, True), (128, False), "M",
    (256, True), (256, False), (256, False), (256, False), "M",
    (512, True), (512, False), (512, False), (512, False), "M",
    (512, True),
]
TAP_NAMES = ["0", "5", "10", "19", "28"]


def _features() -> nn.Sequential:
    """torchvision's vgg19.features[:29]: conv, ReLU, ..., ending on conv 28."""
    layers, in_ch = [], 3
    for item in _VGG19_PLAN:
        if item == "M":
            layers.append(nn.MaxPool2d(2, 2))
            continue
        layers += [nn.Conv2d(in_ch, item[0], 3, padding=1), nn.ReLU()]
        in_ch = item[0]
    return nn.Sequential(*layers[:-1])


def _conv_specs() -> list:
    """(torchvision index, in_channels, out_channels) of each conv."""
    specs, index, in_ch = [], 0, 3
    for item in _VGG19_PLAN:
        if item == "M":
            index += 1
            continue
        specs.append((index, in_ch, item[0]))
        in_ch = item[0]
        index += 2  # the conv and its ReLU
    return specs


CONV_SPECS = _conv_specs()
CONV_INDICES = [index for index, _, _ in CONV_SPECS]


class VGG19Features(nn.Module):
    """Truncated VGG19 returning its tapped conv outputs by torchvision index."""

    def __init__(self):
        super().__init__()
        self.features = _features()

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        taps: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self.features):
            x = layer(x)
            if str(i) in TAP_NAMES:
                taps[str(i)] = x
        return taps


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> ImageNet-normalised."""
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return (x - mean) / std


def preprocess(img: torch.Tensor) -> torch.Tensor:
    """Grayscale (H, W) or (H, W, C) -> normalised (1, 3, H, W)."""
    img = img.to(torch.float32)
    if img.dim() == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = img.expand(*img.shape[:-1], 3)
    return _normalize(img.permute(2, 0, 1)[None])


def state_from_file(weights_path: str) -> Dict[str, torch.Tensor]:
    """A torchvision-style vgg19 state dict (``features.N.weight`` or
    ``N.weight`` keys, .pth or .npz) -> this module's convs, by index."""
    if weights_path.endswith(".npz"):
        with np.load(weights_path) as f:
            raw = {k: torch.from_numpy(f[k]) for k in f.files}
    else:
        raw = torch.load(weights_path, map_location="cpu", weights_only=True)
    state = {}
    for key, value in raw.items():
        parts = key.split(".")
        index = parts[1] if parts[0] == "features" and len(parts) == 3 else parts[0]
        if index.isdigit() and int(index) in CONV_INDICES:
            state[f"features.{index}.{parts[-1]}"] = torch.as_tensor(value, dtype=torch.float32)
    return state


def seeded_state(seed: int) -> Dict[str, torch.Tensor]:
    """Lecun-normal kernels (a normal truncated at 2 std, flax's default)
    and zero biases, drawn on the CPU from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    state = {}
    for index, in_ch, out_ch in CONV_SPECS:
        weight = lecun_normal_(torch.empty(out_ch, in_ch, 3, 3), in_ch * 9, g)
        state[f"features.{index}.weight"] = weight
        state[f"features.{index}.bias"] = torch.zeros(out_ch)
    return state


class VGGFeatureExtractor:
    """Frozen extractor: taps of one image (``__call__``) or a stack
    (``features_batched``), under inference mode. Taps are NCHW."""

    def __init__(self, weights_path: Optional[str] = None, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        state = state_from_file(weights_path) if weights_path else seeded_state(seed)
        with torch.device("meta"):  # no init draws: the state replaces every parameter
            self.module = VGG19Features()
        self.module.load_state_dict(state, assign=True)
        self.module.to(self.device).eval().requires_grad_(False)

    @torch.inference_mode()
    def __call__(self, img) -> Dict[str, torch.Tensor]:
        """(H, W) grayscale (or (H, W, 3)) -> taps of shape (1, C, h, w)."""
        return self.module(preprocess(as_tensor(img, self.device)))

    @torch.inference_mode()
    def features_batched(self, imgs) -> Dict[str, torch.Tensor]:
        """(B, H, W) grayscale -> taps of shape (B, C, h, w)."""
        x = as_tensor(imgs, self.device)
        return self.module(_normalize(x[:, None].expand(-1, 3, -1, -1)))
