"""ShiftNet (HighRes-net's registration network) in plain PyTorch.

forward(params, pairs (B, 2, S, S), keep (B, F) or None) -> (B, 2) (dx, dy):
the per-channel spatial mean removed, 8 conv3x3 + BatchNorm (batch
statistics, biased variance, eps 1e-5) + ReLU layers of widths 64, 64, 64,
64, 128, 128, 128, 128 with a 2x2 max pool after layers 2, 4 and 6, a
channel-major flatten, inverted dropout at rate 0.5 by the ``keep`` mask,
fc1 (128·(S/8)² -> 1024) + ReLU and a bias-free fc2 (1024 -> 2).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference.hrnet import Spec
from perfbench.reference.ops import Ops

WIDTHS = (64, 64, 64, 64, 128, 128, 128, 128)
POOLS = (False, True, False, True, False, True, False, False)
BN_EPS = 1e-5
DROPOUT = 0.5


def param_spec(register_size: int) -> Spec:
    spec: Spec = []
    c_in = 2
    for i, c in enumerate(WIDTHS, start=1):
        spec.append((f"layer{i}.0.weight", (c, c_in, 3, 3), "kernel", c_in * 9))
        spec.append((f"layer{i}.0.bias", (c,), "zero", 0))
        spec.append((f"layer{i}.1.weight", (c,), "one", 0))
        spec.append((f"layer{i}.1.bias", (c,), "zero", 0))
        c_in = c
    flat = WIDTHS[-1] * (register_size // 8) ** 2
    spec.append(("fc1.weight", (1024, flat), "kernel", flat))
    spec.append(("fc1.bias", (1024,), "zero", 0))
    spec.append(("fc2.weight", (2, 1024), "zero", 0))
    return spec


def flat_features(register_size: int) -> int:
    return WIDTHS[-1] * (register_size // 8) ** 2


class ShiftNet:
    def __init__(self, ops: Ops | None = None):
        self.ops = ops or Ops()

    def __call__(self, p: Dict[str, torch.Tensor], x: torch.Tensor,
                 keep: torch.Tensor | None) -> torch.Tensor:
        x = x - x.mean(dim=(2, 3), keepdim=True)
        for i, pool in enumerate(POOLS, start=1):
            x = self.ops.conv2d(x, p[f"layer{i}.0.weight"], p[f"layer{i}.0.bias"], padding=1)
            mean = x.mean(dim=(0, 2, 3), keepdim=True)
            var = torch.square(x - mean).mean(dim=(0, 2, 3), keepdim=True)
            x = (x - mean) * torch.rsqrt(var + BN_EPS)
            x = x * p[f"layer{i}.1.weight"][None, :, None, None] \
                + p[f"layer{i}.1.bias"][None, :, None, None]
            x = F.relu(x)
            if pool:
                x = F.max_pool2d(x, 2)
        x = x.flatten(1)
        if keep is not None:
            x = torch.where(keep, x / (1.0 - DROPOUT), torch.zeros_like(x))
        x = F.relu(self.ops.linear(x, p["fc1.weight"], p["fc1.bias"]))
        return self.ops.linear(x, p["fc2.weight"])
