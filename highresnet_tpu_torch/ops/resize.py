"""JAX's cubic resize, ``jax.image.resize(method="cubic")``, on tensors.

``F.interpolate(mode="bicubic")`` is another function: it uses a = -0.75
and clamps taps to the border, and differs from JAX's by up to 0.075 at
16 -> 48 px, interior pixels included (ROADMAP hazard H2). This module
rebuilds JAX's separable weight matrices (``jax/_src/image/scale.py``,
``compute_weight_mat``) and applies them as two matrix products:

- the Keys cubic kernel with a = -0.5;
- half-pixel centres: output pixel ``i`` samples the input at
  ``(i + 0.5) / scale - 0.5``, a position JAX holds in float32. XLA's
  compiled code rounds it once (a fused multiply-add) at the widths
  measured for serving (384 px and every output of 90 px or more on the
  CPU backend), and so does this module; a constant-folded JAX program
  rounds the product and the difference apart, which moves a weight by up
  to 1.3e-6. The weights themselves are computed in float64;
- the kernel widened by ``1 / scale`` when shrinking (``antialias``, on by
  default in ``jax.image.resize``);
- only taps inside the image: their weights are renormalised by their sum
  (set to 0 where the sum is within 1000 float32 epsilons of 0), and an
  output whose sample lies outside ``[-0.5, in - 0.5]`` gets no weight.

An axis whose size does not change is left as it is, as in JAX. The
products run in float32; on CUDA they need TF32 off (``runtime.setup_device``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    x = x.abs()
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, 0.0, torch.where(x >= 1.0, far, near))


def cubic_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) float32 weights: output j = sum_i in[i] * w[i, j]."""
    scale = n_out / n_in
    inv_scale = float(np.float32(1.0 / scale))  # JAX's float32 constant
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64) + 0.5) * inv_scale - 0.5
    sample = sample.to(torch.float32).to(torch.float64)  # one rounding
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float64)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(torch.float32)


def resize_cubic(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize the last two axes of a float32 ``img`` (..., H, W) to ``size``."""
    h, w = img.shape[-2:]
    out_h, out_w = size
    img = img.to(torch.float32)
    if out_h != h:
        img = torch.matmul(cubic_weights(h, out_h).to(img.device).T, img)
    if out_w != w:
        img = torch.matmul(img, cubic_weights(w, out_w).to(img.device))
    return img
