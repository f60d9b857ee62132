"""ShiftNet warm-start: supervised pretraining on known synthetic shifts.

The counterpart of ``highresnet_tpu/train/pretrain.py``. Joint training
from scratch fails to bootstrap at multi-pixel misalignment (the fusion
model blurs before a zero-initialised ShiftNet learns to register), so
ShiftNet first regresses known offsets: each step takes a pool crop
``moving``, draws ``d = (dy, dx)``, warps ``ref = lanczos_shift(moving, d)``
with the warp the registered loss will use, and fits ShiftNet's output on
the pair ``[ref, moving]`` to ``flip(d) = (dx, dy)``, the convention
``train/step.py::register_and_warp`` consumes.

- ShiftNet is in train mode: its BatchNorm statistics update, and its
  dropout draws from a generator on the model's device, seeded from the
  given CPU generator, which also draws the crops and the offsets.
- A fresh Adam over ShiftNet alone with optax.adam's constants
  (``train/state.py::make_optimizer``).
- ``pretrain_step`` is one step as a function of its draws (``idx``,
  ``d``), so a test can feed the JAX step the same draws.
- The warp is the train step's (``ops/lanczos_fused.py::training_warp``):
  ``warp_int_range > 0`` takes the plain extended-range warp; otherwise
  ``use_pallas_warp`` takes the fused warp (K3 on CUDA) and the plain warp
  is used without it.
"""

from __future__ import annotations

import numpy as np
import torch

from highresnet_tpu_torch.data.probav import read_imageset
from highresnet_tpu_torch.models.shiftnet import ShiftNet
from highresnet_tpu_torch.ops.lanczos_fused import training_warp
from highresnet_tpu_torch.train.state import make_optimizer


def hr_crop_pool(
    scene_dirs, register_size: int, max_scenes: int = 64, top_k: int = 1, beta: float = 50.0
) -> np.ndarray:
    """(N, register_size, register_size) float32 central HR crops of the
    first ``max_scenes`` scenes; scenes whose HR is missing or smaller than
    ``register_size`` are skipped."""
    crops = []
    for d in scene_dirs[:max_scenes]:
        s = read_imageset(d, top_k=top_k, beta=beta, create_patches=False)
        if s.hr is None:
            continue
        h, w = s.hr.shape
        if h < register_size or w < register_size:
            continue
        y0 = (h - register_size) // 2
        x0 = (w - register_size) // 2
        crops.append(np.asarray(s.hr[y0 : y0 + register_size, x0 : x0 + register_size], np.float32))
    if not crops:
        raise ValueError(
            f"no usable HR crops of size {register_size} among the first "
            f"{max_scenes} scenes (HRs too small or missing)"
        )
    return np.stack(crops)


def warm_start_pairs(
    pool: torch.Tensor, idx: torch.Tensor, d: torch.Tensor, warp_int_range: int = 0,
    use_pallas_warp: bool = False,
) -> torch.Tensor:
    """(B, 2, H, W) pairs [lanczos_shift(moving, d), moving] of the crops ``idx``,
    warped by the train step's warp (``training_warp``)."""
    moving = pool[idx]
    return torch.stack([training_warp(moving, d, warp_int_range, use_pallas_warp), moving], dim=1)


def pretrain_step(
    shiftnet: ShiftNet, opt: torch.optim.Optimizer, pool: torch.Tensor, idx: torch.Tensor,
    d: torch.Tensor, generator: torch.Generator | None, warp_int_range: int = 0,
    use_pallas_warp: bool = False,
) -> torch.Tensor:
    """One Adam step on the drawn crops ``idx`` (B,) and offsets ``d`` (B, 2)
    (dy, dx), on the pool's device; returns the step's loss (mean squared
    shift error, before the update) as a device tensor."""
    with torch.no_grad():
        pairs = warm_start_pairs(pool, idx, d, warp_int_range, use_pallas_warp)
    target = torch.flip(d, dims=(-1,))  # theta = (dx, dy)
    opt.zero_grad(set_to_none=False)
    loss = torch.mean(torch.square(shiftnet(pairs, generator) - target))
    loss.backward()
    opt.step()
    return loss.detach()


def pretrain_shiftnet(
    shiftnet: ShiftNet,
    images: np.ndarray,
    generator: torch.Generator,
    steps: int = 200,
    sigma: float = 1.5,
    max_shift: float = 3.0,
    lr: float = 1e-4,
    batch_size: int = 32,
    warp_int_range: int = 0,
    use_pallas_warp: bool = False,
) -> float:
    """Warm-start ``shiftnet`` in place on the (N, H, W) ``images`` (H, W the
    register size) and return the last step's shift RMSE in px.

    ``generator`` (CPU) draws each step's crops (with replacement) and its
    Gaussian offsets of std ``sigma`` clipped to ±``max_shift`` (the
    registered loss's accurate warp window), and seeds the dropout masks."""
    if images.ndim != 3:
        raise ValueError(f"images must be (N, H, W), got {images.shape}")
    device = next(shiftnet.parameters()).device
    pool = torch.from_numpy(np.asarray(images, np.float32)).to(device)
    shiftnet.train()
    opt = make_optimizer(list(shiftnet.parameters()), lr)
    dropout_seed = int(torch.randint(2**62, (1,), generator=generator))
    drop = torch.Generator(device=device).manual_seed(dropout_seed)
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        idx = torch.randint(pool.shape[0], (batch_size,), generator=generator)
        d = torch.clamp(sigma * torch.randn((batch_size, 2), generator=generator),
                        -max_shift, max_shift)
        loss = pretrain_step(shiftnet, opt, pool, idx.to(device), d.to(device), drop,
                             warp_int_range, use_pallas_warp)
    return float(torch.sqrt(loss))
