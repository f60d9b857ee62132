"""Train and eval steps.

The counterpart of ``highresnet_tpu/train/step.py`` (no mesh):

  1. HRNet forward on the (B, L, h, w) batch;
  2. ShiftNet registers each SR frame against its HR on the central
     ``register_size`` crops;
  3. the SR frame is Lanczos-warped by the predicted shift: the plain warp,
     its ``warp_int_range`` form, or with ``training.use_pallas_warp`` the
     fused warp (K3 on CUDA);
  4. loss = mean(criterion(warped, hr, border-cropped mask))
          + lambda · mean(shifts)² [+ range_penalty · mean overflow],
     one Adam step over both models, then the EMA update.

The step updates the state in place and returns its metrics as device
tensors (no host sync): ``loss``, ``mean_abs_shift``, ``max_abs_shift``
and ``grad_norm`` (of the gradients before any clipping).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from highresnet_tpu_torch.models.hrnet import HRNet
from highresnet_tpu_torch.models.shiftnet import ShiftNet
from highresnet_tpu_torch.ops.lanczos_fused import training_warp
from highresnet_tpu_torch.ops.losses import LOSS_METRICS, crop_mask, registered_loss
from highresnet_tpu_torch.ops.metrics import shift_cpsnr_batch
from highresnet_tpu_torch.train.state import TrainState, clip_by_global_norm_, global_norm

REGISTER_SIZE = 128  # default ShiftNet input crop (the reference's fc geometry)


def register_and_warp(
    shiftnet: ShiftNet,
    srs: torch.Tensor,
    hrs: torch.Tensor,
    offset: int,
    generator: torch.Generator | None,
    register_size: int = REGISTER_SIZE,
    use_pallas_warp: bool = False,
    warp_int_range: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shift per SR image against its HR; returns (warped SR, thetas)."""
    crop = slice(offset, offset + register_size)
    pairs = torch.stack([hrs[:, crop, crop], srs[:, crop, crop]], dim=1)  # [reference, moving]
    thetas = shiftnet(pairs, generator)
    shifts = torch.flip(thetas, dims=(-1,))  # the net predicts (dx, dy); the warp takes (dy, dx)
    return training_warp(srs, shifts, warp_int_range, use_pallas_warp), thetas


def build_train_step(config: Dict[str, Any]) -> Callable:
    """Returns step(state, lrs, alphas, hrs, hr_maps) -> (state, metrics);
    the batch tensors are on the state's device."""
    t = config["training"]
    lam = t["lambda"]
    patch = t["patch_size"]
    register_size = t.get("register_size", REGISTER_SIZE)
    use_pallas_warp = bool(t.get("use_pallas_warp", False))
    warp_int_range = int(t.get("warp_int_range", 0) or 0)
    register = bool(t.get("register", True))
    loss_metric = t.get("loss", "cPSNR")
    if loss_metric not in LOSS_METRICS:
        raise ValueError(
            f"training.loss={loss_metric!r} not in {LOSS_METRICS} "
            "(reference switch: src/train.py:66-87)"
        )
    offset = (3 * patch - register_size) // 2
    if register and offset < 0:
        raise ValueError("3*patch_size must cover the registration crop")
    ema_decay = float(t.get("ema_decay", 0.0) or 0.0)
    if not 0.0 <= ema_decay <= 1.0:
        raise ValueError(f"training.ema_decay must be in [0, 1], got {ema_decay}")
    range_penalty = float(t.get("range_penalty", 0.0) or 0.0)
    border_mask = torch.from_numpy(crop_mask(patch, t["crop"]))
    masks: Dict[torch.device, torch.Tensor] = {}

    def loss_fn(state: TrainState, lrs, alphas, hrs, hr_maps):
        srs = state.hrnet(lrs, alphas)
        if register:
            warped, thetas = register_and_warp(
                state.shiftnet, srs, hrs, offset, state.generator, register_size,
                use_pallas_warp, warp_int_range,
            )
        else:  # unregistered arm: raw SR vs HR, no shift penalty term
            warped, thetas = srs, srs.new_zeros((srs.shape[0], 2))
        if hrs.device not in masks:
            masks[hrs.device] = border_mask.to(hrs.device)
        mask = masks[hrs.device][None] * hr_maps
        loss = registered_loss(warped, hrs, mask, thetas, lam, metric=loss_metric)
        if range_penalty > 0:
            overflow = F.relu(srs - 1.0) + F.relu(-srs)
            loss = loss + range_penalty * torch.mean(overflow.float())
        return loss, thetas

    def step(state: TrainState, lrs, alphas, hrs, hr_maps):
        state.hrnet.train()
        state.shiftnet.train()
        params = [p for group in state.optimizer.param_groups for p in group["params"]]
        # every parameter gets a gradient, zero where unused (the unregistered
        # arm's ShiftNet), so Adam's moments and step count advance for all
        # of them, as optax's do
        state.optimizer.zero_grad(set_to_none=False)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss, thetas = loss_fn(state, lrs, alphas, hrs, hr_maps)
        loss.backward()
        grads = [p.grad for p in params]
        grad_norm = global_norm(grads)
        if state.grad_clip_norm > 0:
            clip_by_global_norm_(grads, state.grad_clip_norm, grad_norm)
        state.optimizer.step()
        if ema_decay > 0:
            with torch.no_grad():
                for name, model in (("hrnet", state.hrnet), ("shiftnet", state.shiftnet)):
                    ema = state.ema[name]
                    for k, p in model.named_parameters():
                        ema[k].add_((p - ema[k]) * (1.0 - ema_decay))
        state.step += 1
        thetas = thetas.detach()
        metrics = {
            "loss": loss.detach(),
            "mean_abs_shift": thetas.abs().mean(),
            "max_abs_shift": thetas.abs().max(),
            "grad_norm": grad_norm.detach(),
        }
        return state, metrics

    return step


def build_eval_step(hrnet: HRNet) -> Callable:
    """Returns step(params_hrnet, lrs, alphas, hrs, hr_maps) -> (srs, scores):
    the SR forward with the given weights and the 7x7 shift-search cPSNR of
    the clipped SR, both on the device."""

    def step(params_hrnet, lrs, alphas, hrs, hr_maps):
        hrnet.eval()
        with torch.inference_mode():
            srs = torch.func.functional_call(hrnet, params_hrnet, (lrs, alphas))
            scores = shift_cpsnr_batch(srs.clamp(0.0, 1.0), hrs, hr_maps)
        return srs, scores

    return step
