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
and ``grad_norm`` (of the gradients before any clipping). Each step's
tensors are its own: a later step does not overwrite them. On a card the
step runs as three CUDA graphs from the second step of each input shape
on (``train/graphs.py``); the CPU and a synced step run eagerly.

A synced ``layout`` (``parallel/mesh.py::DataParallel``) builds the step of
one process of a multi-process run, on its replica's shard of the global
batch, so that the ranks together take the step one process takes on the
whole batch: ShiftNet sees the global batch (``ShiftNet.sync_batch`` over
the data group), the shift penalty squares the mean over every replica's
shifts, the gradients are averaged over all ranks in one flat all-reduce
before the global norm, clip and Adam, and the metrics are global (loss
and mean shift averaged over the data group, max shift its max).

With a view axis (``layout.view`` M > 1) HRNet splits the views over the
view group (``HRNet.shard_views``) and the rest of the step runs replicated
on the M view ranks of a replica. Every rank backpropagates its own,
unscaled loss; ``gather_views``' backward sums over the view group, so an
encoder or fusion gradient is M times the rank's share of the replica's
gradient and a tail gradient (decoder, ShiftNet) M-fold replicated. Either
way the mean over all D·M ranks is the mean over the D replicas of their
whole-batch gradients: the one-process gradient.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from highresnet_tpu_torch.models.hrnet import HRNet
from highresnet_tpu_torch.models.shiftnet import ShiftNet
from highresnet_tpu_torch.ops.lanczos_fused import training_warp
from highresnet_tpu_torch.ops.losses import LOSS_METRICS, crop_mask, registered_loss
from highresnet_tpu_torch.ops.metrics import shift_cpsnr_batch
from highresnet_tpu_torch.parallel import distributed
from highresnet_tpu_torch.parallel.mesh import DataParallel
from highresnet_tpu_torch.train.graphs import GraphedStep, eligible, step_key
from highresnet_tpu_torch.train.state import TrainState, clip_by_global_norm_, global_norm
from highresnet_tpu_torch.utils.profiling import span

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


def global_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of x over the elements of every rank of ``group`` (equal shards),
    differentiable."""
    return distributed.all_reduce_sum(torch.mean(x), group) / distributed.process_count(group)


def build_train_step(config: Dict[str, Any], layout: Optional[DataParallel] = None) -> Callable:
    """Returns step(state, lrs, alphas, hrs, hr_maps) -> (state, metrics);
    the batch tensors are on the state's device. Without a synced
    ``layout`` the step is one process's."""
    synced = layout is not None and layout.synced
    data_group, view_group = (layout.data_group, layout.view_group) if synced else (None, None)
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
        with span("train.step.forward"):
            srs = state.hrnet(lrs, alphas)
        if register:
            with span("train.step.register"):
                warped, thetas = register_and_warp(
                    state.shiftnet, srs, hrs, offset, state.generator, register_size,
                    use_pallas_warp, warp_int_range,
                )
        else:  # unregistered arm: raw SR vs HR, no shift penalty term
            warped, thetas = srs, srs.new_zeros((srs.shape[0], 2))
        with span("train.step.loss"):
            if hrs.device not in masks:
                masks[hrs.device] = border_mask.to(hrs.device)
            mask = masks[hrs.device][None] * hr_maps
            mean = (lambda x: global_mean(x, data_group)) if synced else torch.mean
            loss = registered_loss(warped, hrs, mask, thetas, lam, metric=loss_metric, mean=mean)
            if range_penalty > 0:
                overflow = F.relu(srs - 1.0) + F.relu(-srs)
                loss = loss + range_penalty * torch.mean(overflow.float())
        return loss, thetas

    graphed = GraphedStep()

    def zero_grads(state: TrainState, params) -> None:
        # every parameter gets a gradient, zero where unused (the unregistered
        # arm's ShiftNet), so Adam's moments and step count advance for all
        # of them, as optax's do
        with span("train.step.zero_grad"):
            state.optimizer.zero_grad(set_to_none=False)
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)

    def forward_to_clip(state: TrainState, params, lrs, alphas, hrs, hr_maps):
        loss, thetas = loss_fn(state, lrs, alphas, hrs, hr_maps)
        with span("train.step.backward"):
            loss.backward()
        grads = [p.grad for p in params]
        if synced:
            distributed.reduce_gradients_(grads)
        with span("train.step.clip"):
            grad_norm = global_norm(grads)
            if state.grad_clip_norm > 0:
                clip_by_global_norm_(grads, state.grad_clip_norm, grad_norm)
        thetas = thetas.detach()
        loss, mean_abs, max_abs = loss.detach(), thetas.abs().mean(), thetas.abs().max()
        if synced:
            loss, mean_abs = distributed.all_reduce_mean(torch.stack([loss, mean_abs]), data_group)
            max_abs = distributed.all_reduce_max(max_abs, data_group)
        return {
            "loss": loss,
            "mean_abs_shift": mean_abs,
            "max_abs_shift": max_abs,
            "grad_norm": grad_norm.detach(),
        }

    def update(state: TrainState) -> None:
        with span("train.step.optimizer"):
            state.optimizer.step()
        if ema_decay > 0:
            with span("train.step.ema"), torch.no_grad():
                for name, model in (("hrnet", state.hrnet), ("shiftnet", state.shiftnet)):
                    ema = state.ema[name]
                    for k, p in model.named_parameters():
                        ema[k].add_((p - ema[k]) * (1.0 - ema_decay))

    def step(state: TrainState, lrs, alphas, hrs, hr_maps):
        state.hrnet.train()
        state.shiftnet.train()
        state.hrnet.shard_views(view_group)
        state.shiftnet.sync_batch(synced, data_group)
        params = [p for group in state.optimizer.param_groups for p in group["params"]]
        batch = (lrs, alphas, hrs, hr_maps)
        metrics = None
        if eligible(lrs.device, synced):  # through CUDA graphs (train/graphs.py)
            mode = (state.grad_clip_norm, state.shiftnet.dropout)
            warm = (len(state.optimizer.state) == len(params)
                    and all(p.grad is not None for p in params))
            metrics = graphed(
                step_key(batch, mode, state.generator), warm,
                (state.optimizer.state, *params, *(p.grad for p in params)),
                batch, state.generator, lambda: zero_grads(state, params),
                lambda *b: forward_to_clip(state, params, *b), lambda: update(state))
        if metrics is None:
            zero_grads(state, params)
            metrics = forward_to_clip(state, params, *batch)
            update(state)
        state.step += 1
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
