"""ShiftNet: sub-pixel pairwise registration network.

The counterpart of ``highresnet_tpu/models/shiftnet.py``: 8 conv + BatchNorm
+ ReLU layers with a 2x2 max pool after layers 2, 4 and 6, the per-channel
spatial mean subtracted from the input, a channel-major flatten, dropout
0.5, ``fc1`` (width from ``register_size``) + ReLU, and a bias-free ``fc2``
initialised to zero (the identity transform at init). 34,187,648
parameters at ``register_size`` 128.

Input is NCHW (B, 2, H, W): channel 0 the reference, channel 1 the moving
image. Submodule names are the reference ``ShiftNet.pth`` keys
(``layerN.0`` conv, ``layerN.1`` BatchNorm, ``fc1``, ``fc2``), which
``highresnet_tpu.models.convert.shiftnet_from_torch`` reads unchanged.

- torch's BatchNorm2d normalises with the biased variance and updates
  ``running_var`` with the unbiased one, the semantics the JAX package's
  ``TorchBatchNorm`` rebuilds; statistics stay float32 under bf16.
- ``F.max_pool2d`` routes a tied maximum's cotangent to one element where
  the JAX reshape-max splits it; ties are measure-zero except post-ReLU
  zeros, whose gradient the ReLU zeroes either way.
- Dropout (rate ``self.dropout``, 0.5) draws its mask from the
  ``torch.Generator`` passed to ``forward`` (train mode only), so a run
  that saves the generator redraws the same masks on resume. Setting the
  attribute to 0 turns it off, as the parity checks do (the frameworks'
  masks cannot agree).
- ``sync_batch()`` makes train mode see the global batch of a data-parallel
  run (each process of ``group`` holds one shard; None: every process):
  BatchNorm over the global batch, and one dropout draw over the global
  (n · B, F) shape of the group's n ranks, of which each rank keeps the rows
  of its index in the group. A run's masks and generator state then do not
  depend on the number of processes, as in JAX, whose dropout draws over
  the global batch; the view ranks of a 2-D layout, which hold the same
  rows, draw the same mask.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from highresnet_tpu_torch.models.layers import BatchNorm2d, Conv2d, Linear, lecun_normal_
from highresnet_tpu_torch.ops.lanczos_fused import lanczos_shift_fused
from highresnet_tpu_torch.parallel.distributed import process_count, process_index

WIDTHS = (64, 64, 64, 64, 128, 128, 128, 128)
POOLS = (False, True, False, True, False, True, False, False)


class ShiftNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        register_size: int = 128,
        *,
        device: str | torch.device = "cpu",
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if register_size % 8:
            raise ValueError(f"register_size must be a multiple of 8, got {register_size}")
        self.dtype = dtype
        self.dropout = 0.5
        c_in = 2 * in_channels
        with torch.device("meta"):
            for i, (c, pool) in enumerate(zip(WIDTHS, POOLS), start=1):
                layers = [Conv2d(c_in, c, 3, padding=1), BatchNorm2d(c), nn.ReLU()]
                if pool:
                    layers.append(nn.MaxPool2d(2))
                setattr(self, f"layer{i}", nn.Sequential(*layers))
                c_in = c
            side = register_size // 8
            self.fc1 = Linear(WIDTHS[-1] * side * side, 1024)
            self.fc2 = Linear(1024, 2, bias=False)
        if torch.device(device).type == "meta":  # shapes only (parameter counts)
            return
        self.to_empty(device="cpu")
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        self.to(device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init, drawn from ``generator`` in module order: lecun-normal
        kernels (fan_in in·3·3 for the convs, in_features for ``fc1``), zero
        biases; BatchNorm at (1, 0) with fresh running statistics; ``fc2``
        zero."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, m.in_channels * math.prod(m.kernel_size), generator)
                m.bias.zero_()
            elif isinstance(m, nn.Linear) and m is not self.fc2:
                lecun_normal_(m.weight, m.in_features, generator)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        self.fc2.weight.zero_()

    synced = False
    group = None

    def sync_batch(self, on: bool = True, group=None) -> None:
        """Train on one rank's shard of a global batch split over ``group``
        (see the module notes)."""
        self.synced, self.group = on, group
        for m in self.modules():
            if isinstance(m, BatchNorm2d):
                m.synced, m.group = on, group

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, 2, H, W) pairs -> (B, 2) float32 translations (dx, dy)."""
        x = (x - x.mean(dim=(2, 3), keepdim=True)).to(self.dtype)
        for i in range(1, len(WIDTHS) + 1):
            x = getattr(self, f"layer{i}")(x)
        x = x.flatten(1)  # channel-major, as the reference's fc weights expect
        if self.training and self.dropout > 0:
            if generator is None:
                raise ValueError("ShiftNet in train mode draws its dropout mask from a generator")
            keep_prob = 1.0 - self.dropout
            rows, start = x.shape[0], 0
            if self.synced:  # the global draw; this rank's rows
                start = process_index(self.group) * rows
                rows = process_count(self.group) * rows
            draw = torch.rand((rows, x.shape[1]), generator=generator, device=x.device)
            keep = draw[start:start + x.shape[0]] < keep_prob
            x = torch.where(keep, x / keep_prob, torch.zeros_like(x))
        x = F.relu(self.fc1(x))
        return self.fc2(x).float()


def register_views(
    shiftnet: ShiftNet,
    views: torch.Tensor,
    reference: torch.Tensor,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Per-view translations (B, L, 2) of views (B, L, H, W) against a
    shared reference (B, H, W); pair channels are [reference, view]. In
    train mode the BatchNorm statistics are taken over all B·L pairs."""
    b, l, h, w = views.shape
    ref = reference[:, None].expand(b, l, h, w)
    pairs = torch.stack([ref, views], dim=2).reshape(b * l, 2, h, w)
    return shiftnet(pairs, generator).reshape(b, l, 2)


def apply_shifts(images: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """Warp (B, L, H, W) images by per-view thetas (B, L, 2) in one
    (B·L, H, W) warp: the fused warp (K3 on CUDA, float32), the plain one
    on the CPU. The net predicts (dx, dy) and the resampler takes (dy, dx):
    the last axis flips."""
    b, l, h, w = images.shape
    shifts = torch.flip(thetas, dims=(-1,)).reshape(b * l, 2)
    return lanczos_shift_fused(images.reshape(b * l, h, w), shifts).reshape(b, l, h, w)
