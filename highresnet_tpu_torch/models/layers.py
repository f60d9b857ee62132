"""Layers that keep float32 parameters and cast them to the input's dtype at use.

The JAX package keeps every parameter in float32 and casts it where it is
used (``nn.Conv(..., dtype=...)`` leaves ``param_dtype`` at f32; its PReLU
and decoder cast their f32 parameters at the call). These subclasses do the
same, so a bf16 body trains f32 master weights and Adam updates f32, as in
JAX. Their state-dict keys are those of the torch base classes. On f32
inputs ``.to`` returns the parameter itself: no copy, no extra graph node.

``lecun_normal_`` draws a kernel as flax's default ``lecun_normal`` does,
the one initialiser of the port's HRNet, ShiftNet and seeded VGG.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from highresnet_tpu_torch.parallel.distributed import all_reduce_sum

# the std of a unit normal truncated at +-2 (flax's variance_scaling divides by it)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """Fill ``weight`` in place from flax's ``lecun_normal``: a normal of std
    sigma = sqrt(1 / fan_in) / 0.8796 truncated at +-2 sigma, so the drawn
    values have variance 1 / fan_in. The caller gives ``fan_in`` in JAX's
    terms (a deconv's is in_channels * k * k, not torch's dim-1 count)."""
    sigma = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=sigma, a=-2 * sigma, b=2 * sigma,
                                 generator=generator)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation,
        )


class PReLU(nn.PReLU):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """Normalises and keeps its running statistics in float32 whatever the
    input dtype, and returns the input's dtype (the JAX ``TorchBatchNorm``).

    With ``synced`` set, each process of a data-parallel run holds one shard
    of the batch and train mode normalises over the global batch, as JAX's
    BatchNorm does on a sharded batch: the per-channel sums and counts are
    summed over the ranks of ``group`` (None: every rank; the data group of
    a 2-D layout, whose view ranks hold copies of the same rows) for the
    mean, then the squared deviations for the biased variance; the running
    variance takes the global unbiased one. Both sums are differentiable
    all-reduces, so the gradient is that of the global batch.
    ``torch.nn.SyncBatchNorm`` refuses CPU tensors."""

    synced = False
    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.synced:
            return self._global_batch_norm(x.float()).to(x.dtype)
        return super().forward(x.float()).to(x.dtype)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        per_channel = (None, slice(None), None, None)
        local = torch.cat([x.sum(dim=(0, 2, 3)), x.new_full((1,), x.numel() / c)])
        total = all_reduce_sum(local, self.group)
        n = total[c]
        mean = total[:c] / n
        dev = x - mean[per_channel]
        var = all_reduce_sum(torch.square(dev).sum(dim=(0, 2, 3)), self.group) / n
        y = dev * torch.rsqrt(var + self.eps)[per_channel]
        if self.affine:
            y = y * self.weight[per_channel] + self.bias[per_channel]
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = self.momentum if self.momentum is not None else 1.0 / float(self.num_batches_tracked)
                self.running_mean.mul_(1.0 - m).add_(mean.detach() * m)
                self.running_var.mul_(1.0 - m).add_(var.detach() * (n / (n - 1.0)) * m)
        return y
