"""Layers that keep float32 parameters and cast them to the input's dtype at use.

The JAX package keeps every parameter in float32 and casts it where it is
used (``nn.Conv(..., dtype=...)`` leaves ``param_dtype`` at f32; its PReLU
and decoder cast their f32 parameters at the call). These subclasses do the
same, so a bf16 body trains f32 master weights and Adam updates f32, as in
JAX. Their state-dict keys are those of the torch base classes. On f32
inputs ``.to`` returns the parameter itself: no copy, no extra graph node.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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
    input dtype, and returns the input's dtype (the JAX ``TorchBatchNorm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)
