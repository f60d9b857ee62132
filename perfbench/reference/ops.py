"""Convolutions and matrix products at a chosen operand precision.

``F32`` computes in float32 with TF32 off. ``TF32`` rounds both operands of
every convolution and matrix product to TF32 (1 sign, 8 exponent, 10
mantissa bits; round to nearest, ties away from zero, as the tensor cores
take them) and sums the products in float32: the precision one step below
the configurations' float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = "f32"
TF32 = "tf32"


def no_tf32() -> None:
    """Keep cuDNN and cuBLAS from running float32 work as TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, kept as float32.
    The gradient passes through the rounding unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach() if x.requires_grad else rounded


class Ops:
    """conv2d, conv_transpose2d and linear at one operand precision."""

    def __init__(self, precision: str = F32):
        if precision not in (F32, TF32):
            raise ValueError(f"precision must be {F32} or {TF32}, got {precision!r}")
        self.precision = precision

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        return round_tf32(x) if self.precision == TF32 else x

    def conv2d(self, x, w, b=None, padding=0):
        return F.conv2d(self._r(x), self._r(w), b, padding=padding)

    def conv_transpose2d(self, x, w, b, stride):
        return F.conv_transpose2d(self._r(x), self._r(w), b, stride=stride)

    def linear(self, x, w, b=None):
        return F.linear(self._r(x), self._r(w), b)
