"""Fusion-round pair packing: (B, L, C, H, W) -> (B, L//2, 2C, H, W), and back.

Pair j is [x_j ‖ x_{2·half−1−j}] along the channels; an odd last view is
dropped (the counterpart of ``highresnet_tpu/ops/fusion_pallas.py``, which
works in NHWC). Pure data movement, so each kernel and its plain version
must agree bit for bit.

- ``pack_pairs_ref`` / ``unpack_pairs_ref``: the plain PyTorch versions (CPU
  path and test oracles). ``unpack_pairs_ref`` is the pack's VJP: the
  cotangent of view v < half is pair v's first C channels, of view v ≥ half
  pair (2·half−1−v)'s last C channels, and a dropped odd view gets zeros.
- ``pack_pairs_cuda`` (K1, ``csrc/pack_pairs.cu``) and ``unpack_pairs_cuda``
  (K2, ``csrc/unpack_pairs.cu``): the hand-written kernels.
- ``PackPairs``: autograd Function, forward K1, backward K2 on CUDA.
- ``pack_pairs``: dispatch by the tensor's device: CPU -> plain version,
  CUDA -> ``PackPairs`` (kernels, or raise). There is no fallback from CUDA
  to the plain version.

``LAUNCHES`` counts kernel launches per kernel, so a run can show that its
forward and backward went through the kernels.
"""

from __future__ import annotations

import torch

from highresnet_tpu_torch.kernels.alloc import empty_output

LAUNCHES = {"pack": 0, "unpack": 0}


def pack_pairs_ref(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[1] // 2
    return torch.cat([x[:, :half], torch.flip(x[:, half : 2 * half], dims=(1,))], dim=2)


def unpack_pairs_ref(g: torch.Tensor, l: int) -> torch.Tensor:
    """(B, half, 2C, H, W) cotangent of the pack -> (B, l, C, H, W)."""
    b, half, c2, h, w = g.shape
    c = c2 // 2
    parts = [g[:, :, :c], torch.flip(g[:, :, c:], dims=(1,))]
    if l > 2 * half:
        parts.append(g.new_zeros((b, l - 2 * half, c, h, w)))
    return torch.cat(parts, dim=1)


def _check(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if x.dim() != 5:
        raise ValueError(f"{name} expects a 5-D NCHW state tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} expects a contiguous tensor")
    if not x.is_floating_point():  # the kernels copy bytes; the model moves float states
        raise TypeError(f"{name} expects a floating tensor, got {x.dtype}")


def _launch(symbol: str, src: torch.Tensor, out: torch.Tensor, views: int, block_bytes: int):
    from highresnet_tpu_torch.kernels import build

    lib = build.load()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = getattr(lib, symbol)(src.data_ptr(), out.data_ptr(), out.shape[0], views,
                                  block_bytes, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError_t {rc}")


def pack_pairs_cuda(x: torch.Tensor) -> torch.Tensor:
    """K1 on the current stream: (B, L, C, H, W) -> (B, L//2, 2C, H, W)."""
    _check(x, "pack_pairs_cuda")
    b, l, c, h, w = x.shape
    out = empty_output((b, l // 2, 2 * c, h, w), x.dtype, x.device)
    if out.numel() == 0:
        return out
    _launch("hrn_pack_pairs", x, out, l, c * h * w * x.element_size())
    LAUNCHES["pack"] += 1
    return out


def unpack_pairs_cuda(g: torch.Tensor, l: int) -> torch.Tensor:
    """K2 on the current stream: (B, half, 2C, H, W) -> (B, l, C, H, W).

    Every output byte is written by the kernel, the zero block of a dropped
    odd view included."""
    _check(g, "unpack_pairs_cuda")
    b, half, c2, h, w = g.shape
    if c2 % 2 or l // 2 != half:
        raise ValueError(f"unpack_pairs_cuda: {tuple(g.shape)} is not a pack of {l} views")
    out = empty_output((b, l, c2 // 2, h, w), g.dtype, g.device)
    if out.numel() == 0:
        return out
    _launch("hrn_unpack_pairs", g, out, l, c2 // 2 * h * w * g.element_size())
    LAUNCHES["unpack"] += 1
    return out


class PackPairs(torch.autograd.Function):
    """K1 forward, K2 backward on CUDA; the plain versions on the CPU (used
    by ``gradcheck``, since ``pack_pairs`` sends CPU tensors to the plain
    version directly)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.views = x.shape[1]
        return pack_pairs_ref(x) if x.device.type == "cpu" else pack_pairs_cuda(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        if g.device.type == "cpu":
            return unpack_pairs_ref(g, ctx.views)
        return unpack_pairs_cuda(g.contiguous(), ctx.views)


def pack_pairs(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return pack_pairs_ref(x)
    return PackPairs.apply(x)
