"""The pair pack by bulk copies (K4): (B, L, C, H, W) -> (B, L//2, 2C, H, W).

The counterpart of ``examples/fusion_lab4.py::pack_dma``, the fusion lab's
DMA variant of the pair pack: the same function as K1
(``ops/fusion.py::pack_pairs_cuda``), with the Tensor Memory Accelerator's
bulk copies moving the bytes (``csrc/pack_pairs_dma.cu``). Pure data
movement, so the kernel and every plain version agree bit for bit.

- ``pack_pairs_dma``: dispatch by the tensor's device, as
  ``fusion.pack_pairs`` does: the plain version for a CPU tensor, K4 for a
  CUDA tensor.
- ``pack_pairs_dma_cuda``: the kernel's wrapper. It takes a contiguous 5-D
  floating CUDA tensor whose view blocks (C·H·W·itemsize bytes) and base
  address are 16-byte aligned, and raises on anything else: there is no
  other route for such a tensor.
- ``pack_pairs_ref``: the plain version (``torch.cat`` + ``flip``), as in
  ``ops/fusion.py``.
- ``pack_stack_ref``: the lab's ``pack_stack`` (``torch.stack`` + reshape).
- ``pack_index_select``: one PyTorch call that computes the same function,
  the yardstick (``library_ms``) for K1 and K4; no path of the port calls it.

``LAUNCHES`` counts K4's launches.
"""

from __future__ import annotations

import math

import torch

from highresnet_tpu_torch.kernels.alloc import empty_output
from highresnet_tpu_torch.ops.fusion import _check, _launch, pack_pairs_ref

__all__ = [
    "LAUNCHES", "pack_index_select", "pack_pairs_dma", "pack_pairs_dma_cuda", "pack_pairs_ref",
    "pack_stack_ref",
]

LAUNCHES = 0
ALIGN = 16  # bytes: bulk copies need 16-byte aligned addresses and sizes


def pack_stack_ref(x: torch.Tensor) -> torch.Tensor:
    b, l, c, h, w = x.shape
    half = l // 2
    alice, bob = x[:, :half], torch.flip(x[:, half : 2 * half], dims=(1,))
    return torch.stack([alice, bob], dim=2).reshape(b, half, 2 * c, h, w)


def pair_order(views: int, device=None) -> torch.Tensor:
    """[0, 2h-1, 1, 2h-2, ...]: the view behind each channel half of each pair."""
    half = views // 2
    j = torch.arange(half, device=device)
    return torch.stack([j, 2 * half - 1 - j], dim=1).reshape(-1)


def pack_index_select(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """One ``index_select`` by ``order = pair_order(L, x.device)``, which the
    caller builds once, then a view."""
    b, l, c, h, w = x.shape
    return torch.index_select(x, 1, order).view(b, l // 2, 2 * c, h, w)


def check_aligned(x: torch.Tensor) -> int:
    """Raise unless x's base address and view blocks are 16-byte aligned;
    return the view block's size in bytes."""
    block_bytes = math.prod(x.shape[2:]) * x.element_size()
    if block_bytes % ALIGN or x.data_ptr() % ALIGN:
        raise ValueError(
            f"pack_pairs_dma_cuda needs {ALIGN}-byte aligned view blocks: C*H*W*itemsize = "
            f"{block_bytes} B, base address % {ALIGN} = {x.data_ptr() % ALIGN}"
        )
    return block_bytes


def pack_pairs_dma_cuda(x: torch.Tensor) -> torch.Tensor:
    """K4 on the current stream: (B, L, C, H, W) -> (B, L//2, 2C, H, W)."""
    global LAUNCHES
    _check(x, "pack_pairs_dma_cuda")
    block_bytes = check_aligned(x)
    b, l, c, h, w = x.shape
    out = empty_output((b, l // 2, 2 * c, h, w), x.dtype, x.device)
    if out.numel() == 0:
        return out
    _launch("hrn_pack_pairs_dma", x, out, l, block_bytes)
    LAUNCHES += 1
    return out


def pack_pairs_dma(x: torch.Tensor) -> torch.Tensor:
    """Dispatch by the tensor's device: CPU -> plain version, CUDA -> K4 (or raise)."""
    return pack_pairs_ref(x) if x.device.type == "cpu" else pack_pairs_dma_cuda(x)
