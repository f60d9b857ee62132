"""RAMS's forward FLOPs by the direct-convolution count (2 x MACs of every
convolution at its output size; the gates' 1x1 convolutions on their
pooled vectors too), for ``conv_roofline`` and ``mfu`` of the RAMS cells.
Additions, the gates' means and the pixel shuffles are not counted. As for
HRNet (``flops.py``), a convolution algorithm that does less arithmetic
than the direct count reads above its share.
"""

from __future__ import annotations

from typing import Any, Dict

from perfbench.reference.rams import settings


def rams_forward_flops(network: Dict[str, Any], batch: int, size: int) -> float:
    """Forward FLOPs of ``batch`` scenes of T views of size x size px."""
    s = settings(network)
    f, k, t, r, scale = s["filters"], s["kernel_size"], s["views"], s["reduction"], s["scale"]
    px = size * size

    def conv3d(frames, cin, cout):
        return 2.0 * frames * px * cin * cout * k ** 3

    def gate(c):
        c_r = max(c // r, 1)
        return 2.0 * (c * c_r + c_r * c)

    def rfab(frames):
        return 2 * conv3d(frames, f, f) + gate(f)

    total = conv3d(t, 1, f) + s["blocks"] * rfab(t) + conv3d(t, f, f)
    frames = t
    while frames > k:  # the temporal reduction: an RFAB, then a conv valid along time
        total += rfab(frames) + conv3d(frames - (k - 1), f, f)
        frames -= k - 1
    total += conv3d(1, f, scale ** 2)  # upscale: the last k frames to one
    padded = (size + k - 1) ** 2  # RTAB on the reflect-padded views, T frames as channels
    total += 2 * 2.0 * padded * t * t * k * k + gate(t) + 2.0 * px * t * scale ** 2 * k * k
    return batch * total
