"""TR-MISR's forward FLOPs and its attention core's bytes, for ``mfu``,
``conv_roofline`` and ``attend_roofline`` of the TR-MISR cells.

FLOPs are 2 x MACs: every convolution by the direct count at its output
size (``flops.conv_flops``), every linear layer over its tokens, and the
attention's two matrix products (q kᵀ and the weights times v, each n x n x
d a head and a pixel). LayerNorms, the softmax, GELU, the residual adds
and the pixel shuffle are not counted. ``conv`` leaves out the attention's
products: ``conv_roofline`` divides it by the conv and GEMM kernels' time,
and a core that runs in a kernel of another kind must not push it past its
share. The attention core's bytes are the least it must move in float32:
q, k and v read once and its output written once, in every block.
"""

from __future__ import annotations

from typing import Any, Dict

from perfbench.flops import conv_flops
from perfbench.reference.trmisr import settings


def trmisr_forward_flops(network: Dict[str, Any], batch: int, views: int, size: int,
                         conv: bool = False) -> float:
    """Forward FLOPs of ``batch`` scenes of ``views`` views of size x size
    px; with ``conv``, without the attention's two matrix products."""
    enc, s = settings(network)
    c, k = enc["channel_size"], enc["kernel_size"]
    px, n = size * size, views + 1
    dim, inner, mlp = s["dim"], s["heads"] * s["head_dim"], s["mlp_dim"]
    encoder = (conv_flops(size, size, enc["in_channels"], c, k)
               + 2 * enc["num_layers"] * conv_flops(size, size, c, c, k)
               + conv_flops(size, size, c, c, k))
    linears = 2.0 * px * n * (3 * dim * inner + inner * dim + 2 * dim * mlp)
    core = 0.0 if conv else 2 * 2.0 * px * s["heads"] * n * n * s["head_dim"]
    decoder = conv_flops(size, size, dim, s["scale"] ** 2, s["decoder_kernel"])
    return batch * (views * encoder + s["depth"] * (linears + core) + decoder)


def attend_bytes(network: Dict[str, Any], batch: int, views: int, size: int) -> float:
    """Bytes the attention core must move for ``batch`` scenes: q, k, v and
    the heads' output, (size², views + 1, heads·head_dim) float32 each, in
    every block."""
    _, s = settings(network)
    return batch * s["depth"] * 4 * size * size * (views + 1) * s["heads"] * s["head_dim"] * 4.0
