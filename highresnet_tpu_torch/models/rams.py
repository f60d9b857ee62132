"""RAMS: multi-image super-resolution by residual attention, in 3-D.

Salvetti, Mazzia, Khaliq and Chiaberge, "Multi-Image Super Resolution of
Remotely Sensed Images Using Residual Attention Deep Neural Networks",
Remote Sensing 12(14):2207, 2020 (code: https://github.com/EscVM/RAMS). The
network of ``network.arch: "rams"``, with HRNet's call and shapes:
``forward(lrs (B, L, H, W), alphas (B, L))`` -> SR (B, sH, sW) float32.

With F filters, kernel k, T frames, reduction r, N blocks and scale s
(``config.RAMS_DEFAULTS``: 32, 3, 9, 8, 12, 3), and every convolution under
weight normalisation (``WNConv``: w = g · v / ‖v‖ over every axis but the
output channel, a separate bias):

- normalise: x̂ = (x − μ) / σ, the published μ and σ of the raw uint16
  pixels over 65535 (the port reads images as ``img_as_float32``); a
  scene with fewer than T real views (alpha 0 elsewhere) fills the other
  slots by repeating its real views in order (``fill_views``);
- RFAB(z), 3-D: y = conv(ReLU(conv(z))), a = σ(up(ReLU(down(mean_{T,H,W}
  y)))) with 1x1x1 convs F → F/r → F, and z + y·a;
- body: z₀ = conv 1 → F of x̂ as one channel, N RFABs, a conv F → F, plus z₀;
- temporal reduction, (T − 1)/(k − 1) − 1 times: an RFAB, then ReLU of a
  conv valid along time (T shrinks by k − 1) on the tensor reflect-padded
  on H and W, which keeps them;
- upscale: a conv F → s² valid along time (the last k frames to one) on
  the reflect-padded tensor, then pixel shuffle by s;
- global residual (RTAB), 2-D with the T frames as channels, on ĝ, x̂
  reflect-padded by one pixel: y = conv(ReLU(conv(ĝ))), the same gate with
  1x1 convs T → max(T // r, 1) → T, and a valid conv T → s² of ĝ + y·gate,
  pixel-shuffled by s;
- SR = (upscale + global) · σ + μ.

Convolutions not marked valid pad 'same' with zeros, as Keras pads; the
reflect pads are ``ops.lanczos.reflect_pad``'s, made of slices. Spans:
``rams.features`` (normalise, fill, body), ``rams.reduce``,
``rams.upscale``, ``rams.global``, and ``rams.gate`` around each of the
N + (T − 1)/(k − 1) gates, nested in those.

Parameters are drawn from an explicit ``torch.Generator`` on the CPU in
module order, as HRNet's are: each v lecun-normal (the port's one kernel
law), g at ‖v‖ (so w = v, as the published layer's ``data_init=False``
starts), every bias zero. The network computes in float32.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from highresnet_tpu_torch.config import rams_settings
from highresnet_tpu_torch.models.layers import lecun_normal_
from highresnet_tpu_torch.ops.lanczos import reflect_pad
from highresnet_tpu_torch.utils.profiling import span

WEIGHTS_NAME = "RAMS.pth"
MEAN = 7433.6436 / 65535.0  # the published normalisation, raw uint16 units over 65535
STD = 2353.0723 / 65535.0


def fill_views(lrs: torch.Tensor, alphas: torch.Tensor, views: int) -> torch.Tensor:
    """(B, ``views``, H, W): each scene's real views (alpha > 0) in order,
    repeated in order into the slots of the missing ones, from the first
    ``views`` of its L (zero views with alpha 0 where L is fewer)."""
    b, l, h, w = lrs.shape
    if l < views:
        lrs = F.pad(lrs, (0, 0, 0, 0, 0, views - l))
        alphas = F.pad(alphas, (0, views - l))
    lrs, real = lrs[:, :views], alphas[:, :views] > 0
    rank = torch.cumsum(real, dim=1) - 1  # each real view's place among the real ones
    n = real.sum(dim=1, keepdim=True).clamp(min=1)
    want = torch.arange(views, device=lrs.device)[None] % n  # (B, views): the place each slot takes
    match = real[:, None, :] & (rank[:, None, :] == want[:, :, None])
    src = match.to(torch.int32).argmax(dim=-1)  # view 0 where a scene has no real view
    return torch.gather(lrs, 1, src[:, :, None, None].expand(b, views, h, w))


class WNConv(nn.Module):
    """A 2-D or 3-D convolution under weight normalisation: w = g · v / ‖v‖,
    the norm over every axis but the output channel, and a bias. ``same``:
    zero padding that keeps the size; else valid."""

    def __init__(self, dims: int, c_in: int, c_out: int, k: int, same: bool = True):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(c_out, c_in, *(k,) * dims))
        self.weight_g = nn.Parameter(torch.empty(c_out))
        self.bias = nn.Parameter(torch.empty(c_out))
        self.conv = F.conv3d if dims == 3 else F.conv2d
        self.padding = k // 2 if same else 0

    def weight(self) -> torch.Tensor:
        v = self.weight_v
        scale = self.weight_g / torch.linalg.vector_norm(v.flatten(1), dim=1)
        return v * scale.reshape(-1, *(1,) * (v.dim() - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight(), self.bias, padding=self.padding)


class ResidualAttention(nn.Module):
    """z + y · gate(y), y = conv(ReLU(conv(z))), the gate a sigmoid of 1x1
    convs c → max(c // r, 1) → c on the mean of y over every axis but the
    channels: RFAB in 3-D, RTAB in 2-D."""

    def __init__(self, dims: int, channels: int, k: int, r: int):
        super().__init__()
        self.conv1 = WNConv(dims, channels, channels, k)
        self.conv2 = WNConv(dims, channels, channels, k)
        self.down = WNConv(dims, channels, max(channels // r, 1), 1)
        self.up = WNConv(dims, max(channels // r, 1), channels, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        y = self.conv2(F.relu(self.conv1(z)))
        with span("rams.gate"):
            s = y.mean(dim=tuple(range(2, y.dim())), keepdim=True)
            return z + y * torch.sigmoid(self.up(F.relu(self.down(s))))


class TemporalReduction(nn.Module):
    """An RFAB, then ReLU of a conv valid along time on the tensor
    reflect-padded on H and W: T shrinks by k − 1, H and W stay."""

    def __init__(self, channels: int, k: int, r: int):
        super().__init__()
        self.rfab = ResidualAttention(3, channels, k, r)
        self.conv = WNConv(3, channels, channels, k, same=False)
        self.pad = k // 2

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv(reflect_pad(self.rfab(z), self.pad)))


class RAMS(nn.Module):
    """forward(lrs (B, L, H, W), alphas (B, L)) -> (B, sH, sW) float32 SR
    (the module notes). ``config`` is the network section."""

    def __init__(self, config: Dict[str, Any] | None = None, *,
                 device: str | torch.device = "cpu", generator: torch.Generator | None = None):
        super().__init__()
        s = rams_settings(config or {})
        f, k, t, r = s["filters"], s["kernel_size"], s["views"], s["reduction"]
        self.views, self.scale, self.pad = t, s["scale"], k // 2
        reductions = (t - 1) // (k - 1) - 1
        if k % 2 == 0 or t - reductions * (k - 1) != k:
            raise ValueError(f"RAMS needs an odd kernel and (T - 1) a multiple of (k - 1): "
                             f"T {t}, k {k}")
        with torch.device("meta"):
            self.head = WNConv(3, 1, f, k)
            self.body = nn.Sequential(*[ResidualAttention(3, f, k, r)
                                        for _ in range(s["blocks"])])
            self.tail = WNConv(3, f, f, k)
            self.reduce = nn.Sequential(*[TemporalReduction(f, k, r) for _ in range(reductions)])
            self.upscale = WNConv(3, f, self.scale ** 2, k, same=False)
            self.rtab = ResidualAttention(2, t, k, r)
            self.rtab_out = WNConv(2, t, self.scale ** 2, k, same=False)
        self.to_empty(device="cpu")
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        self.to(device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Each v lecun-normal (fan-in: its input channels times its
        kernel's taps), g at ‖v‖, each bias zero, in module order."""
        for m in self.modules():
            if isinstance(m, WNConv):
                v = m.weight_v
                lecun_normal_(v, math.prod(v.shape[1:]), generator)
                m.weight_g.copy_(torch.linalg.vector_norm(v.flatten(1), dim=1))
                m.bias.zero_()

    def shard_views(self, group=None) -> None:
        """RAMS convolves over its T frames together: no view axis."""
        if group is not None:
            raise ValueError("RAMS does not split its views over a view axis (training.mesh)")

    def forward(self, lrs: torch.Tensor, alphas: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        with span("rams.features"):
            x = (fill_views(lrs.float(), alphas, self.views) - MEAN) / STD  # (B, T, H, W)
            z0 = self.head(x[:, None])
            z = self.tail(self.body(z0)) + z0
        with span("rams.reduce"):
            z = self.reduce(z)
        with span("rams.upscale"):
            up = F.pixel_shuffle(self.upscale(reflect_pad(z, self.pad))[:, :, 0], self.scale)
        with span("rams.global"):
            g = self.rtab(reflect_pad(x, self.pad))
            res = F.pixel_shuffle(self.rtab_out(g), self.scale)
        return ((up + res) * STD + MEAN)[:, 0]
