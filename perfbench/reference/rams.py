"""RAMS (Salvetti et al., Remote Sensing 12(14):2207, 2020) in plain PyTorch:
its forward, its loss cL1 and a plain Adam step.

forward(params, lrs (B, L, H, W), alphas (B, L)) -> SR (B, sH, sW), with F
filters, kernel k, T frames, reduction r, N blocks and scale s from the
configuration's ``network.rams`` (published: 32, 3, 9, 8, 12, 3):

- x̂ = (x − μ) / σ, μ = 7433.6436 / 65535 and σ = 2353.0723 / 65535 (the
  published raw uint16 statistics at the [0, 1] scale of the pixels); a
  scene's missing views (alpha 0) take its real views again, in order, to
  fill T slots;
- RFAB(z) = z + y · σ(up(ReLU(down(mean y)))), y = conv(ReLU(conv(z))),
  3-D, the mean over (T, H, W), 1x1x1 convs F → F/r → F;
- body: z₀ = conv 1 → F of x̂, N RFABs, a conv F → F, plus z₀;
- (T − 1)/(k − 1) − 1 times: an RFAB, then ReLU of a conv valid along time
  of the tensor reflect-padded by k // 2 on H and W;
- upscale: pixel shuffle by s of a conv F → s², valid, of the padded tensor;
- global residual: ĝ = x̂ reflect-padded, y = conv(ReLU(conv(ĝ))) with the
  T frames as channels, gate 1x1 convs T → max(T // r, 1) → T on the mean
  over (H, W), pixel shuffle of a valid conv T → s² of ĝ + y · gate;
- SR = (upscale + global) · σ + μ.

Each convolution's weight is g · v / ‖v‖, the norm over every axis but the
output channel, plus its bias; convolutions not marked valid pad 'same'
with zeros. Parameters are named as the program's ``RAMS.state_dict()``:
``<conv>.weight_v``, ``<conv>.weight_g``, ``<conv>.bias``.

The precision ``TF32`` rounds both operands of every convolution to TF32
through ``ops.round_tf32`` (``ops.Ops`` has no 3-D convolution).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from perfbench.reference.hrnet import Spec
from perfbench.reference.ops import F32, TF32, round_tf32

MEAN = 7433.6436 / 65535.0
STD = 2353.0723 / 65535.0
PUBLISHED = {"filters": 32, "kernel_size": 3, "views": 9, "reduction": 8, "blocks": 12, "scale": 3}
B1, B2, EPS = 0.9, 0.999, 1e-8


def settings(network) -> Dict[str, int]:
    return {**PUBLISHED, **network.get("rams", {})}


def _shape(s):
    f, k, t, r = s["filters"], s["kernel_size"], s["views"], s["reduction"]
    return f, k, t, r, (t - 1) // (k - 1) - 1


def param_spec(network) -> Spec:
    """Every parameter with its shape and initial law: each ``weight_v``
    ``kernel`` (lecun normal of its fan-in), ``weight_g`` ``one`` (set to
    ‖v‖ by ``with_gains``), each bias ``zero``."""
    s = settings(network)
    f, k, t, r, reductions = _shape(s)
    spec: Spec = []

    def conv(key, ci, co, kk, dims):
        spec.append((f"{key}.weight_v", (co, ci) + (kk,) * dims, "kernel", ci * kk ** dims))
        spec.append((f"{key}.weight_g", (co,), "one", 0))
        spec.append((f"{key}.bias", (co,), "zero", 0))

    def attention(key, c, dims):
        conv(f"{key}.conv1", c, c, k, dims)
        conv(f"{key}.conv2", c, c, k, dims)
        conv(f"{key}.down", c, max(c // r, 1), 1, dims)
        conv(f"{key}.up", max(c // r, 1), c, 1, dims)

    conv("head", 1, f, k, 3)
    for i in range(s["blocks"]):
        attention(f"body.{i}", f, 3)
    conv("tail", f, f, k, 3)
    for i in range(reductions):
        attention(f"reduce.{i}.rfab", f, 3)
        conv(f"reduce.{i}.conv", f, f, k, 3)
    conv("upscale", f, s["scale"] ** 2, k, 3)
    attention("rtab", t, 2)
    conv("rtab_out", t, s["scale"] ** 2, k, 2)
    return spec


def with_gains(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``params`` with each ``weight_g`` at ‖weight_v‖ (so the weight is v)."""
    out = dict(params)
    for key, v in params.items():
        if key.endswith(".weight_v"):
            out[key[:-1] + "g"] = torch.linalg.vector_norm(v.reshape(len(v), -1), dim=1)
    return out


class RAMS:
    def __init__(self, network, precision: str = F32):
        if precision not in (F32, TF32):
            raise ValueError(f"precision must be {F32} or {TF32}, got {precision!r}")
        self.s = settings(network)
        self.precision = precision

    def _r(self, x):
        return round_tf32(x) if self.precision == TF32 else x

    def conv(self, p, key, x, valid=False):
        v, g = p[f"{key}.weight_v"], p[f"{key}.weight_g"]
        norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim()))))
        w = v * (g / norm).reshape((-1,) + (1,) * (v.dim() - 1))
        conv = F.conv3d if v.dim() == 5 else F.conv2d
        pad = 0 if valid else v.shape[-1] // 2
        return conv(self._r(x), self._r(w), p[f"{key}.bias"], padding=pad)

    def attention(self, p, key, z):
        y = self.conv(p, f"{key}.conv2", F.relu(self.conv(p, f"{key}.conv1", z)))
        a = torch.mean(y, dim=tuple(range(2, y.dim())), keepdim=True)
        a = torch.sigmoid(self.conv(p, f"{key}.up", F.relu(self.conv(p, f"{key}.down", a))))
        return z + y * a

    def fill(self, lrs, alphas):
        t = self.s["views"]
        if lrs.shape[1] < t:
            lrs = F.pad(lrs, (0, 0, 0, 0, 0, t - lrs.shape[1]))
            alphas = F.pad(alphas, (0, t - alphas.shape[1]))
        out = []
        for x, a in zip(lrs[:, :t], alphas[:, :t]):
            real = torch.nonzero(a > 0).flatten().tolist() or [0]
            out.append(torch.stack([x[real[j % len(real)]] for j in range(t)]))
        return torch.stack(out)

    def __call__(self, p, lrs, alphas):
        k, reductions, s = self.s["kernel_size"], _shape(self.s)[-1], self.s["scale"]
        x = (self.fill(lrs, alphas) - MEAN) / STD  # (B, T, H, W)
        z0 = self.conv(p, "head", x[:, None])
        z = z0
        for i in range(self.s["blocks"]):
            z = self.attention(p, f"body.{i}", z)
        z = self.conv(p, "tail", z) + z0
        hw = (k // 2,) * 4 + (0, 0)  # H and W, not T
        for i in range(reductions):
            z = self.attention(p, f"reduce.{i}.rfab", z)
            z = F.relu(self.conv(p, f"reduce.{i}.conv", F.pad(z, hw, mode="reflect"), valid=True))
        up = self.conv(p, "upscale", F.pad(z, hw, mode="reflect"), valid=True)[:, :, 0]
        up = F.pixel_shuffle(up, s)
        g = F.pad(x, (k // 2,) * 4, mode="reflect")
        res = F.pixel_shuffle(self.conv(p, "rtab_out", self.attention(p, "rtab", g), valid=True), s)
        return ((up + res) * STD + MEAN)[:, 0]


def cl1(sr, hr, mask, border: int = 3) -> torch.Tensor:
    """Per-image cL1 as published: the SR cropped by ``border``, against each
    shifted crop of the HR and its mask, the brightness bias not detached,
    the least masked L1 over the (2·border + 1)² shifts."""
    size_h, size_w = sr.shape[-2] - 2 * border, sr.shape[-1] - 2 * border
    crop = sr[:, border:border + size_h, border:border + size_w]
    losses = []
    for i in range(2 * border + 1):
        for j in range(2 * border + 1):
            labels = hr[:, i:i + size_h, j:j + size_w]
            m = mask[:, i:i + size_h, j:j + size_w]
            n = torch.sum(m, dim=(1, 2))
            b = torch.sum(labels * m - crop * m, dim=(1, 2)) / n
            corrected = (crop * m + b[:, None, None]) * m
            losses.append(torch.sum(torch.abs(labels * m - corrected), dim=(1, 2)) / n)
    return torch.min(torch.stack(losses), dim=0).values


class Trainer:
    """RAMS's parameters, Adam's moments (b1 0.9, b2 0.999, eps 1e-8,
    bias-corrected), the steps taken and each step's gradient norm by leaf;
    the loss the batch mean of cL1 over the ``crop`` border."""

    def __init__(self, config, params: Dict[str, torch.Tensor], precision: str = F32):
        self.t = config["training"]
        self.net = RAMS(config["network"], precision)
        self.params = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.steps = 0
        self.grad_norms: List[Dict[str, float]] = []

    def loss(self, lrs, alphas, hrs, hr_maps) -> torch.Tensor:
        sr = self.net(self.params, lrs, alphas)
        return cl1(sr, hrs, hr_maps, self.t["crop"]).mean()

    def step(self, lrs, alphas, hrs, hr_maps) -> float:
        loss = self.loss(lrs, alphas, hrs, hr_maps)
        keys = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in keys])
        self.steps += 1
        norms = torch.stack([torch.linalg.vector_norm(g) for g in grads]).tolist()
        self.grad_norms.append(dict(zip(keys, norms)))
        lr, n = self.t["lr"], self.steps
        with torch.no_grad():
            for k, g in zip(keys, grads):
                self.m[k].mul_(B1).add_(g, alpha=1 - B1)
                self.v[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                m_hat = self.m[k] / (1 - B1 ** n)
                v_hat = self.v[k] / (1 - B2 ** n)
                self.params[k].sub_(lr * m_hat / (torch.sqrt(v_hat) + EPS))
        return float(loss.detach())
