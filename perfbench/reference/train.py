"""The registered training step of HighRes-net in plain PyTorch.

One step on a batch (lrs, alphas, hrs, hr_maps):

1. SR = HRNet(lrs, alphas);
2. ShiftNet(pairs of the HR's and the SR's central ``register_size``
   crops, HR first) predicts (dx, dy) per image, with the dropout mask
   drawn as ``rand(B, F) < 0.5`` from the dropout generator;
3. the SR is Lanczos-warped by (dy, dx) (``warp_int_range`` K: whole
   pixels first, within ±K);
4. loss = mean over images of -cPSNR(warped, HR, mask) + lambda ·
   mean(thetas)², where the mask is the HR's map with a ``crop``-wide
   border zeroed and cPSNR = -10 log10(cMSE), cMSE the masked mean square
   of warped + b - HR, b the masked mean of HR - warped, held constant;
5. one Adam step (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) over both
   networks' parameters.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.reference import lanczos
from perfbench.reference.hrnet import HRNet
from perfbench.reference.ops import Ops
from perfbench.reference.shiftnet import ShiftNet, flat_features

B1, B2, EPS = 0.9, 0.999, 1e-8


def border_mask(patch: int, crop: int, device) -> torch.Tensor:
    m = torch.ones(3 * patch, 3 * patch, device=device)
    if crop > 0:
        m[:crop] = 0
        m[-crop:] = 0
        m[:, :crop] = 0
        m[:, -crop:] = 0
    return m


def neg_cpsnr(sr, hr, mask):
    n = mask.sum(dim=(-2, -1))
    b = (torch.sum(mask * (hr - sr), dim=(-2, -1)) / n).detach()
    cmse = torch.sum(mask * torch.square(sr + b[:, None, None] - hr), dim=(-2, -1)) / n
    return 10.0 * torch.log10(cmse)


class Trainer:
    """Both networks' parameters (leaves named ``hrnet.<key>`` and
    ``shiftnet.<key>``), Adam's moments, the steps taken and each step's
    gradient norm by leaf."""

    def __init__(self, config, params: Dict[str, torch.Tensor], dropout_seed: int,
                 ops: Ops | None = None):
        t = config["training"]
        self.t = t
        ops = ops or Ops()
        self.hrnet = HRNet(config["network"], ops)
        self.shiftnet = ShiftNet(ops)
        self.params = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.steps = 0
        device = next(iter(params.values())).device
        self.generator = torch.Generator(device=device).manual_seed(dropout_seed)
        self.register = t.get("register_size", 128)
        self.mask = border_mask(t["patch_size"], t["crop"], device)
        self.grad_norms: List[Dict[str, float]] = []  # each step's, by leaf

    def _split(self, prefix):
        n = len(prefix) + 1
        return {k[n:]: v for k, v in self.params.items() if k.startswith(prefix + ".")}

    def loss(self, lrs, alphas, hrs, hr_maps) -> torch.Tensor:
        t = self.t
        srs = self.hrnet(self._split("hrnet"), lrs, alphas)
        off = (srs.shape[-1] - self.register) // 2
        c = slice(off, off + self.register)
        pairs = torch.stack([hrs[:, c, c], srs[:, c, c]], dim=1)
        keep = torch.rand((srs.shape[0], flat_features(self.register)),
                          generator=self.generator, device=srs.device) < 0.5
        thetas = self.shiftnet(self._split("shiftnet"), pairs, keep)
        warped = lanczos.shift(srs, torch.flip(thetas, dims=(-1,)),
                               int(t.get("warp_int_range", 0) or 0))
        per_image = neg_cpsnr(warped, hrs, self.mask[None] * hr_maps)
        return per_image.mean() + t["lambda"] * torch.square(thetas.mean())

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
