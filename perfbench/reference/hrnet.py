"""HighRes-net (Deudon et al. 2020, arXiv:2002.06460) in plain PyTorch.

forward(params, lrs (B, L, H, W), alphas (B, L)) -> SR (B, 3H, 3W):

- anchor: the lower median of the first min(9, L) views, stacked with
  every view as a second input channel;
- encoder, shared over views: conv 2->C + PReLU, ``num_layers`` residual
  blocks (conv, PReLU, conv, PReLU, plus the input), conv C->C;
- fusion: while more than one view is left, view j < L//2 is paired with
  view L//2·2 - 1 - j (channels concatenated; an odd last view is
  dropped), the pair goes through a residual block at 2C, a conv 2C->C
  and a PReLU, and the new state is the first view plus the fused pair
  scaled by the second view's alpha; the survivors are averaged;
- decoder: a transposed conv C->C with kernel and stride 3, a PReLU, a
  1x1 conv C->1.

Every convolution is 'same' padded. ``params`` maps the published
state-dict keys to tensors.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.ops import Ops

Spec = List[Tuple[str, Tuple[int, ...], str, int]]  # (key, shape, init, fan_in)


def _net(config) -> Tuple[int, int, int, int]:
    enc, rec = config["encoder"], config["recursive"]
    return enc["in_channels"], enc["channel_size"], enc["num_layers"], rec["in_channels"]


def param_spec(config) -> Spec:
    """Every parameter of the network with its shape and its initial law:
    ``kernel`` (lecun normal of ``fan_in``), ``zero`` or ``prelu`` (0.25)."""
    c_in, c, n_res, cf = _net(config)
    spec: Spec = []

    def conv(key, ci, co, k):
        spec.append((f"{key}.weight", (co, ci, k, k), "kernel", ci * k * k))
        spec.append((f"{key}.bias", (co,), "zero", 0))

    def prelu(key):
        spec.append((f"{key}.weight", (1,), "prelu", 0))

    def res(key, ch):
        conv(f"{key}.block.0", ch, ch, 3)
        prelu(f"{key}.block.1")
        conv(f"{key}.block.2", ch, ch, 3)
        prelu(f"{key}.block.3")

    conv("encode.init_layer.0", c_in, c, 3)
    prelu("encode.init_layer.1")
    for i in range(n_res):
        res(f"encode.res_layers.{i}", c)
    conv("encode.final.0", c, c, 3)
    res("fuse.fuse.0", 2 * cf)
    conv("fuse.fuse.1", 2 * cf, cf, 3)
    prelu("fuse.fuse.2")
    dd = config["decoder"]["deconv"]
    s, cd = dd["stride"], dd["out_channels"]
    spec.append(("decode.deconv.0.weight", (cf, cd, s, s), "kernel", cf * s * s))
    spec.append(("decode.deconv.0.bias", (cd,), "zero", 0))
    prelu("decode.deconv.1")
    conv("decode.final", cd, 1, 1)
    return spec


def _prelu(x, a):
    return F.prelu(x, a)


class HRNet:
    def __init__(self, config, ops: Ops | None = None):
        self.config = config
        self.ops = ops or Ops()
        self.n_res = config["encoder"]["num_layers"]
        self.stride = config["decoder"]["deconv"]["stride"]

    def _conv(self, p, key, x):
        w = p[f"{key}.weight"]
        return self.ops.conv2d(x, w, p[f"{key}.bias"], padding=w.shape[-1] // 2)

    def _res(self, p, key, x):
        y = _prelu(self._conv(p, f"{key}.block.0", x), p[f"{key}.block.1.weight"])
        y = _prelu(self._conv(p, f"{key}.block.2", y), p[f"{key}.block.3.weight"])
        return x + y

    def encode(self, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        x = _prelu(self._conv(p, "encode.init_layer.0", x), p["encode.init_layer.1.weight"])
        for i in range(self.n_res):
            x = self._res(p, f"encode.res_layers.{i}", x)
        return self._conv(p, "encode.final.0", x)

    def fuse(self, p, states: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
        """states (B, L, C, H, W), alphas (B, L) -> (B, C, H, W)."""
        b, _, c, h, w = states.shape
        while states.shape[1] > 1:
            half = states.shape[1] // 2
            alice = states[:, :half]
            bob = torch.flip(states[:, half:2 * half], dims=(1,))
            a_bob = torch.flip(alphas[:, half:2 * half], dims=(1,))
            pair = torch.cat([alice, bob], dim=2).reshape(b * half, 2 * c, h, w)
            y = self._res(p, "fuse.fuse.0", pair)
            y = _prelu(self._conv(p, "fuse.fuse.1", y), p["fuse.fuse.2.weight"])
            states = alice + a_bob[:, :, None, None, None] * y.reshape(b, half, c, h, w)
            alphas = alphas[:, :half]
        return states.mean(dim=1)

    def decode(self, p, x: torch.Tensor) -> torch.Tensor:
        y = self.ops.conv_transpose2d(x, p["decode.deconv.0.weight"], p["decode.deconv.0.bias"],
                                      self.stride)
        y = _prelu(y, p["decode.deconv.1.weight"])
        return self._conv(p, "decode.final", y)[:, 0]

    def __call__(self, p, lrs: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
        b, l, h, w = lrs.shape
        anchor = torch.sort(lrs[:, :min(9, l)], dim=1).values[:, (min(9, l) - 1) // 2]
        x = torch.stack([lrs, anchor[:, None].expand(b, l, h, w)], dim=2)
        states = self.encode(p, x.reshape(b * l, 2, h, w)).reshape(b, l, -1, h, w)
        return self.decode(p, self.fuse(p, states, alphas))
