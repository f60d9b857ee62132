"""TR-MISR (An et al., IEEE J. Sel. Topics Appl. Earth Observ. Remote Sens.
15, 2022; https://github.com/Suanmd/TR-MISR) in plain PyTorch: its forward.

forward(params, lrs (B, L, H, W), alphas (B, L)) -> SR (B, sH, sW), with the
configuration's ``network.encoder`` (published: 2 input channels, C 64, 2
residual blocks, kernel 3) and ``network.transformer`` (published: dim C,
depth 6, 8 heads of width 64, MLP 128, a conv of kernel 3 to s² channels,
scale 3):

- encode: the lower median of the first min(9, L) views stacked with every
  view, conv 2 -> C + PReLU, the residual blocks (conv, PReLU, conv, PReLU,
  plus the input), conv C -> C, over the B·L views;
- tokens: each pixel's sequence is the learned token t, then its L views'
  features; no positional code;
- mask: a key counts where it is the token or a view with alpha > 0, and the
  other keys' scores are −∞;
- each block: x += W_o · attn(LN₁(x)) + b_o, where LN₁(x) · W_qkv (no bias)
  splits into q, k, v of h heads and each head is softmax(q kᵀ / √d) · v,
  the heads concatenated; then x += W₂ · GELU(W₁ · LN₂(x) + b₁) + b₂ (erf
  GELU); every LayerNorm has eps 1e-5;
- fused state: LN_f of the token's row;
- decode: pixel shuffle by s of PReLU(conv C -> s², same).

Dropout is off: this is the forward of inference. Parameters are named as
the program's ``TRNet.state_dict()``: ``encode.*`` as HRNet's,
``fuse.token``, ``fuse.layers.<i>.{norm1,qkv,out,norm2,fc1,fc2}.*``,
``fuse.norm.*``, ``decode.conv.*``, ``decode.prelu.weight``.

The precision ``TF32`` rounds both operands of every convolution, every
linear layer and both of the attention's matrix products to TF32 through
``ops.round_tf32``. ``scenes_per_call`` computes a batch that many scenes at
a time, so the reference fits beside what the program left on the card.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.hrnet import Spec
from perfbench.reference.ops import F32, TF32, Ops, round_tf32

ENCODER = {"in_channels": 2, "num_layers": 2, "kernel_size": 3, "channel_size": 64}
PUBLISHED = {"dim": 64, "depth": 6, "heads": 8, "head_dim": 64, "mlp_dim": 128, "dropout": 0.1,
             "decoder_kernel": 3, "scale": 3}
LN_EPS = 1e-5


def settings(network) -> Tuple[Dict[str, int], Dict[str, float]]:
    """The encoder's and the transformer's settings over the published ones."""
    return ({**ENCODER, **network.get("encoder", {})},
            {**PUBLISHED, **network.get("transformer", {})})


def param_spec(network) -> Spec:
    """Every parameter with its shape and initial law: kernels ``kernel``
    (lecun normal of their fan-in), the token ``kernel`` of fan-in 1 (a
    unit normal, truncated at ±2 by ``weights.make``), biases ``zero``,
    LayerNorm gains ``one``, PReLU ``prelu``."""
    enc, s = settings(network)
    c, k = enc["channel_size"], enc["kernel_size"]
    dim, inner, mlp = s["dim"], s["heads"] * s["head_dim"], s["mlp_dim"]
    spec: Spec = []

    def conv(key, ci, co, kk):
        spec.append((f"{key}.weight", (co, ci, kk, kk), "kernel", ci * kk * kk))
        spec.append((f"{key}.bias", (co,), "zero", 0))

    def linear(key, fi, fo, bias=True):
        spec.append((f"{key}.weight", (fo, fi), "kernel", fi))
        if bias:
            spec.append((f"{key}.bias", (fo,), "zero", 0))

    def norm(key):
        spec.append((f"{key}.weight", (dim,), "one", 0))
        spec.append((f"{key}.bias", (dim,), "zero", 0))

    conv("encode.init_layer.0", enc["in_channels"], c, k)
    spec.append(("encode.init_layer.1.weight", (1,), "prelu", 0))
    for i in range(enc["num_layers"]):
        for j in (0, 2):
            conv(f"encode.res_layers.{i}.block.{j}", c, c, k)
            spec.append((f"encode.res_layers.{i}.block.{j + 1}.weight", (1,), "prelu", 0))
    conv("encode.final.0", c, c, k)
    spec.append(("fuse.token", (dim,), "kernel", 1))
    for i in range(s["depth"]):
        key = f"fuse.layers.{i}"
        norm(f"{key}.norm1")
        linear(f"{key}.qkv", dim, 3 * inner, bias=False)
        linear(f"{key}.out", inner, dim)
        norm(f"{key}.norm2")
        linear(f"{key}.fc1", dim, mlp)
        linear(f"{key}.fc2", mlp, dim)
    norm("fuse.norm")
    conv("decode.conv", dim, s["scale"] ** 2, s["decoder_kernel"])
    spec.append(("decode.prelu.weight", (1,), "prelu", 0))
    return spec


class TRMISR:
    def __init__(self, network, precision: str = F32):
        self.enc, self.s = settings(network)
        self.ops = Ops(precision)
        self.r = round_tf32 if precision == TF32 else (lambda x: x)

    def _conv(self, p, key, x):
        w = p[f"{key}.weight"]
        return self.ops.conv2d(x, w, p[f"{key}.bias"], padding=w.shape[-1] // 2)

    def _linear(self, p, key, x):
        return self.ops.linear(x, p[f"{key}.weight"], p.get(f"{key}.bias"))

    def _norm(self, p, key, x):
        return F.layer_norm(x, x.shape[-1:], p[f"{key}.weight"], p[f"{key}.bias"], LN_EPS)

    def encode(self, p, x: torch.Tensor) -> torch.Tensor:
        x = F.prelu(self._conv(p, "encode.init_layer.0", x), p["encode.init_layer.1.weight"])
        for i in range(self.enc["num_layers"]):
            key = f"encode.res_layers.{i}.block"
            y = F.prelu(self._conv(p, f"{key}.0", x), p[f"{key}.1.weight"])
            x = x + F.prelu(self._conv(p, f"{key}.2", y), p[f"{key}.3.weight"])
        return self._conv(p, "encode.final.0", x)

    def attention(self, p, key: str, x: torch.Tensor, key_ok: torch.Tensor) -> torch.Tensor:
        """x (S, n, C), key_ok (S, n) -> the block's attention branch (S, n, C)."""
        s_, n, _ = x.shape
        h, d = self.s["heads"], self.s["head_dim"]
        qkv = self._linear(p, f"{key}.qkv", self._norm(p, f"{key}.norm1", x))
        q, k, v = (t.reshape(s_, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        scores = torch.matmul(self.r(q), self.r(k).transpose(-1, -2)) / math.sqrt(d)
        scores = scores.masked_fill(~key_ok[:, None, None, :], -math.inf)
        heads = torch.matmul(self.r(torch.softmax(scores, dim=-1)), self.r(v))  # (S, h, n, d)
        return self._linear(p, f"{key}.out", heads.transpose(1, 2).reshape(s_, n, h * d))

    def fuse(self, p, states: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
        """states (B, L, C, H, W), alphas (B, L) -> (B, C, H, W)."""
        b, l, c, hh, ww = states.shape
        views = states.permute(0, 3, 4, 1, 2).reshape(b * hh * ww, l, c)
        token = p["fuse.token"].reshape(1, 1, c).expand(b * hh * ww, 1, c)
        x = torch.cat([token, views], dim=1)
        key_ok = torch.cat([torch.ones_like(alphas, dtype=torch.bool)[:, :1], alphas > 0], dim=1)
        key_ok = key_ok.repeat_interleave(hh * ww, dim=0)  # (B·H·W, n), scene-major as x
        for i in range(self.s["depth"]):
            key = f"fuse.layers.{i}"
            x = x + self.attention(p, key, x, key_ok)
            y = F.gelu(self._linear(p, f"{key}.fc1", self._norm(p, f"{key}.norm2", x)))
            x = x + self._linear(p, f"{key}.fc2", y)
        fused = self._norm(p, "fuse.norm", x)[:, 0]
        return fused.reshape(b, hh, ww, c).permute(0, 3, 1, 2)

    def decode(self, p, f: torch.Tensor) -> torch.Tensor:
        y = F.prelu(self._conv(p, "decode.conv", f), p["decode.prelu.weight"])
        return F.pixel_shuffle(y, self.s["scale"])[:, 0]

    def forward(self, p, lrs: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
        b, l, h, w = lrs.shape
        anchor = torch.sort(lrs[:, :min(9, l)], dim=1).values[:, (min(9, l) - 1) // 2]
        x = torch.stack([lrs, anchor[:, None].expand(b, l, h, w)], dim=2)
        states = self.encode(p, x.reshape(b * l, 2, h, w)).reshape(b, l, -1, h, w)
        return self.decode(p, self.fuse(p, states, alphas))

    def __call__(self, p: Dict[str, torch.Tensor], lrs: torch.Tensor, alphas: torch.Tensor,
                 scenes_per_call: int | None = None) -> torch.Tensor:
        n = scenes_per_call or len(lrs)
        return torch.cat([self.forward(p, lrs[i:i + n], alphas[i:i + n])
                          for i in range(0, len(lrs), n)])
