"""TR-MISR: multi-image super-resolution by transformer fusion.

An, Zhang, Huo, Xue, Wang and Pan, "TR-MISR: Multiimage Super-Resolution
Based on Feature Fusion With Transformers", IEEE J. Sel. Topics Appl. Earth
Observ. Remote Sens. 15, 2022 (code: https://github.com/Suanmd/TR-MISR). The
network of ``network.arch: "trmisr"``, with HRNet's call and shapes:
``forward(lrs (B, L, H, W), alphas (B, L))`` -> SR (B, sH, sW) float32.

With C = ``dim`` (the encoder's ``channel_size``), h heads of width d, depth
D, MLP width M and n = L + 1 tokens (``config.TRANSFORMER_DEFAULTS``: 64, 8,
64, 6, 128):

- encode, as HRNet does and by its code: the lower median of the first
  min(9, L) views stacked with every view, through HRNet's ``Encoder``
  over the B·L views: (B, L, C, H, W);
- tokens: every pixel is a sequence of its L views' features, after the
  learned token t ∈ ℝᶜ (the same for every pixel): (B·H·W, n, C). No
  positional code, so the SR does not depend on the order of the views;
- mask: the token and the views with alpha > 0 are the keys that count; a
  padded view's key takes no weight, so its contents never reach the SR;
- D pre-norm blocks: x += Drop(W_o · MHA(LN₁(x)) + b_o), where
  [q, k, v] = LN₁(x) · W_qkv (no bias) in h heads and each head's
  softmax(q kᵀ / √d, masked keys at −∞) · v, concatenated to h·d
  (``ops.attention.attend``: the kernel K5 on CUDA); then
  x += Drop(W₂ · Drop(GELU(W₁ · LN₂(x) + b₁)) + b₂), GELU exact (erf);
- fused state: LN_f of the token's row, (B, C, H, W);
- decode (sub-pixel): PixelShuffle_s(PReLU(conv C → s², kernel k, same)).

Dropout (rate ``dropout``) acts in train mode only and draws its masks
from the ``torch.Generator`` passed to ``forward``, never from the global
RNG, so a run that saves the generator redraws the same masks on resume.
Setting the attribute to 0 turns it off, as the parity checks do.

Parameters are drawn from an explicit ``torch.Generator`` on the CPU in
module order, as HRNet's are: the encoder exactly as HRNet's, the token
from a unit normal, every linear and the decoder's kernel lecun-normal with
zero biases, the LayerNorms at 1 and 0, PReLU at 0.25. The network
computes in float32. Spans: ``trmisr.encode``, ``trmisr.transformer`` (the
tokens, the blocks, the final norm and the token's row), nested in it one
``trmisr.attend`` a block (from q, k and v to the heads' output, before
W_o), and ``trmisr.decode``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from highresnet_tpu_torch.config import transformer_settings
from highresnet_tpu_torch.models.hrnet import Encoder, lower_median
from highresnet_tpu_torch.models.layers import Conv2d, PReLU, lecun_normal_
from highresnet_tpu_torch.ops.attention import attend
from highresnet_tpu_torch.utils.profiling import span

WEIGHTS_NAME = "TRNet.pth"


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout at ``rate`` with a mask drawn from ``generator``."""
    if generator is None:
        raise ValueError("TR-MISR in train mode draws its dropout masks from a generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Block(nn.Module):
    """One pre-norm transformer block (the module notes)."""

    def __init__(self, dim: int, heads: int, head_dim: int, mlp_dim: int):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * heads * head_dim, bias=False)
        self.out = nn.Linear(heads * head_dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor, rate: float,
                generator: torch.Generator | None) -> torch.Tensor:
        drop = (lambda y: dropout(y, rate, generator)) if rate > 0 else (lambda y: y)
        qkv = self.qkv(self.norm1(x))
        with span("trmisr.attend"):
            a = attend(qkv, key_bias, self.heads)
        x = x + drop(self.out(a))
        return x + drop(self.fc2(drop(F.gelu(self.fc1(self.norm2(x))))))


class TransformerFusion(nn.Module):
    """The learned token, ``depth`` blocks and the final LayerNorm: the views'
    features (B, L, C, H, W) and alphas (B, L) -> the fused state (B, C, H, W)."""

    def __init__(self, dim: int, depth: int, heads: int, head_dim: int, mlp_dim: int):
        super().__init__()
        self.token = nn.Parameter(torch.empty(dim))
        self.layers = nn.ModuleList([Block(dim, heads, head_dim, mlp_dim) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim)

    def forward(self, states: torch.Tensor, alphas: torch.Tensor, rate: float,
                generator: torch.Generator | None) -> torch.Tensor:
        b, l, c, h, w = states.shape
        views = states.permute(0, 3, 4, 1, 2).reshape(b, h * w, l, c)
        x = torch.cat([self.token.expand(b, h * w, 1, c), views], dim=2)  # (B, P, n, C)
        key_ok = torch.cat([alphas.new_ones(b, 1), alphas], dim=1) > 0
        key_bias = torch.zeros_like(key_ok, dtype=x.dtype).masked_fill(~key_ok, -math.inf)
        for block in self.layers:
            x = block(x, key_bias, rate, generator)
        fused = self.norm(x[:, :, 0])  # LayerNorm acts token by token: the token's row alone
        return fused.reshape(b, h, w, c).permute(0, 3, 1, 2)


class SubPixelDecoder(nn.Module):
    """conv C → s² (same), PReLU, pixel shuffle by s: (B, C, H, W) -> (B, sH, sW)."""

    def __init__(self, channels: int, scale: int, kernel_size: int):
        super().__init__()
        self.scale = scale
        self.conv = Conv2d(channels, scale * scale, kernel_size, padding="same")
        self.prelu = PReLU(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pixel_shuffle(self.prelu(self.conv(x)), self.scale)[:, 0]


class TRNet(nn.Module):
    """forward(lrs (B, L, H, W), alphas (B, L)[, generator]) -> (B, sH, sW)
    float32 SR (the module notes). ``config`` is the network section."""

    def __init__(self, config: Dict[str, Any] | None = None, *,
                 device: str | torch.device = "cpu", generator: torch.Generator | None = None):
        super().__init__()
        cfg = config or {}
        enc = cfg.get("encoder", {})
        s = transformer_settings(cfg)
        channels = enc.get("channel_size", 64)
        if s["dim"] != channels:
            raise ValueError(f"network.transformer.dim ({s['dim']}) must equal the encoder's "
                             f"channel_size ({channels}): the tokens are its features")
        self.dropout = float(s["dropout"])
        with torch.device("meta"):
            self.encode = Encoder(
                in_channels=enc.get("in_channels", 2),
                channels=channels,
                num_layers=enc.get("num_layers", 2),
                kernel_size=enc.get("kernel_size", 3),
            )
            self.fuse = TransformerFusion(s["dim"], s["depth"], s["heads"], s["head_dim"],
                                          s["mlp_dim"])
            self.decode = SubPixelDecoder(s["dim"], s["scale"], s["decoder_kernel"])
        self.to_empty(device="cpu")
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        self.to(device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Drawn from ``generator`` in module order (the module notes); a
        kernel's fan-in is its input features, or a conv's in·k·k."""
        for m in self.modules():
            if isinstance(m, TransformerFusion):
                m.token.normal_(generator=generator)
            elif isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, m.in_channels * math.prod(m.kernel_size), generator)
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)

    def shard_views(self, group=None) -> None:
        """Attention spans every view of a pixel: no view axis."""
        if group is not None:
            raise ValueError("TR-MISR does not split its views over a view axis (training.mesh)")

    def forward(self, lrs: torch.Tensor, alphas: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b, l, h, w = lrs.shape
        with span("trmisr.encode"):
            lrs = lrs.float()
            refs = lower_median(lrs[:, : min(9, l)], dim=1)[:, None].expand(b, l, h, w)
            x = torch.stack([lrs, refs], dim=2).reshape(b * l, 2, h, w)
            states = self.encode(x).reshape(b, l, -1, h, w)
        rate = self.dropout if self.training else 0.0
        with span("trmisr.transformer"):
            fused = self.fuse(states, alphas.float(), rate, generator)
        with span("trmisr.decode"):
            return self.decode(fused)
