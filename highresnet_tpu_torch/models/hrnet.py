"""HRNet: multi-frame super-resolution by recursive pairwise fusion.

The counterpart of ``highresnet_tpu/models/hrnet.py``. Public shapes are the
JAX package's: ``lrs`` (B, L, H, W), ``alphas`` (B, L), SR (B, 3H, 3W).
Inside, states are NCHW with views kept apart: (B, L, C, H, W).

Submodule names equal the reference ``HRNet.pth`` state-dict keys
(``encode.init_layer.0``, ``encode.res_layers.N.block.*``, ``fuse.fuse.*``,
``decode.deconv.*``, ``decode.final``), so the JAX package's
``hrnet_params_from_torch`` reads this module's ``state_dict()`` unchanged.

Every parameter is drawn as the JAX package's flax modules draw it: each
kernel from ``lecun_normal`` (``models/layers.py::lecun_normal_``), every
bias zero, PReLU at 0.25. The draws come from an explicit ``torch.Generator``
on the CPU in module order, then move to the device, so one seed gives the
same weights on every device. Parameters stay float32 whatever the compute
dtype and are cast at use (``models/layers.py``), as in the JAX package.

``HRNet.shard_views(group)`` makes train mode split the views over the M
ranks of a view group (the 2-D layout, ``parallel/mesh.py``), as JAX's step
does with ``shard_views`` on a ``data x view`` mesh. Every rank holds its
replica's whole batch and computes the anchor; rank v encodes views
[v·L/M, (v+1)·L/M). A fusion round of ``half`` pairs with ``half % M == 0``
is sharded: after ``gather_views`` rank v packs its pairs [j0, j1) =
[v·half/M, (v+1)·half/M) from ``cat(x[:, j0:j1], x[:, 2·half−j1 : 2·half−j0])``,
whose pair j' is exactly [x_{j0+j'} ‖ x_{2·half−1−j0−j'}], so the pack
kernel runs unchanged on each rank's block, and the new state is the
rank's block of views [j0, j1). The first round that does not split (fewer
or an odd count of pairs) gathers the views, and it and every later round,
the final mean, the decoder and everything after run replicated on each
rank. Eval mode always runs the whole forward.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from highresnet_tpu_torch.models.layers import Conv2d, ConvTranspose2d, PReLU, lecun_normal_
from highresnet_tpu_torch.ops.fusion import pack_pairs, pack_pairs_ref
from highresnet_tpu_torch.parallel.distributed import gather_views, process_count, process_index
from highresnet_tpu_torch.utils.profiling import span


def lower_median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Median that returns the lower middle value for an even count, as
    ``torch.median`` does. Taken from a sort: CUDA's ``torch.median(dim)``
    refuses deterministic mode."""
    n = x.shape[dim]
    return torch.sort(x, dim=dim).values.select(dim, (n - 1) // 2)


def _conv(c_in: int, c_out: int, k: int) -> Conv2d:
    return Conv2d(c_in, c_out, k, padding="same")


class ResidualBlock(nn.Module):
    """conv -> PReLU -> conv -> PReLU, with skip."""

    def __init__(self, channels: int = 64, kernel_size: int = 3):
        super().__init__()
        self.block = nn.Sequential(
            _conv(channels, channels, kernel_size),
            PReLU(1),
            _conv(channels, channels, kernel_size),
            PReLU(1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block(x)


class Encoder(nn.Module):
    """Shared per-view encoder: init conv+PReLU, N residual blocks, final conv."""

    def __init__(self, in_channels=2, channels=64, num_layers=2, kernel_size=3):
        super().__init__()
        self.init_layer = nn.Sequential(_conv(in_channels, channels, kernel_size), PReLU(1))
        self.res_layers = nn.Sequential(
            *[ResidualBlock(channels, kernel_size) for _ in range(num_layers)]
        )
        self.final = nn.Sequential(_conv(channels, channels, kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.final(self.res_layers(self.init_layer(x)))


class FusionNet(nn.Module):
    """Recursive pairwise fusion with one shared fuse block.

    Per round: pack L states into L//2 pairs (alice ‖ flipped bob on the
    channels; an odd last view is dropped), apply ResidualBlock(2C) + conv
    2C->C + PReLU, and with ``alpha_residual`` gate by bob's alpha so padded
    views pass alice through unchanged: x = alice + alpha_bob * fused. The
    remaining views are averaged at the end.

    ``use_pallas_pack`` keeps the JAX config key's name: None or True packs
    through the hand-written kernel on CUDA (plain version on the CPU),
    False always uses the plain version.
    """

    def __init__(self, channels=64, kernel_size=3, alpha_residual=True, use_pallas_pack=None):
        super().__init__()
        self.alpha_residual = alpha_residual
        self.use_pallas_pack = use_pallas_pack
        self.fuse = nn.Sequential(
            ResidualBlock(2 * channels, kernel_size),
            _conv(2 * channels, channels, kernel_size),
            PReLU(1),
        )

    def forward(self, x: torch.Tensor, alphas: torch.Tensor, view_group=None) -> torch.Tensor:
        # x: (B, L, C, H, W), or with view_group this rank's block of L/M views; alphas: (B, L)
        b, _, c, h, w = x.shape
        pack = pack_pairs_ref if self.use_pallas_pack is False else pack_pairs
        alphas = alphas[:, :, None, None, None]
        nviews = alphas.shape[1]
        m = process_count(view_group) if view_group is not None else 1
        sharded = m > 1
        while nviews // 2 > 0:
            with span("hrnet.fuse.round"):
                half = nviews // 2
                if sharded and half % m:  # this round and the rest run replicated
                    x, sharded = gather_views(x, view_group), False
                if sharded:
                    x = gather_views(x, view_group)
                    v = process_index(view_group)
                    j0, j1 = v * half // m, (v + 1) * half // m
                    bob = slice(2 * half - j1, 2 * half - j0)
                    alice = x[:, j0:j1]
                    pair = pack(torch.cat([alice, x[:, bob]], dim=1))
                else:
                    bob = slice(half, 2 * half)
                    alice = x[:, :half]
                    pair = pack(x)  # (B, half, 2C, H, W)
                n = pair.shape[1]
                fused = self.fuse(pair.reshape(b * n, 2 * c, h, w)).reshape(b, n, c, h, w)
                if self.alpha_residual:
                    a_bob = torch.flip(alphas[:, bob], dims=(1,))
                    x = alice + a_bob * fused
                    alphas = alphas[:, :half]
                else:
                    x = fused
                nviews = half
        return x.mean(dim=1)  # (B, C, H, W)


class Decoder(nn.Module):
    """3x upsampling: ConvTranspose2d(k = stride) + PReLU, then a final conv."""

    def __init__(self, in_channels=64, channels=64, out_channels=1, scale=3, final_kernel=1):
        super().__init__()
        self.deconv = nn.Sequential(
            ConvTranspose2d(in_channels, channels, scale, stride=scale),
            PReLU(1),
        )
        self.final = _conv(channels, out_channels, final_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.final(self.deconv(x))


class HRNet(nn.Module):
    """forward(lrs (B, L, H, W), alphas (B, L)) -> (B, 3H, 3W) float32 SR.

    The anchor frame is the lower median of the first min(9, L) views,
    stacked with every view as a second input channel.
    ``dtype`` is the encoder+fusion compute dtype and ``decoder_dtype`` the
    decoder's (None: same), as ``runtime.compute_dtypes`` maps them; the
    parameters stay float32 and the output is float32.
    """

    def __init__(
        self,
        config: Dict[str, Any] | None = None,
        *,
        device: str | torch.device = "cpu",
        dtype: torch.dtype = torch.float32,
        decoder_dtype: torch.dtype | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        cfg = config or {}
        enc = cfg.get("encoder", {})
        rec = cfg.get("recursive", {})
        dec = cfg.get("decoder", {})
        dd, df = dec.get("deconv", {}), dec.get("final", {})
        self.dtype = dtype
        self.decoder_dtype = decoder_dtype or dtype
        channels = enc.get("channel_size", 64)
        with torch.device("meta"):
            self.encode = Encoder(
                in_channels=enc.get("in_channels", 2),
                channels=channels,
                num_layers=enc.get("num_layers", 2),
                kernel_size=enc.get("kernel_size", 3),
            )
            self.fuse = FusionNet(
                channels=rec.get("in_channels", 64),
                kernel_size=rec.get("kernel_size", 3),
                alpha_residual=rec.get("alpha_residual", True),
                use_pallas_pack=rec.get("use_pallas_pack"),
            )
            self.decode = Decoder(
                in_channels=rec.get("in_channels", 64),
                channels=dd.get("out_channels", 64),
                out_channels=df.get("out_channels", 1),
                scale=dd.get("stride", 3),
                final_kernel=df.get("kernel_size", 1),
            )
        self.to_empty(device="cpu")
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        self.to(device=device)

    view_group = None

    def shard_views(self, group=None) -> None:
        """Split train mode's views over the ranks of ``group`` (None: off;
        see the module notes)."""
        self.view_group = group

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init, drawn from ``generator`` in module order: lecun-normal
        kernels with JAX's fan_in (a Conv2d's in·k·k; the deconv's from its
        JAX shape (s, s, C_in, C_out), so C_in·s·s, where torch's fan-in
        helper would read C_out from the (C_in, C_out, s, s) weight), zero
        biases, PReLU at 0.25."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                lecun_normal_(m.weight, m.in_channels * math.prod(m.kernel_size), generator)
                m.bias.zero_()
            elif isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)

    def forward(self, lrs: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
        b, l, h, w = lrs.shape
        group = self.view_group if self.training else None
        with span("hrnet.encode"):
            refs = lower_median(lrs[:, : min(9, l)], dim=1)  # (B, H, W)
            if group is not None:  # this rank's block of views
                m, v = process_count(group), process_index(group)
                if l % m:
                    raise ValueError(f"the batch's {l} views do not divide over view={m}")
                lrs = lrs[:, v * l // m:(v + 1) * l // m]
            k = lrs.shape[1]
            refs = refs[:, None].expand(b, k, h, w)
            x = torch.stack([lrs, refs], dim=2).to(self.dtype)  # (B, k, 2, H, W)
            states = self.encode(x.reshape(b * k, 2, h, w))
            states = states.reshape(b, k, *states.shape[1:])
        with span("hrnet.fuse"):
            fused = self.fuse(states, alphas.to(states.dtype), group)  # (B, C, H, W)
        with span("hrnet.decode"):
            sr = self.decode(fused.to(self.decoder_dtype))  # (B, 1, 3H, 3W)
            return sr[:, 0].to(torch.float32)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
