"""Fusion lab 1 on the port: where fusion's and the decoder's non-conv time
goes, and which restructuring recovers it.

The counterpart of ``examples/fusion_lab.py``, with its report keys. The
variants run on a seeded ``HRNet(DEFAULT_CONFIG network)`` (the bench's
weights), so ``v0_current`` is the model's own ``FusionNet.forward`` (K1
packs the pairs on the card) and ``d0_current`` its ``Decoder``:

fusion (states (B, L, C, H, W), alphas all one):
  v0_current          ``FusionNet.forward``
  v_conv_only         the fuse block alone on pre-built pairs of every round
                      (the convs with their PReLUs; v0's time above this is
                      data movement)
  v1_no_concat        conv0 and conv_f split over alice and bob
                      (``w[:, :C]``, ``w[:, C:]``, the bias added once), so
                      the 2C pair and the 2C residual sum are never built
  v2_dist_residual    the pair kept for conv0; conv_f distributed over
                      (pair, h), so only the residual sum is never built
  v1/v2_max_abs_diff  against v0

decoder (fused (B, C, H, W)):
  d0_current          ``Decoder``: ConvTranspose2d(k = s = 3), PReLU, 1x1 conv
  d1_pre_d2s          the per-pixel C -> 9C product (a 1x1 conv), PReLU, the
                      1x1 projection of each sub-pixel, then ``pixel_shuffle``
                      of 9 single channels: PReLU and the 1x1 conv commute
                      with depth-to-space because kernel = stride, so the
                      full-resolution tensor has 1 channel instead of C
  d1_max_abs_diff     against d0

    python -m highresnet_tpu_torch.labs.fusion_lab [--device cuda|cpu] [--out PATH]
        [--dtype bfloat16|float32] [--batch 8 --views 16 --size 128 --channels 64]
        [--iters N] [--warmup N]

Inputs come from a seeded ``torch.Generator``; the report goes to ``--out``
(default ``build/labs/fusion_lab_torch.json``). A CUDA request without a
card raises.
"""

from __future__ import annotations

import json

import torch
import torch.nn.functional as F

from highresnet_tpu_torch.labs.common import (
    DTYPES,
    device_line,
    free,
    launches_since,
    median_s,
    parser,
    seeded_hrnet,
    write_report,
)
from highresnet_tpu_torch.models.hrnet import Decoder, FusionNet
from highresnet_tpu_torch.ops import fusion
from highresnet_tpu_torch.runtime import setup_device


def rounds(fuse: FusionNet, x: torch.Tensor, alphas: torch.Tensor, body) -> torch.Tensor:
    """FusionNet's rounds with ``body(alice, bob)`` in place of pack + fuse
    block: alice (B·half, C, H, W) the first half of the views, bob the
    next half flipped; returns the mean over the last views."""
    b, _, c, h, w = x.shape
    a = alphas[:, :, None, None, None]
    nviews = x.shape[1]
    while nviews // 2 > 0:
        half = nviews // 2
        alice = x[:, :half]
        bob = torch.flip(x[:, half:2 * half], dims=(1,))
        fused = body(alice.reshape(b * half, c, h, w), bob.reshape(b * half, c, h, w))
        x = alice + torch.flip(a[:, half:2 * half], dims=(1,)) * fused.reshape(b, half, c, h, w)
        a = a[:, :half]
        nviews = half
    return x.mean(dim=1)


def _parts(fuse: FusionNet, dtype: torch.dtype):
    """The fuse block's layers, their weights cast to ``dtype``."""
    res, conv_f, prelu_f = fuse.fuse
    conv0, prelu0, conv1, prelu1 = res.block
    cast = lambda conv: (conv.weight.to(dtype), conv.bias.to(dtype))  # noqa: E731
    return cast(conv0), prelu0, conv1, prelu1, cast(conv_f), prelu_f


def v0_current(fuse: FusionNet, x: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    return fuse(x, alphas)


def v_conv_only(fuse: FusionNet, pairs: list) -> list:
    return [fuse.fuse(p) for p in pairs]


def v1_no_concat(fuse: FusionNet, x: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    (w0, b0), prelu0, conv1, prelu1, (wf, bf), prelu_f = _parts(fuse, x.dtype)
    c = x.shape[2]
    w0a, w0b = w0[:, :c].contiguous(), w0[:, c:].contiguous()
    wfa, wfb = wf[:, :c].contiguous(), wf[:, c:].contiguous()

    def body(alice, bob):
        h = prelu0(F.conv2d(alice, w0a, b0, padding=1) + F.conv2d(bob, w0b, padding=1))
        h = prelu1(conv1(h))
        return prelu_f(F.conv2d(alice, wfa, bf, padding=1) + F.conv2d(bob, wfb, padding=1)
                       + F.conv2d(h, wf, padding=1))

    return rounds(fuse, x, alphas, body)


def v2_dist_residual(fuse: FusionNet, x: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    (w0, b0), prelu0, conv1, prelu1, (wf, bf), prelu_f = _parts(fuse, x.dtype)

    def body(alice, bob):
        pair = torch.cat([alice, bob], dim=1)
        h = prelu0(F.conv2d(pair, w0, b0, padding=1))
        h = prelu1(conv1(h))
        return prelu_f(F.conv2d(pair, wf, bf, padding=1) + F.conv2d(h, wf, padding=1))

    return rounds(fuse, x, alphas, body)


def d0_current(decode: Decoder, z: torch.Tensor) -> torch.Tensor:
    return decode(z)


def d1_pre_d2s(decode: Decoder, z: torch.Tensor) -> torch.Tensor:
    """``Decoder`` with depth-to-space last: out[b, o, s·i + u, s·j + v] =
    final(PReLU(sum_c z[b, c, i, j] W[c, :, u, v] + bias))[o]."""
    deconv, prelu = decode.deconv
    final = decode.final
    if final.kernel_size != (1, 1):
        raise ValueError(f"d1_pre_d2s needs the 1x1 final conv, got {final.kernel_size}")
    b, c, h, w = z.shape
    s = deconv.stride[0]
    wt = deconv.weight.to(z.dtype)  # (C, Cd, s, s)
    cd = wt.shape[1]
    # one 1x1 conv C -> s·s·Cd, output channel (u·s + v)·Cd + d
    y = F.conv2d(z, wt.permute(2, 3, 1, 0).reshape(s * s * cd, c, 1, 1),
                 deconv.bias.to(z.dtype).repeat(s * s))
    y = prelu(y)
    wo = final.weight.to(z.dtype)[:, :, 0, 0]  # (O, Cd)
    o = wo.shape[0]
    y = torch.matmul(wo, y.view(b, s * s, cd, h * w)) + final.bias.to(z.dtype)[:, None]
    y = y.view(b, s * s, o, h, w).transpose(1, 2).reshape(b, o * s * s, h, w)
    return F.pixel_shuffle(y, s)  # (B, O, sH, sW)


def round_pairs(b: int, l: int, c: int, s: int, randn) -> list:
    """A fresh (B·half, 2C, S, S) pair batch for every fusion round."""
    pairs = []
    while l // 2 > 0:
        pairs.append(randn(b * (l // 2), 2 * c, s, s))
        l //= 2
    return pairs


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def parse_args(argv):
    p = parser("fusion_lab", __doc__)
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = setup_device(args.device)
    dtype = DTYPES[args.dtype]
    b, l, s, c = args.batch, args.views, args.size, args.channels
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    model = seeded_hrnet(c, device, dtype)
    report = {"device": device_line(device), "dtype": args.dtype, "batch": b, "views": l,
              "size": s, "channels": c, "iters": args.iters, "warmup": args.warmup,
              "fusion": {}, "decoder": {}}
    timed = lambda fn: median_s(fn, device, args.iters, args.warmup)  # noqa: E731
    before = dict(fusion.LAUNCHES)
    with torch.inference_mode():
        fuse, out = model.fuse, report["fusion"]
        x, alphas = randn(b, l, c, s, s), torch.ones((b, l), device=device, dtype=dtype)
        out["v0_current_s"] = timed(lambda: v0_current(fuse, x, alphas))
        pairs = round_pairs(b, l, c, s, randn)
        out["v_conv_only_s"] = timed(lambda: v_conv_only(fuse, pairs))
        del pairs
        free(device)
        out["v1_no_concat_s"] = timed(lambda: v1_no_concat(fuse, x, alphas))
        out["v2_dist_residual_s"] = timed(lambda: v2_dist_residual(fuse, x, alphas))
        r0 = v0_current(fuse, x, alphas)
        for name, fn in (("v1", v1_no_concat), ("v2", v2_dist_residual)):
            out[f"{name}_max_abs_diff"] = max_abs_diff(fn(fuse, x, alphas), r0)
        out["v0_max_abs"] = r0.float().abs().max().item()
        del x, r0
        free(device)

        decode, out = model.decode, report["decoder"]
        z = randn(b, c, s, s)
        out["d0_current_s"] = timed(lambda: d0_current(decode, z))
        out["d1_pre_d2s_s"] = timed(lambda: d1_pre_d2s(decode, z))
        a0 = d0_current(decode, z)
        out["d1_max_abs_diff"] = max_abs_diff(d1_pre_d2s(decode, z), a0)
        out["d0_max_abs"] = a0.float().abs().max().item()
    report["launches"] = launches_since(before)
    write_report(report, args.out)
    return report


if __name__ == "__main__":
    print(json.dumps(main(), indent=2))
