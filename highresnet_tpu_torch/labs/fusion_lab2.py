"""Fusion lab 2 on the port: fusion's non-conv time piece by piece, copy
rates at the fusion's shapes, and the fusion on flat states.

The counterpart of ``examples/fusion_lab2.py``, with its report keys, on
the seeded ``HRNet(DEFAULT_CONFIG network)`` of fusion lab 1:

pieces (no convs; each round of the fusion tree):
  p_concat      the model's pair pack (``ops/fusion.py::pack_pairs``: K1 on
                the card, slices + flip + channel concat on the CPU), the
                next round's states kept data-dependent
  p_gate        alice + alpha_bob * fused, bob's half standing in for fused
  p_mean        the final view mean
copy probes (read + write; ``gb_per_s`` and, on the card, ``share_of_hbm``,
its share of the H100's 3.35 TB/s):
  bw_c64        x + 1 on (B, L, 64, S, S)
  bw_c128       x + 1 on (B, L/2, 128, S, S): does NCHW copy at the same
                rate at C = 64 and at C = 128?
  bw_concat64   the channel concat of two (B·L/2, 64, S, S) halves
controls:
  full_v0       ``FusionNet.forward``
  conv_only     the fuse block on pre-built pairs of every round
variant:
  v3_flat       the states kept as (L·B, C, H, W), view-major, paired
                through dim-0 slices (alice one slice, bob the reversed
                view blocks of the next half), no 5-D tensor anywhere;
                ``v3_max_abs_diff`` against full_v0 (``v0_max_abs`` its
                largest magnitude)

``examples/fusion_lab2.py`` names a ``v4_revconv`` in its docstring but
never computes it; it is not here either.

    python -m highresnet_tpu_torch.labs.fusion_lab2 [--device cuda|cpu] [--out PATH]
        [--dtype bfloat16|float32] [--batch 8 --views 16 --size 128 --channels 64]
        [--iters N] [--warmup N]

The report goes to ``--out`` (default ``build/labs/fusion_lab2_torch.json``).
"""

from __future__ import annotations

import json

import torch

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
from highresnet_tpu_torch.labs.fusion_lab import max_abs_diff, round_pairs, v_conv_only
from highresnet_tpu_torch.models.hrnet import FusionNet
from highresnet_tpu_torch.ops import fusion
from highresnet_tpu_torch.runtime import setup_device

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


def p_concat(x: torch.Tensor) -> list:
    pairs = []
    y = x
    while y.shape[1] // 2 > 0:
        half = y.shape[1] // 2
        pairs.append(fusion.pack_pairs(y))
        y = y[:, :half] * 1.000001  # keep the rounds data-dependent
    return pairs


def p_gate(x: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    a = alphas[:, :, None, None, None]
    y = x
    while y.shape[1] // 2 > 0:
        half = y.shape[1] // 2
        y = y[:, :half] + torch.flip(a[:, half:2 * half], dims=(1,)) * y[:, half:2 * half]
    return y


def to_flat(x: torch.Tensor, alphas: torch.Tensor) -> tuple:
    """(B, L, C, H, W), (B, L) -> the view-major (L·B, C, H, W), (L·B)."""
    b, l = alphas.shape
    return x.transpose(0, 1).reshape(l * b, *x.shape[2:]), alphas.t().reshape(l * b)


def v3_flat(fuse: FusionNet, xf: torch.Tensor, af: torch.Tensor, batch: int) -> torch.Tensor:
    """FusionNet on view-major flat states: row v·B + i is view v of scene i."""
    nviews = xf.shape[0] // batch
    rows = lambda v: slice(v * batch, (v + 1) * batch)  # noqa: E731
    while nviews // 2 > 0:
        half = nviews // 2
        alice = xf[:half * batch]
        bob = torch.cat([xf[rows(v)] for v in range(2 * half - 1, half - 1, -1)])
        a_bob = torch.cat([af[rows(v)] for v in range(2 * half - 1, half - 1, -1)])
        fused = fuse.fuse(torch.cat([alice, bob], dim=1))
        xf = alice + a_bob[:, None, None, None] * fused
        af = af[:half * batch]
        nviews = half
    return sum(xf[rows(v)] for v in range(nviews)) / nviews


def copy_probe(step_s: float, nbytes: int, device: torch.device) -> dict:
    """``nbytes`` read and written in ``step_s``; the share of the H100's
    memory rate only for a card (None on the CPU)."""
    rate = 2 * nbytes / step_s
    return {"step_s": step_s, "gb_per_s": rate / 1e9,
            "share_of_hbm": rate / HBM_BYTES_PER_S if device.type == "cuda" else None}


def parse_args(argv):
    p = parser("fusion_lab2", __doc__)
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

    fuse = seeded_hrnet(c, device, dtype).fuse
    report = {"device": device_line(device), "dtype": args.dtype, "batch": b, "views": l,
              "size": s, "channels": c, "iters": args.iters, "warmup": args.warmup}
    timed = lambda fn: median_s(fn, device, args.iters, args.warmup)  # noqa: E731
    before = dict(fusion.LAUNCHES)
    with torch.inference_mode():
        x, alphas = randn(b, l, c, s, s), torch.ones((b, l), device=device, dtype=dtype)
        report["p_concat_s"] = timed(lambda: p_concat(x))
        report["p_gate_s"] = timed(lambda: p_gate(x, alphas))
        report["p_mean_s"] = timed(lambda: x.mean(dim=1))

        for name, shape in (("bw_c64", (b, l, 64, s, s)), ("bw_c128", (b, l // 2, 128, s, s))):
            z = randn(*shape)
            report[name] = copy_probe(timed(lambda: z + 1), z.numel() * z.element_size(),
                                      device)
            del z
        u, v = randn(b * l // 2, 64, s, s), randn(b * l // 2, 64, s, s)
        report["bw_concat64"] = copy_probe(timed(lambda: torch.cat([u, v], dim=1)),
                                           2 * u.numel() * u.element_size(), device)
        del u, v
        free(device)

        report["full_v0_s"] = timed(lambda: fuse(x, alphas))
        pairs = round_pairs(b, l, c, s, randn)
        report["conv_only_s"] = timed(lambda: v_conv_only(fuse, pairs))
        del pairs
        free(device)

        xf, af = to_flat(x, alphas)
        report["v3_flat_s"] = timed(lambda: v3_flat(fuse, xf, af, b))
        r0 = fuse(x, alphas)
        report["v3_max_abs_diff"] = max_abs_diff(v3_flat(fuse, xf, af, b), r0)
        report["v0_max_abs"] = r0.float().abs().max().item()
    report["launches"] = launches_since(before)
    write_report(report, args.out)
    return report


if __name__ == "__main__":
    print(json.dumps(main(), indent=2))
