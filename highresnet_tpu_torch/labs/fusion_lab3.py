"""Fusion lab 3 on the port: is the pair-pack kernel at its byte rate, and
what does the alpha gate cost in the real fusion loop?

The counterpart of ``examples/fusion_lab3.py``, with its report keys:

  pack_pallas       K1, the pair-pack kernel (``ops/fusion.py::pack_pairs``;
                    its plain version on the CPU), one round-1 pack of
                    (B, L, C, S, S) -> (B, L/2, 2C, S, S)
  pack_xla          the plain version, ``pack_pairs_ref`` (flip + cat)
  pack_equal        ``torch.equal`` of the two outputs
  fusion_gated_s    ``FusionNet.forward`` (pack + fuse block + gate)
  fusion_nogate_s   the same with ``alpha_residual=False`` (pack + fuse block)
  gate_only_s       alice + alpha_bob * fused, materialised, every round

``step_s`` is the median time of one pack and ``gb_per_s`` the bytes it
reads and writes over it. The fusion runs on the seeded
``HRNet(DEFAULT_CONFIG network)`` of fusion lab 1.

    python -m highresnet_tpu_torch.labs.fusion_lab3 [--device cuda|cpu] [--out PATH]
        [--dtype bfloat16|float32] [--batch 8 --views 16 --size 128 --channels 64]
        [--iters N] [--warmup N]

The report goes to ``--out`` (default ``build/labs/fusion_lab3_torch.json``).
"""

from __future__ import annotations

import copy
import json

import torch

from highresnet_tpu_torch.labs.common import (
    DTYPES,
    device_line,
    launches_since,
    median_s,
    parser,
    seeded_hrnet,
    write_report,
)
from highresnet_tpu_torch.ops import fusion
from highresnet_tpu_torch.runtime import setup_device

ROUTES = {"pack_pallas": fusion.pack_pairs, "pack_xla": fusion.pack_pairs_ref}


def gate_only(x: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    a = alphas[:, :, None, None, None]
    y = x
    while y.shape[1] // 2 > 0:
        half = y.shape[1] // 2
        a_bob = torch.flip(a[:, half:2 * half], dims=(1,))
        y = y[:, :half] + a_bob * (y[:, half:2 * half] * 1.0000001)
    return y


def parse_args(argv):
    p = parser("fusion_lab3", __doc__)
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = setup_device(args.device)
    dtype = DTYPES[args.dtype]
    b, l, s, c = args.batch, args.views, args.size, args.channels
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((b, l, c, s, s), generator=gen, device=device).to(dtype)
    alphas = torch.ones((b, l), device=device, dtype=dtype)
    report = {"device": device_line(device), "dtype": args.dtype, "batch": b, "views": l,
              "size": s, "channels": c, "iters": args.iters, "warmup": args.warmup}
    timed = lambda fn: median_s(fn, device, args.iters, args.warmup)  # noqa: E731
    before = dict(fusion.LAUNCHES)
    moved = 2 * x[:, :2 * (l // 2)].numel() * x.element_size()  # paired bytes, read + written
    for name, pack in ROUTES.items():
        step = timed(lambda: pack(x))
        report[name] = {"step_s": step, "gb_per_s": moved / step / 1e9}
    report["pack_equal"] = torch.equal(ROUTES["pack_pallas"](x), ROUTES["pack_xla"](x))

    gated = seeded_hrnet(c, device, dtype).fuse
    nogate = copy.deepcopy(gated)
    nogate.alpha_residual = False
    with torch.inference_mode():
        report["fusion_gated_s"] = timed(lambda: gated(x, alphas))
        report["fusion_nogate_s"] = timed(lambda: nogate(x, alphas))
        report["gate_only_s"] = timed(lambda: gate_only(x, alphas))
    report["launches"] = launches_since(before)
    write_report(report, args.out)
    return report


if __name__ == "__main__":
    print(json.dumps(main(), indent=2))
