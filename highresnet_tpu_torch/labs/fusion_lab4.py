"""Fusion lab 4 on the port: the pair pack's routes, pair vs split conv, bf16 forwards.

The counterpart of ``examples/fusion_lab4.py``, with the same report keys:

  pack_pallas        K1, the pair-pack kernel (``ops/fusion.py``)
  pack_stack_xla     the lab's stack + reshape pack (``ops/fusion_dma.py::pack_stack_ref``)
  pack_dma           K4, the bulk-copy pack (``ops/fusion_dma.py``), with
                     ``correct`` (``torch.equal`` to ``pack_pairs_ref``) and
                     ``launches`` (K4's launches in this run)
  pack_ref           the plain version, ``torch.cat`` + ``flip``
  pack_index_select  one ``torch.index_select`` call (the library yardstick)
  pairconv           conv3x3(pair 2C -> 2C) at round-1 shapes, NCHW
  splitconv          conv3x3(alice, w[:, :C]) + conv3x3(bob, w[:, C:]), with
                     ``max_abs_diff`` against pairconv and pairconv's
                     ``max_abs_pair``
  fwd_bf16_batchN    HRNet(DEFAULT_CONFIG network) in bf16 on seeded random
                     weights and inputs, with ``scenes_per_s`` and ``finite``

    python -m highresnet_tpu_torch.labs.fusion_lab4 [--device cuda|cpu] [--out PATH]
        [--batch 8 --views 16 --size 128 --channels 64] [--fwd-batches 16 32]
        [--iters N] [--warmup N]

Each time is the median over ``--iters`` calls after ``--warmup`` calls:
CUDA events on the card, the host clock on the CPU. ``device`` is the card's
``nvidia-smi`` name and power limit, or ``"cpu"``. The report goes to
``--out`` (default ``build/fusion_lab4_torch.json``). A CUDA request without
a card raises.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from highresnet_tpu_torch.config import DEFAULT_CONFIG
from highresnet_tpu_torch.labs.common import device_line, median_s, write_report
from highresnet_tpu_torch.models.hrnet import HRNet
from highresnet_tpu_torch.ops import fusion, fusion_dma
from highresnet_tpu_torch.runtime import setup_device

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "fusion_lab4_torch.json"


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m highresnet_tpu_torch.labs.fusion_lab4",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--views", type=int, default=16)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--fwd-batches", type=int, nargs="*", default=[16, 32])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = setup_device(args.device)
    dtype = torch.bfloat16
    b, l, s, c = args.batch, args.views, args.size, args.channels
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    report = {
        "device": device_line(device),
        "shape": {"batch": b, "views": l, "size": s, "channels": c},
        "dtype": "bfloat16",
        "iters": args.iters,
        "warmup": args.warmup,
    }

    def add(name, fn, bytes_moved=None):
        step = median_s(fn, device, args.iters, args.warmup)
        report[name] = {"step_s": step}
        if bytes_moved:
            report[name]["gb_per_s"] = bytes_moved / step / 1e9
        return report[name]

    x = randn(b, l, c, s, s)
    moved = 2 * x[:, : 2 * (l // 2)].numel() * x.element_size()  # paired bytes, read + written
    add("pack_pallas", lambda: fusion.pack_pairs(x), moved)
    add("pack_stack_xla", lambda: fusion_dma.pack_stack_ref(x), moved)
    before = fusion_dma.LAUNCHES
    correct = torch.equal(fusion_dma.pack_pairs_dma(x), fusion_dma.pack_pairs_ref(x))
    add("pack_dma", lambda: fusion_dma.pack_pairs_dma(x), moved)
    report["pack_dma"].update(correct=correct, launches=fusion_dma.LAUNCHES - before)
    add("pack_ref", lambda: fusion_dma.pack_pairs_ref(x), moved)
    order = fusion_dma.pair_order(l, device)
    add("pack_index_select", lambda: fusion_dma.pack_index_select(x, order), moved)
    del x

    # isolated conv comparison at round-1 shapes (examples/fusion_lab4.py:129-136), NCHW
    n = b * l // 2
    alice, bob = randn(n, c, s, s), randn(n, c, s, s)
    pair = torch.cat([alice, bob], dim=1)
    w0 = (torch.randn((2 * c, 2 * c, 3, 3), generator=gen, device=device) / 34).to(dtype)
    w0a, w0b = w0[:, :c].contiguous(), w0[:, c:].contiguous()
    with torch.inference_mode():
        add("pairconv", lambda: F.conv2d(pair, w0, padding=1))
        add("splitconv", lambda: F.conv2d(alice, w0a, padding=1) + F.conv2d(bob, w0b, padding=1))
        diff = F.conv2d(pair, w0, padding=1).float() - (
            F.conv2d(alice, w0a, padding=1) + F.conv2d(bob, w0b, padding=1)).float()
        report["splitconv"].update(max_abs_diff=diff.abs().max().item(),
                                   max_abs_pair=F.conv2d(pair, w0, padding=1).abs().max().item())
    del alice, bob, pair, diff

    # full-forward batch scaling, bf16 compute on f32 parameters
    net = DEFAULT_CONFIG["network"]
    for batch in args.fwd_batches:
        model = HRNet(net, device=device, dtype=dtype,
                      generator=torch.Generator().manual_seed(0)).eval()
        rng = np.random.default_rng(0)
        lrs = torch.from_numpy(rng.random((batch, l, s, s), dtype=np.float32)).to(device)
        alphas = torch.ones((batch, l), device=device)
        with torch.inference_mode():
            finite = bool(torch.isfinite(model(lrs, alphas)).all())
            entry = add(f"fwd_bf16_batch{batch}", lambda: model(lrs, alphas))
        entry.update(scenes_per_s=batch / entry["step_s"], finite=finite)
        del model

    write_report(report, args.out)
    return report


if __name__ == "__main__":
    print(json.dumps(main(), indent=2))
