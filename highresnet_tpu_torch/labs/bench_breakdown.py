"""Where the bench's forward spends its time, stage by stage, and the conv
rate the card reaches at the model's own conv shapes.

The counterpart of ``examples/bench_breakdown.py``, with its report keys.
For f32 and for bf16, on a seeded
``HRNet(DEFAULT_CONFIG network)`` (the bench's weights) and the bench's
inputs (``np.random.default_rng(0)``), each timed alone:

  full_forward_s        ``HRNet.forward``
  prep_median_stack_s   the lower median of the first min(9, L) views, the
                        stack with every view and the cast
  encoder_s             the encoder over the folded (B·L) views
  fusion_s              the fusion tree (K1 packs the pairs on the card)
  decoder_s             the decoder
  stage_sum_s           the four stages' sum
  conv64_stack          a bare stack of 3x3 convs over B·L images, 64 -> 64,
                        depth 6, and
  conv128_stack         over B·L/2 images, 128 -> 128, depth 3: the model's
                        encoder and fusion conv shapes, each
                        2·N·S²·9·(Cin·Cout + (depth-1)·Cout²) FLOP (0.928 T
                        at the default shapes), with ``tflops_per_s``

The stages chained (``prep``, ``encode``, ``fuse``, ``decode``) compute
``HRNet.forward`` exactly. The report's ``cudnn`` entry records the flags in
force (``runtime.setup_device`` on the card: deterministic algorithms on,
``benchmark`` off, TF32 off).

    python -m highresnet_tpu_torch.labs.bench_breakdown [--device cuda|cpu] [--out PATH]
        [--batch 8 --views 16 --size 128 --channels 64]
        [--iters N] [--warmup N]

The report goes to ``--out`` (default ``build/labs/bench_breakdown_torch.json``).
"""

from __future__ import annotations

import json

import numpy as np
import torch
from torch import nn

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
from highresnet_tpu_torch.models.hrnet import HRNet, lower_median
from highresnet_tpu_torch.models.layers import Conv2d, lecun_normal_
from highresnet_tpu_torch.ops import fusion
from highresnet_tpu_torch.runtime import setup_device


def prep(model: HRNet, lrs: torch.Tensor) -> torch.Tensor:
    """(B, L, H, W) -> the encoder's (B·L, 2, H, W) input in the model's dtype."""
    b, l, h, w = lrs.shape
    refs = lower_median(lrs[:, :min(9, l)], dim=1)[:, None].expand(b, l, h, w)
    return torch.stack([lrs, refs], dim=2).to(model.dtype).reshape(b * l, 2, h, w)


def encode(model: HRNet, x: torch.Tensor, batch: int) -> torch.Tensor:
    states = model.encode(x)
    return states.reshape(batch, -1, *states.shape[1:])


def fuse(model: HRNet, states: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    return model.fuse(states, alphas.to(states.dtype))


def decode(model: HRNet, fused: torch.Tensor) -> torch.Tensor:
    return model.decode(fused.to(model.decoder_dtype))[:, 0].to(torch.float32)


def conv_stack(images: int, size: int, cin: int, cout: int, depth: int, device, dtype,
               timed) -> dict:
    """A bare stack of 3x3 convs (lecun-normal kernels, zero biases, f32
    parameters cast at use) on [0, 1) inputs: its time and TFLOP/s."""
    gen = torch.Generator().manual_seed(0)
    convs = []
    for i in range(depth):
        conv = Conv2d(cin if i == 0 else cout, cout, 3, padding="same")
        with torch.no_grad():
            lecun_normal_(conv.weight, conv.in_channels * 9, gen)
            conv.bias.zero_()
        convs.append(conv)
    stack = nn.Sequential(*convs).to(device)
    x = torch.rand((images, cin, size, size), generator=gen).to(device=device, dtype=dtype)
    with torch.inference_mode():
        step = timed(lambda: stack(x))
    flops = 2.0 * images * size * size * 9 * (cin * cout + (depth - 1) * cout * cout)
    return {"step_time_s": step, "tflops_per_s": flops / step / 1e12, "flops": flops}


def cudnn_flags() -> dict:
    return {"deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


@torch.inference_mode()
def stages(model: HRNet, lrs: torch.Tensor, alphas: torch.Tensor, timed) -> dict:
    b = lrs.shape[0]
    x = prep(model, lrs)
    states = encode(model, x, b)
    fused = fuse(model, states, alphas)
    out = {"full_forward_s": timed(lambda: model(lrs, alphas)),
           "prep_median_stack_s": timed(lambda: prep(model, lrs)),
           "encoder_s": timed(lambda: encode(model, x, b)),
           "fusion_s": timed(lambda: fuse(model, states, alphas)),
           "decoder_s": timed(lambda: decode(model, fused))}
    out["stage_sum_s"] = sum(out[k] for k in ("prep_median_stack_s", "encoder_s", "fusion_s",
                                              "decoder_s"))
    return out


def parse_args(argv):
    p = parser("bench_breakdown", __doc__)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = setup_device(args.device)
    b, l, s, c = args.batch, args.views, args.size, args.channels
    rng = np.random.default_rng(0)
    lrs = torch.from_numpy(rng.random((b, l, s, s)).astype(np.float32)).to(device)
    alphas = torch.ones((b, l), device=device)
    report = {"device": device_line(device), "batch": b, "views": l, "size": s, "channels": c,
              "iters": args.iters, "warmup": args.warmup, "cudnn": cudnn_flags(), "stages": {}}
    timed = lambda fn: median_s(fn, device, args.iters, args.warmup)  # noqa: E731
    before = dict(fusion.LAUNCHES)
    for name, dtype in DTYPES.items():
        model = seeded_hrnet(c, device, dtype)
        row = report["stages"][name] = stages(model, lrs, alphas, timed)
        del model
        free(device)
        row["conv64_stack"] = conv_stack(b * l, s, c, c, 6, device, dtype, timed)
        free(device)
        row["conv128_stack"] = conv_stack(b * l // 2, s, 2 * c, 2 * c, 3, device, dtype, timed)
        free(device)
    report["launches"] = launches_since(before)
    write_report(report, args.out)
    return report


if __name__ == "__main__":
    print(json.dumps(main(), indent=2))
