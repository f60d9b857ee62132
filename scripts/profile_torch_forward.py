"""Where the port's HRNet forward spends its time on one NVIDIA GPU.

    python3 scripts/profile_torch_forward.py [--out build/profile]

At chip_smoke's headline shape (batch 8, 16 views, 128 px, f32), with the
full-width network of configs/config.json and seeded random weights:
1. Each stage timed alone with CUDA events (median of 10 after a warm-up):
   encoder, fusion (all rounds, pack kernel included), decoder, and the
   49-placement shift-cPSNR of the batch. chip_smoke.py times the whole
   forward.
2. One torch.profiler pass over a forward: device time by kernel, the
   device's busy share of the forward's wall time, and a Chrome trace
   written to --out.
Needs CUDA; prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

ITERS = 10


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="build/profile", help="directory for the trace")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_torch_forward: needs a CUDA device")

    from chip_smoke import HEADLINE, cuda_times_ms
    from highresnet_tpu_torch import load_config
    from highresnet_tpu_torch.models.hrnet import HRNet, lower_median
    from highresnet_tpu_torch.ops.metrics import shift_cpsnr_batch
    from highresnet_tpu_torch.runtime import card_line, setup_device

    card = card_line()
    setup_device("cuda")
    b, l, s = HEADLINE["batch"], HEADLINE["views"], HEADLINE["size"]
    net = load_config(str(REPO / "configs" / "config.json"))["network"]
    model = HRNet(net, device="cuda", generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    lrs = torch.from_numpy(rng.random((b, l, s, s), dtype=np.float32)).cuda()
    alphas = torch.ones((b, l), device="cuda")
    hr = torch.from_numpy(rng.random((b, 3 * s, 3 * s), dtype=np.float32)).cuda()
    mask = torch.ones_like(hr)

    with torch.inference_mode():
        x = torch.stack([lrs, lower_median(lrs[:, :9], dim=1)[:, None].expand_as(lrs)], dim=2)
        x = x.reshape(b * l, 2, s, s)
        states = model.encode(x)
        fused = model.fuse(states.reshape(b, l, *states.shape[1:]), alphas)
        sr = model.decode(fused)[:, 0].clamp(0, 1)
        stages = {
            "encoder": lambda: model.encode(x),
            "fusion": lambda: model.fuse(states.reshape(b, l, *states.shape[1:]), alphas),
            "decoder": lambda: model.decode(fused),
            "shift_cpsnr_batch": lambda: shift_cpsnr_batch(sr, hr, mask),
        }
        for name, fn in stages.items():
            ms = statistics.median(cuda_times_ms(fn, ITERS, 1))
            print(f"[stage] {name}: {ms:.3f} ms (batch {b} x {l} views x {s}px, f32); {card}")

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(lrs, alphas)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernels, memcpys and memsets are the CUDA-side entries; CPU-side ops
    # carry the same time again as their children's, so count only these
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(f"[profile] forward wall {wall_ms:.3f} ms (profiler on), device busy "
          f"{busy_ms:.3f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}; {card}")
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, "torch_forward_trace.json")
    prof.export_chrome_trace(trace)
    print(f"[profile] trace written to {trace}")


if __name__ == "__main__":
    main()
