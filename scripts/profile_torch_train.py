"""Where the port's registered train step spends its time on one NVIDIA GPU.

    python3 scripts/profile_torch_train.py [--out build/profile]

At the full width of configs/config.json (HRNet 591,818 params, ShiftNet
34,187,648 at register 128), batch 8, 8 views, 64 px patches (SR 192 px),
the fused warp on, seeded random weights and a seeded random batch:
1. The step's stages timed with CUDA events (median of 10 after a warm-up):
   HRNet forward, ShiftNet forward, the warp (K3), the loss, the backward,
   and the gradient norm plus the Adam step; then the whole step as
   ``build_train_step`` runs it.
2. One torch.profiler pass over a step: device time by kernel, the device's
   busy share of the step's wall time, and a Chrome trace written to --out.
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
BATCH, VIEWS, PATCH = 8, 8, 64


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="build/profile", help="directory for the trace")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: needs a CUDA device")

    from highresnet_tpu_torch import load_config
    from highresnet_tpu_torch.ops.lanczos_fused import lanczos_shift_fused
    from highresnet_tpu_torch.ops.losses import crop_mask, registered_loss
    from highresnet_tpu_torch.runtime import card_line, setup_device
    from highresnet_tpu_torch.train.state import create_train_state, global_norm
    from highresnet_tpu_torch.train.step import build_train_step

    card = card_line()
    setup_device("cuda")
    cfg = load_config(str(REPO / "configs" / "config.json"))
    t = cfg["training"]
    t.update(min_L=VIEWS, n_views=VIEWS, batch_size=BATCH, patch_size=PATCH, use_pallas_warp=True)
    rs = t.get("register_size", 128)
    off = (3 * PATCH - rs) // 2
    state = create_train_state(cfg, "cuda", torch.Generator().manual_seed(0))
    step = build_train_step(cfg)
    rng = np.random.default_rng(0)
    lrs = torch.from_numpy(rng.random((BATCH, VIEWS, PATCH, PATCH), dtype=np.float32)).cuda()
    alphas = torch.ones((BATCH, VIEWS), device="cuda")
    hrs = torch.from_numpy(rng.random((BATCH, 3 * PATCH, 3 * PATCH), dtype=np.float32)).cuda()
    masks = torch.from_numpy(crop_mask(PATCH, t["crop"])).cuda()[None].expand_as(hrs)
    for _ in range(3):
        step(state, lrs, alphas, hrs, masks)  # warm-up (and thetas leave zero)

    events = {k: [] for k in ("hrnet_forward", "shiftnet_forward", "warp_k3", "loss", "backward",
                              "grad_norm_and_adam")}
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for _ in range(ITERS):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(events) + 1)]
        marks[0].record()
        srs = state.hrnet(lrs, alphas)
        marks[1].record()
        crop = slice(off, off + rs)
        thetas = state.shiftnet(torch.stack([hrs[:, crop, crop], srs[:, crop, crop]], dim=1),
                                state.generator)
        marks[2].record()
        warped = lanczos_shift_fused(srs, torch.flip(thetas, dims=(-1,)))
        marks[3].record()
        loss = registered_loss(warped, hrs, masks, thetas, t["lambda"])
        marks[4].record()
        state.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        marks[5].record()
        global_norm([p.grad for p in params])
        state.optimizer.step()
        marks[6].record()
        marks[6].synchronize()
        for (name, ts), a, b in zip(events.items(), marks, marks[1:]):
            ts.append(a.elapsed_time(b))
    total = 0.0
    for name, ts in events.items():
        ms = statistics.median(ts)
        total += ms
        print(f"[stage] {name}: {ms:.3f} ms; {card}")
    print(f"[stage] sum of stages: {total:.3f} ms (batch {BATCH} x {VIEWS} views x {PATCH} px, "
          f"f32, register {rs})")

    step_ms = []
    for _ in range(ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, lrs, alphas, hrs, masks)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(step_ms)
    print(f"[step] build_train_step: {ms:.3f} ms/step, {BATCH / ms * 1e3:.1f} scenes/s "
          f"(median of {ITERS}, host clock with sync); {card}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, lrs, alphas, hrs, masks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # kernels, memcpys and memsets are the CUDA-side entries; CPU-side ops
    # carry the same time again as their children's, so count only these
    busy_ms = sum(e.self_device_time_total for e in averages
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(averages.table(sort_by="self_device_time_total", row_limit=20))
    print(f"[profile] step wall {wall_ms:.3f} ms (profiler on), device busy {busy_ms:.3f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}; {card}")
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, "torch_train_trace.json")
    prof.export_chrome_trace(trace)
    print(f"[profile] trace written to {trace}")


if __name__ == "__main__":
    main()
