"""What the perf labs share: the timer, the command line's common flags, the
seeded model and the report file.

Each time is the median over ``--iters`` calls after ``--warmup`` calls:
CUDA events around one call on the card, the host clock on the CPU. A
report names the device it ran on (the card's ``nvidia-smi`` name and power
limit, or ``"cpu"``) and goes to ``--out`` alone, by default
``build/labs/<lab>_torch.json``; never to the JAX labs' records at the
repo's root.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import statistics
import time
from pathlib import Path
from typing import Any, Callable, Dict

import torch

from highresnet_tpu_torch.config import DEFAULT_CONFIG
from highresnet_tpu_torch.models.hrnet import HRNet
from highresnet_tpu_torch.ops import fusion
from highresnet_tpu_torch.runtime import card_line

REPO = Path(__file__).resolve().parents[2]
DEFAULT_DIR = REPO / "build" / "labs"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def median_s(fn: Callable[[], object], device: torch.device, iters: int, warmup: int) -> float:
    """Median seconds of one ``fn()`` call over ``iters`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def parser(lab: str, doc: str) -> argparse.ArgumentParser:
    """The flags the forward labs share: ``--device``, ``--out``, the timing
    window and the shape (the JAX labs' batch 8, 16 views, 128 px, C 64)."""
    p = argparse.ArgumentParser(prog=f"python -m highresnet_tpu_torch.labs.{lab}",
                                description=doc.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    p.add_argument("--out", default=str(DEFAULT_DIR / f"{lab}_torch.json"))
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--views", type=int, default=16)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--channels", type=int, default=64)
    return p


def network(channels: int = 64) -> Dict[str, Any]:
    """DEFAULT_CONFIG's network with its feature width set to ``channels``
    (64, the default, leaves it as it is)."""
    net = copy.deepcopy(DEFAULT_CONFIG["network"])
    net["encoder"]["channel_size"] = channels
    net["recursive"]["in_channels"] = channels
    net["decoder"]["deconv"].update(in_channels=channels, out_channels=channels)
    net["decoder"]["final"]["in_channels"] = channels
    return net


def seeded_hrnet(channels: int, device: torch.device, dtype: torch.dtype) -> HRNet:
    """HRNet at ``channels`` on the port's seed-0 init (the bench's weights at 64)."""
    return HRNet(network(channels), device=device, dtype=dtype,
                 generator=torch.Generator().manual_seed(0)).eval()


def device_line(device: torch.device) -> str:
    return card_line() if device.type == "cuda" else "cpu"


def free(device: torch.device) -> None:
    """Give a variant's blocks (and cuDNN's workspace) back before the next."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """K1 and K2 launches since ``before`` (a copy of ``fusion.LAUNCHES``)."""
    return {k: fusion.LAUNCHES[k] - before[k] for k in before}


def write_report(report: Dict[str, Any], out: str | Path) -> None:
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
