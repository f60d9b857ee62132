"""Profiling and numerical-debugging hooks.

The counterpart of ``highresnet_tpu/utils/profiling.py``:

- ``trace(log_dir)``: a ``torch.profiler`` window (host and, on a card, CUDA
  activity) that writes a Chrome trace under ``log_dir`` on exit;
- ``sync(tree)``: wait for the devices of the tensors in a nested structure;
- ``timed(fn)``: mean seconds per call, from CUDA events when ``fn`` returns
  CUDA tensors and from the host clock otherwise;
- ``enable_nan_debugging``: ``torch.autograd.set_detect_anomaly``, the
  reference's ``detect_anomaly``, behind ``training.debug_nans``.

The JAX package's relay timing protocol (``enqueue_timed``) has no use on
a card that synchronises truthfully and is not ported.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List

import torch


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _cuda_devices(tree) -> List[torch.device]:
    return sorted({t.device for t in _tensors(tree) if t.is_cuda}, key=lambda d: d.index)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block: ``with trace("runs/t") as path: run_steps()``.

    Records CUDA activity when a card is present and writes
    ``<log_dir>/trace.json`` (chrome://tracing, Perfetto) when the block
    ends; yields that path."""
    from torch.profiler import ProfilerActivity, profile

    with_cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if with_cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
        if with_cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def sync(tree) -> None:
    """Wait until every CUDA device holding a tensor of ``tree`` is idle (CPU
    tensors are ready when returned)."""
    for device in _cuda_devices(tree):
        torch.cuda.synchronize(device)


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2, **kwargs):
    """(mean seconds per call, last result) over ``iters`` calls after
    ``warmup``. When the result holds CUDA tensors the time is from CUDA
    events around the calls on the current stream of the result's first
    device; otherwise from the host clock."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
    devices = _cuda_devices(result)
    if devices:
        with torch.cuda.device(devices[0]):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                result = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / iters, result
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args, **kwargs)
    sync(result)
    return (time.perf_counter() - t0) / iters, result


def enable_nan_debugging(enable: bool = True) -> None:
    """Anomaly detection for every backward: a NaN gradient raises and
    names the forward operation that made it (costly; debugging only)."""
    torch.autograd.set_detect_anomaly(enable)
