"""Device time from a torch.profiler Chrome trace.

The categories, their rules and the interval arithmetic are copied from
``highresnet_tpu_torch/labs/trace_train_step.py`` (``RULES``,
``categorize``, the union of device intervals in
``summarize_chrome_trace``), so that the benchmark keeps its own copy of
the yardstick. ``summarize`` adds what the benchmark reads besides: the
device time by kernel name, the busy time and the traced window, and the
idle gaps between device work labelled by the host operation that was
running in each.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Tuple

MARK = "perfbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # Kineto's device-side event categories
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")
PORT = "port kernels (csrc/*.cu)"
CONV = "conv and GEMM (cuDNN, cuBLAS, FFT)"
OTHER = "other"
# (category, kernel-name substrings in lower case), tried in this order: the
# port's kernels by their launchers' hrn_ prefix and their __global__ names
# (unpack_pairs_kernel holds pack_pairs_kernel); cuDNN's batch norm before the
# conv keys, as its kernels are cuDNN's too; the FFT convolution's complex
# product before the elementwise keys; the generic reduction keys after the
# conv keys, as cuDNN's FFT kernels take a cudnn::reduced_divisor
RULES = (
    (PORT, ("hrn_", "pack_pairs_kernel", "pack_pairs_dma_kernel", "lanczos_shift_kernel")),
    ("optimizer (multi_tensor_apply)", ("multi_tensor_apply",)),
    ("copies and memsets", ("memcpy", "memset", "copy", "fillfunctor", "flip", "nchwtonhwc",
                            "nhwctonchw", "transpose")),
    ("reductions", ("bn_fw", "bn_bw", "batch_norm")),
    (CONV, ("conv", "gemm", "cudnn", "cutlass", "xmma", "fft", "winograd", "cublas", "nvjet",
            "wgrad", "dgrad", "fprop", "implicit", "im2col", "col2im", "mult_and_sum_complex")),
    ("reductions", ("reduce", "norm", "welford", "softmax", "scan")),
    ("elementwise", ("elementwise", "pointwise")),
)
TOP = 10


def categorize(name: str) -> str:
    low = name.lower()
    for category, keys in RULES:
        if any(k in low for k in keys):
            return category
    return OTHER


def load_events(path: str | Path) -> List[dict]:
    data = json.loads(Path(path).read_text())
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for t0, t1 in sorted(spans):
        if merged and t0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
        else:
            merged.append((t0, t1))
    return merged


def _label_gaps(host: List[Tuple[float, float, str]],
                gaps: List[Tuple[float, float]]) -> Dict[str, float]:
    """Seconds of idle device time by the innermost host event that covers
    the middle of each gap (latest start among the events still open)."""
    host = sorted(host)
    out: Dict[str, float] = defaultdict(float)
    active: List[Tuple[float, float, str]] = []
    i = 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) / 2
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [e for e in active if e[1] >= mid]
        name = max(active)[2] if active else "(no host event)"
        out[name] += (g1 - g0) * 1e-6
    return out


def summarize(events: List[dict]) -> Dict[str, Any] | None:
    """Device seconds by kernel name and by category, busy and window
    seconds, and idle gaps by host operation; None without device events.
    The window runs from the start of the ``MARK`` span (or the first
    device event) to the end of the last device event."""
    device = [e for e in events if e.get("ph") == "X" and e.get("cat", "").lower() in DEVICE_CATS]
    if not device:
        return None
    by_name: Dict[str, float] = defaultdict(float)
    for e in device:
        by_name[e["name"]] += float(e["dur"]) * 1e-6
    by_cat: Dict[str, float] = defaultdict(float)
    for name, s in by_name.items():
        by_cat[categorize(name)] += s
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device])
    marks = [float(e["ts"]) for e in events if e.get("ph") == "X" and e.get("name") == MARK]
    start = min([busy[0][0], *marks])
    end = busy[-1][1]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat", "").lower() in HOST_CATS
            and e.get("name") != MARK]
    edges = [start] + [t for span in busy for t in span] + [end]
    gaps = _label_gaps(host, [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0])
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "by_name": dict(by_name),
        "by_category": dict(by_cat),
        "busy_s": sum(t1 - t0 for t0, t1 in busy) * 1e-6,
        "window_s": (end - start) * 1e-6,
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)},
    }
