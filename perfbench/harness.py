"""One run of one cell: set-up, the measured window, the traced calls, the
check, and the result line.

The window calls the session of the traffic kind's module
(``drivers/<kind>.py``) back to back (a closed loop with one client)
until ``seconds`` have passed on the host clock, every call ending with
its result on the host. With ``trace`` a few more calls run under
torch.profiler after the window, and the per-layer readers take their
numbers from the window, the trace and the session's context.
Afterwards the program's state is freed and the session's check holds
what the window produced to the plain reference.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

from perfbench import cells, trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "highresnet_tpu")


def window(session, seconds: float) -> Tuple[int, float, list]:
    latencies = []
    items = 0
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        items += session.call()
        b = time.perf_counter()
        latencies.append(b - a)
        if b - t0 >= seconds:
            return items, b - t0, latencies


def traced(session, device: torch.device, out: Path) -> Tuple[int, Dict[str, Any] | None]:
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        with record_function(tracing.MARK):
            items = session.trace()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    return items, tracing.summarize(tracing.load_events(out))


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run(name: str, seed: int, seconds: float, trace: bool, device: torch.device, start: float,
        root: Path = cells.ROOT, control: bool = False, trace_path: Path | None = None
        ) -> Dict[str, Any]:
    """The result object of one run; ``start`` is the process's start on
    ``time.perf_counter``'s clock. The numbers compared come last."""
    cell = cells.load_cell(name, root)
    drv = cells.driver(cell, root)
    imports_s = time.perf_counter() - start
    if device.type == "cuda":
        torch.cuda.init()  # the peak's counter needs a live context
        torch.cuda.reset_peak_memory_stats(device)
    session = drv.Session(cell, device, seed, control=control)
    setup_s = time.perf_counter() - start
    items, window_s, latencies = window(session, seconds)
    metrics: Dict[str, Dict[str, Any]] = {}
    dev: Dict[str, Any] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips,
    }
    breakdown = None
    diagnostics = {"seconds": window_s, "calls": len(latencies),
                   "median_call_s": statistics.median(latencies), "imports_s": imports_s,
                   "session_s": setup_s - imports_s}
    if trace:
        trace_path = trace_path or root.parent / "build" / "perfbench" / f"{name}.trace.json"
        traced_items, summary = traced(session, device, trace_path)
        ctx = {"items": items, "window_s": window_s,
               "latencies_s": latencies, "trace": summary, "traced_items": traced_items,
               **session.context(), **session.after_trace()}
        for m in cells.per_layer(name, cells.e2e(cell, drv), root):
            value = cells.reader(m["name"], root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary is not None:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
            breakdown = summary["breakdown"]
            # the profiler slows the host: the traced calls' device time over
            # the untraced window's seconds a call gives the idle share without it
            busy_per_item = summary["busy_s"] / traced_items
            diagnostics["traced_s_per_item"] = summary["window_s"] / traced_items
            diagnostics["untraced_s_per_item"] = window_s / items
            diagnostics["untraced_idle_share"] = 100.0 * (1.0 - busy_per_item * items / window_s)
    else:
        for metric, value in session.e2e(items, window_s, latencies).items():
            metrics[cell.report_as.get(metric, metric)] = {"value": value,
                                                            "unit": drv.E2E[metric]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    session.release()
    numbers = session.check()
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())  # NaN fails
    result: Dict[str, Any] = {"correct": correct, "attempted": items, "failed": 0,
                              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["window"] = diagnostics
    result["checks"] = checks
    return result
