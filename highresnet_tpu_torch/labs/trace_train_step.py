"""Trace the bench's registered train step with torch.profiler and account
for its device time by kernel.

The counterpart of ``examples/trace_train_step.py``, with its summary keys.
The step is the bench's own (``bench.Bench.train_step`` on the registered
train row of ``--dtype``: HRNet and ShiftNet, the plain Lanczos warp, the
loss, one Adam step at batch 32, 32 views, 64 px patches), so the trace and
the bench row time the same program. It takes two steps, then
``--steps`` steps under ``torch.profiler`` (CPU and, on the card, CUDA
activity; each step inside a ``record_function`` span), then ``--steps``
more through the bench's own window timer (``window_ms_per_step``). The
Chrome trace goes to ``--trace-dir`` (default ``build/traces/<dtype>_train/
trace.json.gz``) and the summary to ``--out`` (default
``build/labs/trace_train_step_<dtype>_torch.json``):

  device_ms_per_step               the kernels', copies' and memsets' time a step
  idle_share                       1 - the device's busy time over the traced
                                   window (the first step span's start to the
                                   last device event's end)
  category_accounting_ms_per_step  the device time a step by kernel-name
                                   category (``RULES``, first match wins;
                                   ``other`` for the rest, its share printed
                                   as ``other_share``); the categories sum
                                   to ``device_ms_per_step``
  top_ops                          the 25 costliest device operations
  ceiling_accounting               ``utils/flops.py::train_step_flops`` over
                                   the conv and GEMM time, against the
                                   dtype's H100 peak (67 TFLOP/s f32, 989
                                   bf16) and against the conv stacks'
                                   measured rate in ``bench_breakdown``'s
                                   report, when ``--breakdown`` names one

On random data ShiftNet leaves the warp's ±3 px window after a few steps
and the loss may stop being finite: the summary says whether it is
(``loss_finite``) and holds nothing to it. On the CPU the profiler sees no
device, so the device entries are null. ``--resummarize`` re-parses the
trace in ``--trace-dir`` and rewrites the summary without running a step
(no card needed).

    python -m highresnet_tpu_torch.labs.trace_train_step [--device cuda|cpu]
        [--dtype bfloat16|float32] [--steps 5] [--out PATH]
        [--trace-dir DIR] [--breakdown PATH] [--resummarize]
        [--batch 32 --views 32 --patch 64 --channels 64 --register-size 128]
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gzip
import json
import math
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List

from highresnet_tpu_torch import bench
from highresnet_tpu_torch.config import DEFAULT_CONFIG
from highresnet_tpu_torch.labs.common import DEFAULT_DIR, REPO, device_line, launches_since, network
from highresnet_tpu_torch.ops import fusion
from highresnet_tpu_torch.runtime import setup_device
from highresnet_tpu_torch.train.step import REGISTER_SIZE
from highresnet_tpu_torch.utils.flops import H100_PEAK_TFLOPS, train_step_flops

STEP_MARK = "hrn_lab_train_step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # Kineto's device-side event categories
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
    (PORT, ("hrn_", "pack_pairs_kernel", "pack_pairs_dma_kernel", "lanczos_shift_kernel",
            "attend_kernel")),
    ("optimizer (multi_tensor_apply)", ("multi_tensor_apply",)),
    ("copies and memsets", ("memcpy", "memset", "copy", "fillfunctor", "flip", "nchwtonhwc",
                            "nhwctonchw", "transpose")),
    ("reductions", ("bn_fw", "bn_bw", "batch_norm")),
    (CONV, ("conv", "gemm", "cudnn", "cutlass", "xmma", "fft", "winograd", "cublas", "nvjet",
            "wgrad", "dgrad", "fprop", "implicit", "im2col", "col2im", "mult_and_sum_complex")),
    ("reductions", ("reduce", "norm", "welford", "softmax", "scan")),
    ("elementwise", ("elementwise", "pointwise")),
)
CATEGORIES = (*dict.fromkeys(category for category, _ in RULES), OTHER)
TOP_OPS = 25
WARMUP_STEPS = 2  # steps before the trace: cuDNN's plans, the allocator's first blocks
SHORT = {"bfloat16": "bf16", "float32": "f32"}


def categorize(name: str) -> str:
    low = name.lower()
    for category, keys in RULES:
        if any(k in low for k in keys):
            return category
    return OTHER


def load_events(path: str | Path) -> List[dict]:
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def summarize_chrome_trace(path: str | Path, steps: int) -> Dict[str, Any]:
    """Device time a step, idle share, categories and top ops of a Chrome
    trace written by torch.profiler. Device events are complete events
    (``ph`` X) of Kineto's device categories; durations are microseconds."""
    events = load_events(path)
    device = [e for e in events if e.get("ph") == "X" and e.get("cat", "").lower() in DEVICE_CATS]
    if not device:
        return {"device_ms_per_step": None, "idle_share": None,
                "category_accounting_ms_per_step": None, "other_share": None, "top_ops": []}
    per_op = defaultdict(lambda: [0.0, 0])
    for e in device:
        per_op[e["name"]][0] += float(e["dur"])
        per_op[e["name"]][1] += 1
    total_us = sum(us for us, _ in per_op.values())
    cats = dict.fromkeys(CATEGORIES, 0.0)
    for name, (us, _) in per_op.items():
        cats[categorize(name)] += us
    rows = sorted(per_op.items(), key=lambda kv: -kv[1][0])
    top = [{"op": name, "category": categorize(name), "us_per_step": us / steps,
            "count_per_step": count / steps, "pct": 100.0 * us / total_us}
           for name, (us, count) in rows[:TOP_OPS]]

    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device)
    busy, end = 0.0, -math.inf
    for t0, t1 in spans:  # the union of the device intervals
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    marks = [float(e["ts"]) for e in events if e.get("ph") == "X" and e.get("name") == STEP_MARK]
    window = end - min([spans[0][0], *marks])
    return {
        "device_ms_per_step": total_us / steps / 1e3,
        "idle_share": 1.0 - busy / window,
        "category_accounting_ms_per_step": {
            k: v / steps / 1e3 for k, v in sorted(cats.items(), key=lambda kv: -kv[1])},
        "other_share": cats[OTHER] / total_us,
        "top_ops": top,
    }


def stack_ceiling(breakdown: str | None, dtype: str) -> float | None:
    """The faster conv stack's TFLOP/s in ``bench_breakdown``'s report for
    ``dtype``, or None without one."""
    if not breakdown or not Path(breakdown).is_file():
        return None
    row = json.loads(Path(breakdown).read_text()).get("stages", {}).get(dtype)
    if not row:
        return None
    return max(row[k]["tflops_per_s"] for k in ("conv64_stack", "conv128_stack"))


def ceiling_accounting(summary: Dict[str, Any], flops: float, dtype: str,
                       ceiling: float | None) -> Dict[str, Any] | None:
    cats = summary["category_accounting_ms_per_step"]
    if not cats or not cats[CONV]:
        return None
    conv_ms = cats[CONV]
    rate = flops / (conv_ms * 1e-3) / 1e12
    peak = H100_PEAK_TFLOPS[dtype]
    out = {"train_step_tflop": flops / 1e12, "conv_ms_per_step": conv_ms,
           "conv_tflops_per_s": rate, "peak_tflops_per_s": peak, "share_of_peak": rate / peak,
           "stack_ceiling_tflops_per_s": ceiling,
           "share_of_stack_ceiling": rate / ceiling if ceiling else None,
           "non_conv_ms_per_step": summary["device_ms_per_step"] - conv_ms}
    out["text"] = (
        f"{out['non_conv_ms_per_step']:.3f} of {summary['device_ms_per_step']:.3f} ms a step "
        f"is outside the convs and GEMMs; {flops / 1e12:.3f} TFLOP (direct-conv count) over "
        f"{conv_ms:.3f} ms of conv and GEMM kernels is {rate:.2f} TFLOP/s, "
        f"{rate / peak:.1%} of the H100's {peak:g} TFLOP/s {dtype} peak"
        + (f" and {rate / ceiling:.1%} of the {ceiling:.2f} TFLOP/s the bare conv stacks "
           f"reach" if ceiling else "; no bench_breakdown report to compare with"))
    return out


def write_summary(summary: Dict[str, Any], out: str | Path) -> None:
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=2) + "\n")
    shown = {k: v for k, v in summary.items() if k != "top_ops"}
    print(json.dumps(shown, indent=2))
    if summary["other_share"] is not None:
        print(f"'other' (no category matched): {summary['other_share']:.2%} of the device time")
    for row in summary["top_ops"][:8]:
        print(f"  {row['op'][:90]:<90} {row['us_per_step']:>11.1f} us/step {row['pct']:>6.2f}% "
              f"{row['category']}")


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m highresnet_tpu_torch.labs.trace_train_step",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(SHORT))
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--out", default=None)
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--breakdown", default=str(DEFAULT_DIR / "bench_breakdown_torch.json"))
    p.add_argument("--resummarize", action="store_true",
                   help="re-parse the trace in --trace-dir, run no step")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--views", type=int, default=None)
    p.add_argument("--patch", type=int, default=None)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--register-size", type=int, default=REGISTER_SIZE)
    args = p.parse_args(argv)
    short = SHORT[args.dtype]
    args.out = args.out or str(DEFAULT_DIR / f"trace_train_step_{short}_torch.json")
    args.trace_dir = args.trace_dir or str(REPO / "build" / "traces" / f"{short}_train")
    return args


def train_row(args) -> bench.Row:
    """The bench's registered train row of ``args.dtype``, resized by the flags."""
    row = next(r for r in bench.ROWS if r.kind == "train_step" and r.dtype == args.dtype)
    return dataclasses.replace(row, batch=args.batch or row.batch, views=args.views or row.views,
                               size=args.patch or row.size)


def resummarize(args) -> Dict[str, Any]:
    """Rewrite the summary from the trace in ``--trace-dir``; the shape and
    step count come from the summary already there, else from the flags."""
    out = Path(args.out)
    summary = json.loads(out.read_text()) if out.is_file() else {}
    row = train_row(args)
    shape = {"dtype": args.dtype, "batch": row.batch, "views": row.views, "patch": row.size,
             "register_size": args.register_size, "channels": args.channels,
             "steps": args.steps}
    shape.update({k: summary[k] for k in shape if k in summary})
    summary.update(shape)
    summary.update(summarize_chrome_trace(Path(args.trace_dir) / "trace.json.gz", shape["steps"]))
    flops = train_step_flops(network(shape["channels"]), shape["batch"], shape["views"],
                             shape["patch"], shape["register_size"])
    summary["ceiling_accounting"] = ceiling_accounting(
        summary, flops, shape["dtype"], stack_ceiling(args.breakdown, shape["dtype"]))
    summary["resummarized"] = True
    write_summary(summary, out)
    return summary


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)
    if args.resummarize:
        return resummarize(args)
    from torch.profiler import ProfilerActivity, profile, record_function

    device = setup_device(args.device)
    row = train_row(args)
    config = copy.deepcopy(DEFAULT_CONFIG)
    config["network"] = network(args.channels)
    config["training"]["register_size"] = args.register_size
    runner = bench.Bench(device, config=config)
    before = dict(fusion.LAUNCHES)
    step = runner.train_step(row)
    for _ in range(WARMUP_STEPS):
        step()
    bench.synchronize(device)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        for _ in range(args.steps):
            with record_function(STEP_MARK):
                step()
        bench.synchronize(device)
    trace_dir = Path(args.trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    raw = trace_dir / "trace.json"
    prof.export_chrome_trace(str(raw))
    trace = trace_dir / "trace.json.gz"
    with open(raw, "rb") as src, gzip.open(trace, "wb") as dst:
        dst.writelines(src)
    raw.unlink()

    window_s = bench.window_seconds(step, args.steps, 1)
    loss = float(step.metrics["loss"])
    flops = train_step_flops(config["network"], row.batch, row.views, row.size,
                             args.register_size)
    summary = {
        "device": device_line(device),
        "program": (f"{args.dtype} registered train step (HRNet + ShiftNet forward, the plain "
                    f"Lanczos warp, the loss, backward, Adam): the bench's '{row.name}' row "
                    f"at batch {row.batch}, {row.views} views, {row.size} px patches, "
                    f"register {args.register_size}, width {args.channels}; {args.steps} "
                    f"steps traced after {WARMUP_STEPS}"),
        "note": (f"torch.profiler (CPU{' + CUDA' if device.type == 'cuda' else ''} activity); "
                 "device times are the Chrome trace's kernel, memcpy and memset events. "
                 f"Raw trace: {trace}"),
        "dtype": args.dtype, "batch": row.batch, "views": row.views, "patch": row.size,
        "register_size": args.register_size, "channels": args.channels,
        "steps": args.steps, "warmup": WARMUP_STEPS,
        **summarize_chrome_trace(trace, args.steps),
        "window_ms_per_step": window_s * 1e3,
        "steps_run": step.state.step,
        "last_loss": loss,
        "loss_finite": math.isfinite(loss),
        "launches": launches_since(before),
    }
    summary["ceiling_accounting"] = ceiling_accounting(summary, flops, args.dtype,
                                                       stack_ceiling(args.breakdown, args.dtype))
    write_summary(summary, args.out)
    return summary


if __name__ == "__main__":
    main()
