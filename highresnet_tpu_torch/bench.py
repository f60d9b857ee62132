"""The port's bench: scenes/s of the 16-view 3x SR forward on one card, and
the JAX bench's other rows.

    python -m highresnet_tpu_torch.bench [--smoke] [--device cuda|cpu] [--out PATH]

The counterpart of the root ``bench.py``, row for row (``ROWS``):

  headline         HRNet forward, batch 8, 16 views, 128 px, f32
  bf16 headline    the same in bf16 (body and decoder; parameters f32)
  train step f32   the registered train step (HRNet, ShiftNet, the plain
                   Lanczos warp, the loss, one Adam step) on DEFAULT_CONFIG
                   at batch 32, 32 views, 64 px patches (SR 192 px)
  train step bf16  the same under ``training.compute_dtype: "bfloat16"``
  eval step        forward + the 49-placement shift-cPSNR at HR 384 px
  32-view f32      forward, batch 4, 32 views, 128 px
  batch-32 bf16    forward, batch 32, 16 views, 128 px, bf16
  batch-1 latency  forward, batch 1, 32 views, 128 px, f32

Every forward row runs one HRNet per dtype, drawn from the port's seeded
init (generator seed 0), so all of them use the same weights; inputs come
from ``np.random.default_rng(0)`` as in the JAX bench. A row's time is the
median over ``repeats`` windows of back-to-back calls (after one warm-up
call each), timed by CUDA events on the card and by the host clock on the
CPU (``utils/profiling.py::timed``); the train rows' state advances at
every step. A row whose TFLOP/s exceeds the H100 basis of its dtype
(``utils/flops.py::utilization``) is timed once more over a doubled window
and published with ``timing_suspect`` if it stays impossible.

Standard output carries one JSON line, printed as soon as the headline is
measured: ``metric``, ``value`` (scenes/s), ``unit`` and ``vs_baseline``
(value / 10 scenes/s, the reference paper's V100 figure: under 0.2 s a
scene at 32 views, so 10 scenes/s at 16). Progress goes to standard error.
The details (every row, the startup entry, the card line) are rewritten
after each row to ``--out``, by default ``build/bench/BENCH_DETAILS.json``
in the repo; never to the root ``BENCH_DETAILS.json``, the JAX bench's
record. A row that raises (out of memory, say) is written with its error,
the remaining rows still run, and the exit code is 1.

``--smoke`` runs one forward at batch 1, 2 views, 16 px and prints its own
JSON line; ``--smoke --device cpu`` needs no card. ``--device cuda``
without a card raises, and on the card the kernels are built (or loaded)
before any row, so a kernel that does not build fails the run.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import statistics
import sys
import time
import traceback
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Callable, Dict

import numpy as np
import torch

from highresnet_tpu_torch.config import DEFAULT_CONFIG
from highresnet_tpu_torch.models.hrnet import HRNet
from highresnet_tpu_torch.ops import fusion
from highresnet_tpu_torch.runtime import card_line, setup_device
from highresnet_tpu_torch.utils.flops import (
    eval_step_flops,
    hrnet_forward_flops,
    train_step_flops,
    utilization,
)
from highresnet_tpu_torch.utils.profiling import timed

DEFAULT_OUT = Path(__file__).resolve().parents[1] / "build" / "bench" / "BENCH_DETAILS.json"
BASELINE_SCENES_PER_S = 10.0  # the reference paper's V100 figure at 16 views
HEADLINE_METRIC = "scenes/sec/chip (16-view 128px 3x SR inference)"
SMOKE_METRIC = "SMOKE scenes/sec (1x2x16px)"
PROJECTED_EPOCHS, PROJECTED_SCENES = 400, 1160  # the reference's training run
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class Row:
    """One bench row: ``size`` is the LR side of a forward or eval row and
    the patch of a train row; ``iters`` the calls in one timed window (the
    JAX bench's k2 - k1)."""

    name: str
    kind: str  # "forward" | "train_step" | "eval_step"
    batch: int
    views: int
    size: int
    dtype: str = "float32"
    iters: int = 20


ROWS = (
    Row("headline", "forward", 8, 16, 128),
    Row("bf16 headline", "forward", 8, 16, 128, "bfloat16"),
    Row("train step f32", "train_step", 32, 32, 64, iters=10),
    Row("train step bf16", "train_step", 32, 32, 64, "bfloat16", iters=10),
    Row("eval step", "eval_step", 8, 16, 128, iters=10),
    Row("32-view f32", "forward", 4, 32, 128),
    Row("batch-32 bf16", "forward", 32, 16, 128, "bfloat16", iters=10),
    Row("batch-1 latency", "forward", 1, 32, 128, iters=100),
)
SMOKE_ROW = Row("smoke", "forward", 1, 2, 16, iters=45)
REPEATS = 3
_T_PROC0 = time.perf_counter()  # process start (this module's import), for the startup entry


def log(msg: str) -> None:
    """Progress to standard error: standard output carries the JSON line."""
    print(msg, file=sys.stderr, flush=True)


def row_flops(row: Row, network: Dict[str, Any]) -> float:
    """The row's FLOPs by ``utils/flops.py``, as the JAX bench counts them."""
    if row.kind == "forward":
        return hrnet_forward_flops(network, row.batch, row.views, row.size)
    if row.kind == "train_step":
        return train_step_flops(network, row.batch, row.views, row.size)
    if row.kind == "eval_step":
        return eval_step_flops(network, row.batch, row.views, row.size)
    raise ValueError(f"unknown row kind {row.kind!r}")


def forward_inputs(row: Row, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(lrs, alphas) of a forward row, drawn as the JAX bench draws them."""
    rng = np.random.default_rng(0)
    lrs = rng.random((row.batch, row.views, row.size, row.size)).astype(np.float32)
    return (torch.from_numpy(lrs).to(device),
            torch.ones((row.batch, row.views), device=device))


def scored_inputs(row: Row, device, scale: int = 3) -> tuple[torch.Tensor, ...]:
    """(lrs, alphas, hrs, hr_maps) of a train or eval row, drawn in the JAX
    bench's order from one generator: the views, then the HR frames."""
    rng = np.random.default_rng(0)
    b, l, s = row.batch, row.views, row.size
    lrs = rng.random((b, l, s, s)).astype(np.float32)
    hrs = rng.random((b, scale * s, scale * s)).astype(np.float32)
    return (torch.from_numpy(lrs).to(device), torch.ones((b, l), device=device),
            torch.from_numpy(hrs).to(device),
            torch.ones((b, scale * s, scale * s), device=device))


def forward(model: HRNet, lrs: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """The timed call of a forward row: the model in eval mode, no autograd."""
    model.eval()
    with torch.inference_mode():
        return model(lrs, alphas)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_call(fn: Callable[[], object], device: torch.device) -> tuple[float, object]:
    """Wall seconds of the first call (eager mode compiles nothing, but the
    first call pays for cuDNN's plans and the allocator's first blocks)."""
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return time.perf_counter() - t0, out


def window_seconds(fn: Callable[[], object], iters: int, repeats: int) -> float:
    """Median over ``repeats`` windows of seconds per call, each window
    ``iters`` back-to-back calls after one warm-up call."""
    return statistics.median(timed(fn, iters=iters, warmup=1)[0] for _ in range(repeats))


def measure(row: Row, fn: Callable[[], object], flops: float, iters: int,
            repeats: int) -> Dict[str, Any]:
    """Time ``fn`` and rate it; an impossible rate is re-measured once over
    a doubled window and published with its flag if it stays impossible."""
    dt = window_seconds(fn, iters, repeats)
    util = utilization(flops, dt, row.dtype)
    if util.get("timing_suspect"):
        log(f"  timing_suspect at {row.name}: {util['achieved_tflops_per_s']} TFLOP/s over the "
            f"basis; re-measuring over {2 * iters} calls")
        dt = window_seconds(fn, 2 * iters, repeats)
        util = utilization(flops, dt, row.dtype)
        util["remeasured_wider_window"] = True
    return {
        "step_time_s": dt,
        "scenes_per_sec": row.batch / dt,
        "flops": flops,
        **util,
    }


class Bench:
    """The rows on one device, with the models they share."""

    def __init__(self, device: torch.device, config: Dict[str, Any] | None = None,
                 iters: int | None = None, repeats: int = REPEATS):
        self.device = device
        self.config = copy.deepcopy(config or DEFAULT_CONFIG)
        self.iters = iters
        self.repeats = repeats
        self.models: Dict[str, HRNet] = {}
        self.details: Dict[str, Any] = {}
        if device.type == "cuda":
            torch.cuda.init()  # reset_peak_memory_stats raises before CUDA is up

    def model(self, dtype: str) -> HRNet:
        """HRNet in ``dtype`` on the seed-0 weights, one per dtype."""
        if dtype not in self.models:
            t0 = time.perf_counter()
            self.models[dtype] = HRNet(self.config["network"], device=self.device,
                                       dtype=DTYPES[dtype],
                                       generator=torch.Generator().manual_seed(0)).eval()
            synchronize(self.device)
            self.details.setdefault("shared_init_s", {})[dtype] = round(
                time.perf_counter() - t0, 3)
        return self.models[dtype]

    def run(self, row: Row) -> Dict[str, Any]:
        """One row, with its peak memory and the K1/K2 launches it made."""
        on_card = self.device.type == "cuda"
        if on_card:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        before = dict(fusion.LAUNCHES)
        out = {"name": row.name, "kind": row.kind, "batch": row.batch, "views": row.views,
               ("patch" if row.kind == "train_step" else "lr_size"): row.size,
               "dtype": row.dtype}
        out.update(getattr(self, f"row_{row.kind}")(row))
        out["peak_memory_gb"] = (torch.cuda.max_memory_allocated(self.device) / 1e9
                                 if on_card else None)
        out["launches"] = {k: fusion.LAUNCHES[k] - before[k] for k in before}
        return out

    def iters_of(self, row: Row) -> int:
        return self.iters or row.iters

    def row_forward(self, row: Row) -> Dict[str, Any]:
        model = self.model(row.dtype)
        lrs, alphas = forward_inputs(row, self.device)
        fn = lambda: forward(model, lrs, alphas)  # noqa: E731
        first_s, _ = first_call(fn, self.device)
        flops = row_flops(row, self.config["network"])
        return {"first_call_s": first_s,
                **measure(row, fn, flops, self.iters_of(row), self.repeats)}

    def row_eval_step(self, row: Row) -> Dict[str, Any]:
        from highresnet_tpu_torch.train.step import build_eval_step

        model = self.model(row.dtype)
        params = dict(model.named_parameters())
        step = build_eval_step(model)
        args = scored_inputs(row, self.device)
        fn = lambda: step(params, *args)  # noqa: E731
        first_s, (_, scores) = first_call(fn, self.device)
        flops = row_flops(row, self.config["network"])
        return {"first_call_s": first_s,
                **measure(row, fn, flops, self.iters_of(row), self.repeats),
                "first_scores_finite": bool(torch.isfinite(scores).all())}

    def train_step(self, row: Row) -> "TrainStep":
        """The registered train step on DEFAULT_CONFIG with the row's batch,
        views (min_L too), patch and compute dtype, the plain warp as
        configured, on the seed-0 state and the row's inputs."""
        cfg = copy.deepcopy(self.config)
        cfg["training"].update({"batch_size": row.batch, "n_views": row.views,
                                "min_L": row.views, "patch_size": row.size,
                                "compute_dtype": row.dtype})
        return TrainStep(cfg, self.device, scored_inputs(row, self.device))

    def row_train_step(self, row: Row) -> Dict[str, Any]:
        """A train row's step timed; the f32 row also writes the startup entry."""
        one_step = self.train_step(row)
        init_s = one_step.init_s
        first_s, _ = first_call(one_step, self.device)
        age_s = time.perf_counter() - _T_PROC0
        flops = row_flops(row, one_step.config["network"])
        out = {"init_time_s": round(init_s, 3), "first_call_s": first_s,
               **measure(row, one_step, flops, self.iters_of(row), self.repeats)}
        out["projected_400epoch_1160scene_hours"] = (
            PROJECTED_EPOCHS * PROJECTED_SCENES * out["step_time_s"] / row.batch / 3600)
        state, metrics = one_step.state, one_step.metrics
        out["steps"] = state.step
        out["last_loss"] = float(metrics["loss"])
        out["max_abs_shift"] = float(metrics["max_abs_shift"])
        out["state_dtypes"] = state_dtypes(state)
        # random data at the config's lr can drive ShiftNet past the warp's
        # window, even to a non-finite loss: printed, and the time stands
        log(f"  {row.name}: loss {out['last_loss']} after {state.step} steps, max |shift| "
            f"{out['max_abs_shift']} px")
        if row.dtype == "float32" and "startup" not in self.details:
            self.details["startup"] = {
                "what": "process start (the bench module's import) to the first completed "
                        "train step (eager: no compile; the rows before this one included)",
                **self.details.get("kernels", {}),
                "init_time_s": round(init_s, 3),
                "first_step_s": round(first_s, 3),
                "init_plus_first_step_s": round(init_s + first_s, 3),
                "process_start_to_first_step_s": round(age_s, 3),
            }
        return out


class TrainStep:
    """A train row's registered step on its own state and inputs: each call
    takes one step (the state advances) and returns its metrics."""

    def __init__(self, config: Dict[str, Any], device: torch.device, args: tuple):
        from highresnet_tpu_torch.train.state import create_train_state
        from highresnet_tpu_torch.train.step import build_train_step

        self.config = config
        t0 = time.perf_counter()
        self.state = create_train_state(config, device, torch.Generator().manual_seed(0))
        synchronize(device)
        self.init_s = time.perf_counter() - t0
        self.step = build_train_step(config)
        self.args = args
        self.metrics: Dict[str, Any] = {}

    def __call__(self) -> Dict[str, Any]:
        self.state, self.metrics = self.step(self.state, *self.args)
        return self.metrics


def state_dtypes(state) -> Dict[str, list]:
    """The dtypes of the parameters, gradients and Adam moments (all f32,
    whatever the compute dtype)."""
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    moments = [t for p in params for k, t in state.optimizer.state[p].items()
               if k in ("exp_avg", "exp_avg_sq")]
    names = lambda ts: sorted({str(t.dtype).removeprefix("torch.") for t in ts})  # noqa: E731
    return {"params": names(params), "grads": names(p.grad for p in params),
            "adam_moments": names(moments)}


def write_details(details: Dict[str, Any], out: Path) -> None:
    """Rewrite the details file whole (after every row)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".tmp")
    tmp.write_text(json.dumps(details, indent=2))
    os.replace(tmp, out)


def load_kernels(device: torch.device) -> Dict[str, Any]:
    """Build or load the CUDA kernels before any row (a build failure
    raises); its seconds and whether the library was already built."""
    if device.type != "cuda":
        return {}
    from highresnet_tpu_torch.kernels import build

    cached = build.library_path().is_file()
    t0 = time.perf_counter()
    build.load()
    return {"kernel_build_s": round(time.perf_counter() - t0, 3), "kernel_build_cached": cached}


def run_rows(bench: Bench, rows, out: Path) -> None:
    """Run ``rows`` in order, the details rewritten after each; the first
    row's scenes/s goes out as the JSON line as soon as it is measured. A
    row that raises is recorded with its error and the next row runs."""
    for row in rows:
        log(f"[bench] {row.name} ({row.kind}, batch {row.batch}, {row.views} views, "
            f"{row.size} px, {row.dtype})...")
        try:
            result = bench.run(row)
        except RuntimeError as e:  # out of memory, a refused algorithm: reported, not hidden
            result = {**asdict(row), "error": f"{type(e).__name__}: {str(e).splitlines()[0]}"}
            log(f"[bench] {row.name} failed: {result['error']}\n{traceback.format_exc()}")
        bench.details["configs"].append(result)
        write_details(bench.details, out)
        if row is rows[0] and "error" not in result:
            value = result["scenes_per_sec"]
            print(json.dumps({"metric": HEADLINE_METRIC, "value": round(value, 3),
                              "unit": "scenes/sec/chip",
                              "vs_baseline": round(value / BASELINE_SCENES_PER_S, 3)}),
                  flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="one tiny forward (batch 1, 2 views, 16 px)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(DEFAULT_OUT), help="the details file")
    args = ap.parse_args(argv)
    if not args.smoke and torch.device(args.device).type == "cpu":
        ap.error("the full rows need a card; on the CPU run --smoke")
    return args


def main(argv=None, iters: int | None = None, repeats: int = REPEATS) -> Dict[str, Any]:
    """Run the bench; returns the details (the rows under ``configs``).
    ``iters`` and ``repeats`` shorten every row's windows for a caller in
    the same process (default: each row's own window, ``REPEATS`` times)."""
    args = parse_args(argv)
    device = setup_device(args.device)
    out = Path(args.out)
    bench = Bench(device, iters=iters, repeats=repeats)
    details = bench.details
    details.update({
        "device": card_line() if device.type == "cuda" else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "kernels": load_kernels(device),
        "configs": [],
    })

    if args.smoke:
        row = bench.run(SMOKE_ROW)
        details["configs"].append(row)
        write_details(details, out)
        print(json.dumps({"metric": SMOKE_METRIC, "value": round(row["scenes_per_sec"], 3),
                          "unit": "scenes/sec", "vs_baseline": 0.0}), flush=True)
        return details

    run_rows(bench, ROWS, out)
    log(f"[bench] done; details in {out}")
    return details


if __name__ == "__main__":
    details = main()
    sys.exit(1 if any("error" in row for row in details["configs"]) else 0)
