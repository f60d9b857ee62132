"""Profiling and numerical-debugging hooks.

The counterpart of ``highresnet_tpu/utils/profiling.py``:

- ``trace(log_dir)``: a ``torch.profiler`` window (host and, on a card, CUDA
  activity) that writes a Chrome trace under ``log_dir`` on exit and clears
  the span store on entry;
- ``span(name)``: a named region of the program's own layers, as a context
  manager or a decorator, and ``spans()``: the regions recorded (below);
- ``sync(tree)``: wait for the devices of the tensors in a nested structure;
- ``timed(fn)``: mean seconds per call, from CUDA events when ``fn`` returns
  CUDA tensors and from the host clock otherwise;
- ``enable_nan_debugging``: ``torch.autograd.set_detect_anomaly``, the
  reference's ``detect_anomaly``, behind ``training.debug_nans``.

The JAX package's relay timing protocol (``enqueue_timed``) has no use on
a card that synchronises truthfully and is not ported.

Spans. The active torch.profiler is their only switch. While none runs,
``span`` returns a shared no-op context, one per name, after a single
``torch.autograd._profiler_enabled()`` check: no allocation, no
``record_function``, no CUDA call. Under a profiler (``trace`` or any
``torch.profiler.profile``) a span enters ``record_function(name)``, so it
lands in the Chrome trace as a ``user_annotation`` over the work it
launched, and keeps a record in a store of at most ``SPAN_LIMIT`` (the
oldest go first): its name, id, the id of the span open around it
(``parent``) and of the outermost one (``root``: the spans of one scene or
one epoch share it), host start and end on ``time.perf_counter_ns`` and,
once CUDA is in use, two timing events recorded on the current stream at
entry and exit (none while that stream is being captured into a CUDA graph:
such a span has host time alone). Nothing in a span waits for the card;
``spans()`` does, when it resolves the events. The spans, by layer:

- serving entry (``eval/evaluator.py``): ``serve.scene`` (one scene through
  ``get_sr_and_score``), ``serve.collate``, ``serve.call`` (a forward's
  ``__call__``), ``serve.to_device``, ``serve.stack`` (one forward of
  several TTA elements stacked along the batch axis, the dihedral
  transforms and their inverses included), ``serve.transform`` (one
  ensemble member's forward), ``serve.align`` (the PCC alignment and the
  mean), ``serve.to_host``, ``serve.range_check`` (the range check and the
  score, once the SR is on the host);
- model stages (``models/hrnet.py``): ``hrnet.encode``, ``hrnet.fuse``,
  ``hrnet.fuse.round`` (one pairwise round), ``hrnet.decode``; RAMS's
  (``models/rams.py``): ``rams.features``, ``rams.reduce``,
  ``rams.upscale``, ``rams.global``, and ``rams.gate`` (each attention
  gate, nested in those);
- train loop (``train/epoch.py``): ``train.epoch``, ``train.feed`` (a
  batch's host-to-device copies), ``train.step``, ``train.readback`` (the
  epoch's one read of its metrics);
- train step (``train/step.py``): ``train.step.zero_grad``, ``.forward``,
  ``.register``, ``.loss``, ``.backward``, ``.clip``, ``.optimizer``,
  ``.ema``; with CUDA graphs (``train/graphs.py``) ``train.step.capture``
  (one graph's capture) and ``train.step.replay`` (one graph's replay), and
  a replayed step opens only ``.zero_grad`` and ``.optimizer`` of the rest.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List

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
    clear_spans()
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


SPAN_LIMIT = 65536  # span records kept; the oldest go first


class _Record:
    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns", "events", "device_ms")


_RECORDS: deque = deque(maxlen=SPAN_LIMIT)
_IDS = itertools.count(1)
_THREAD = threading.local()  # .open: this thread's stack of open records


class _NoSpan:
    """A span while no profiler runs: entering and leaving cost nothing.
    As a decorator it opens ``span(name)`` at each call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn: Callable) -> Callable:
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapped


class _Span(_NoSpan):
    """A span under a profiler: a ``record_function`` and a record."""

    __slots__ = ("record", "annotation")

    def __enter__(self):
        stack = getattr(_THREAD, "open", None)
        if stack is None:
            stack = _THREAD.open = []
        rec = self.record = _Record()
        rec.name, rec.id = self.name, next(_IDS)
        outer = stack[-1] if stack else None
        rec.parent = outer.id if outer else None
        rec.root = outer.root if outer else rec.id
        rec.end_ns = rec.device_ms = rec.events = None
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        stack.append(rec)
        _RECORDS.append(rec)
        rec.start_ns = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        rec = self.record
        rec.end_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        _THREAD.open.pop()
        self.annotation.__exit__(*exc)
        return False


_OFF: Dict[str, _NoSpan] = {}  # the no-op span of each name


def span(name: str) -> _NoSpan:
    """The region ``name`` of the program: ``with span("hrnet.fuse"): ...``
    or ``@span("serve.call")``. Recorded only while a torch.profiler runs
    (module notes)."""
    if not torch.autograd._profiler_enabled():
        off = _OFF.get(name)
        return off if off is not None else _OFF.setdefault(name, _NoSpan(name))
    return _Span(name)


def clear_spans() -> None:
    """Empty the span store."""
    _RECORDS.clear()


def spans() -> List[Dict[str, Any]]:
    """The closed spans in the store, in the order they opened: ``name``,
    ``id``, ``parent``, ``root``, ``host_ms`` and ``device_ms``, the time
    between the span's two CUDA events (None where CUDA was not in use).
    Waits for the card to reach each span's end."""
    out = []
    for rec in list(_RECORDS):
        if rec.end_ns is None:
            continue
        if rec.events is not None:
            start, end = rec.events
            end.synchronize()
            rec.device_ms, rec.events = start.elapsed_time(end), None
        out.append({"name": rec.name, "id": rec.id, "parent": rec.parent, "root": rec.root,
                    "host_ms": (rec.end_ns - rec.start_ns) / 1e6, "device_ms": rec.device_ms})
    return out
