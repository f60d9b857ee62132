"""The program's spans (``utils/profiling.py``) on the CPU, over an archive
``Model.forward``, an x8-TTA ``Model(imset)`` scene, a two-model
``Forward.ensemble`` and two steps of ``run_train_epoch``: with no profiler running, ``span`` hands out its shared
no-op context and nothing is recorded; under ``torch.profiler.profile`` each
layer leaves its records, nested by parent and root, and the same spans as
``user_annotation`` events in the Chrome trace; and the SR and the loss are
bit for bit those of an untraced run."""

import json
import math
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from highresnet_tpu_torch.config import load_config
from highresnet_tpu_torch.data.collate import Batch
from highresnet_tpu_torch.data.probav import ImageSet
from highresnet_tpu_torch.eval.evaluator import Forward, Model
from highresnet_tpu_torch.models.network import build_network
from highresnet_tpu_torch.train.epoch import run_train_epoch
from highresnet_tpu_torch.train.state import create_train_state
from highresnet_tpu_torch.train.step import build_train_step
from highresnet_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
NET = {
    "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 8},
    "recursive": {"alpha_residual": True, "in_channels": 8, "kernel_size": 3},
    "decoder": {"deconv": {"in_channels": 8, "kernel_size": 3, "stride": 3, "out_channels": 8},
                "final": {"in_channels": 8, "kernel_size": 1, "out_channels": 1}},
}
SIZE = 16  # LR px
STEPS = 2
STEP_CHILDREN = ("zero_grad", "forward", "register", "loss", "backward", "clip", "optimizer",
                 "ema")


def _config(min_l: int) -> dict:
    c = load_config(str(REPO / "configs" / "config.json"))
    c["network"] = NET
    c["training"].update(batch_size=2, min_L=min_l, patch_size=SIZE, register_size=32,
                         ema_decay=0.9)
    return c


def _model(min_l: int) -> Model:
    config = _config(min_l)
    m = Model(config, CPU)
    m.set_params(build_network(config, CPU).state_dict())
    return m


def archive(views: int = 16):
    """A batch of 2 scenes of ``views`` views through ``Model.forward``."""
    m = _model(views)
    rng = np.random.default_rng(0)
    lrs = rng.random((2, views, SIZE, SIZE), dtype=np.float32)
    alphas = np.ones((2, views), np.float32)
    return lambda: m.forward(lrs, alphas)


def tta8():
    """One 12-view scene through x8 registered TTA, collated to 16 views."""
    m = _model(16)
    m.enable_tta(8, register=True)
    lr = np.random.default_rng(1).random((12, SIZE, SIZE), dtype=np.float32)
    imset = ImageSet(name="s", lr=lr, hr=None, hr_map=None, clearances=np.ones(12, np.float32))
    return lambda: m(imset)[0]


def ensemble():
    """One 16-view scene through a registered two-model ensemble."""
    config = _config(16)
    models = [build_network(config, CPU, torch.Generator().manual_seed(s)) for s in (3, 4)]
    fwd = Forward.ensemble(models, CPU)
    rng = np.random.default_rng(3)
    lrs = rng.random((1, 16, SIZE, SIZE), dtype=np.float32)
    alphas = np.ones((1, 16), np.float32)
    return lambda: fwd(lrs, alphas)


def train():
    """Two registered steps with EMA from a fresh state: the epoch's loss and
    every parameter after them."""
    config = _config(4)
    rng = np.random.default_rng(2)
    batches = [Batch(rng.random((2, 4, SIZE, SIZE), dtype=np.float32),
                     np.ones((2, 4), np.float32),
                     rng.random((2, 3 * SIZE, 3 * SIZE), dtype=np.float32),
                     np.ones((2, 3 * SIZE, 3 * SIZE), np.float32), ["a", "b"])
               for _ in range(STEPS)]

    def run():
        state = create_train_state(config, CPU, torch.Generator().manual_seed(0))
        state, stats, _ = run_train_epoch(batches, state, build_train_step(config), CPU)
        params = [p.detach().clone() for m in (state.hrnet, state.shiftnet)
                  for p in m.parameters()]
        return [torch.tensor(stats["train_loss"], dtype=torch.float64), *params]
    return run


CALLS = {"archive": archive, "tta8": tta8, "ensemble": ensemble, "train": train}


def traced(run):
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = run()
    return out, profiling.spans()


def by_name(recs, name):
    return [r for r in recs if r["name"] == name]


def test_the_switch_is_the_profiler():
    assert callable(torch.autograd._profiler_enabled)
    assert not torch.autograd._profiler_enabled()
    assert type(profiling.span("serve.call")) is profiling._NoSpan
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd._profiler_enabled()
        assert type(profiling.span("serve.call")) is profiling._Span
    assert type(profiling.span("serve.call")) is profiling._NoSpan


@pytest.mark.parametrize("call", CALLS)
def test_no_profiler_no_records(call):
    run = CALLS[call]()
    profiling.clear_spans()
    off = profiling.span("hrnet.fuse")
    assert type(off) is profiling._NoSpan and profiling.span("hrnet.fuse") is off
    run()
    assert profiling.spans() == []


@pytest.mark.parametrize("views", [16, 2])
def test_fusion_rounds_a_forward(views):
    _, recs = traced(archive(views))
    fuse = by_name(recs, "hrnet.fuse")
    rounds = by_name(recs, "hrnet.fuse.round")
    assert len(fuse) == 1 and len(rounds) == int(math.log2(views))
    assert all(r["parent"] == fuse[0]["id"] for r in rounds)


def test_archive_forward_records():
    _, recs = traced(archive())
    call, = by_name(recs, "serve.call")
    assert Counter(r["name"] for r in recs) == {
        "serve.call": 1, "serve.to_device": 1, "hrnet.encode": 1, "hrnet.fuse": 1,
        "hrnet.fuse.round": 4, "hrnet.decode": 1, "serve.to_host": 1}
    assert all(r["root"] == call["id"] for r in recs)
    for name in ("serve.to_device", "hrnet.encode", "hrnet.fuse", "hrnet.decode",
                 "serve.to_host"):
        assert by_name(recs, name)[0]["parent"] == call["id"]
    assert all(r["host_ms"] >= 0 and r["device_ms"] is None for r in recs)


def test_tta_scene_records():
    _, recs = traced(tta8())
    scene, = by_name(recs, "serve.scene")
    call, = by_name(recs, "serve.call")
    stack, = by_name(recs, "serve.stack")  # the eight members as one forward
    assert stack["parent"] == call["id"] and not by_name(recs, "serve.transform")
    for name in ("hrnet.encode", "hrnet.fuse", "hrnet.decode"):
        assert len(by_name(recs, name)) == 1 and by_name(recs, name)[0]["parent"] == stack["id"]
    assert len(by_name(recs, "hrnet.fuse.round")) == 4
    for name in ("serve.collate", "serve.call", "serve.range_check"):
        assert len(by_name(recs, name)) == 1 and by_name(recs, name)[0]["parent"] == scene["id"]
    for name in ("serve.to_device", "serve.align", "serve.to_host"):
        assert len(by_name(recs, name)) == 1 and by_name(recs, name)[0]["parent"] == call["id"]
    assert all(r["root"] == scene["id"] for r in recs)


def test_ensemble_records():
    _, recs = traced(ensemble())
    call, = by_name(recs, "serve.call")
    transforms = by_name(recs, "serve.transform")  # one forward a member
    assert len(transforms) == 2 and not by_name(recs, "serve.stack")
    assert all(t["parent"] == call["id"] for t in transforms)
    encodes = by_name(recs, "hrnet.encode")
    assert sorted(e["parent"] for e in encodes) == sorted(t["id"] for t in transforms)
    assert len(by_name(recs, "serve.align")) == 1


def test_train_step_records():
    _, recs = traced(train())
    epoch, = by_name(recs, "train.epoch")
    steps = by_name(recs, "train.step")
    assert len(steps) == STEPS and len(by_name(recs, "train.feed")) == STEPS
    assert len(by_name(recs, "train.readback")) == 1
    for child in STEP_CHILDREN:
        recorded = by_name(recs, f"train.step.{child}")
        assert sorted(r["parent"] for r in recorded) == [s["id"] for s in steps], child
    assert all(s["parent"] == epoch["id"] for s in steps)
    assert all(r["root"] == epoch["id"] for r in recs)


@pytest.mark.parametrize("call", CALLS)
def test_spans_in_the_chrome_trace(call, tmp_path):
    run = CALLS[call]()
    with profile(activities=[ProfilerActivity.CPU]), profiling.span("stale"):
        pass
    with profiling.trace(str(tmp_path)) as path:  # clears the store on entry
        run()
    names = Counter(r["name"] for r in profiling.spans())
    assert names and "stale" not in names
    events = json.loads(Path(path).read_text())["traceEvents"]
    annotated = Counter(e["name"] for e in events
                        if e.get("cat") == "user_annotation" and e["name"] in names)
    assert annotated == names


@pytest.mark.parametrize("call", CALLS)
def test_outputs_bit_identical_traced_or_not(call):
    run = CALLS[call]()
    untraced = run()
    out, recs = traced(run)
    assert recs
    if isinstance(out, np.ndarray):
        np.testing.assert_array_equal(out, untraced)
    else:
        assert len(out) == len(untraced)
        assert all(torch.equal(a, b) for a, b in zip(out, untraced))
