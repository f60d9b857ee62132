"""``forwards_per_scene``'s reader on canned span records: the
``serve.stack`` and ``serve.transform`` spans over the traced scenes, 8.0
where an x8 TTA scene runs each member alone, 1.0 where it runs the eight
as one stacked forward, None without either span; and on the records of a
real x8 TTA scene through the program on the CPU."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import cells, spans

METRIC = "forwards_per_scene.tta8"
SCENES = 3


def rec(name, device_ms=1.0):
    return {"name": name, "id": 0, "parent": None, "root": 0, "host_ms": 1.0,
            "device_ms": device_ms}


def scene(members):
    """One traced scene's records: its call, each forward's span and the
    model stages inside it, the alignment."""
    recs = [rec("serve.scene"), rec("serve.collate"), rec("serve.call"), rec("serve.to_device")]
    for name in members:
        recs += [rec(name), rec("hrnet.encode"), rec("hrnet.fuse"), rec("hrnet.decode")]
    return recs + [rec("serve.align"), rec("serve.to_host"), rec("serve.range_check")]


PARENT = [r for _ in range(SCENES) for r in scene(["serve.transform"] * 8)]
STACKED = [r for _ in range(SCENES) for r in scene(["serve.stack"])]
PLAIN = [r for _ in range(SCENES) for r in scene([])]


@pytest.mark.parametrize("records, want", [
    (PARENT, 8.0),
    (STACKED, 1.0),
    ([{**r, "device_ms": None} for r in STACKED], 1.0),  # a count needs no device time
    (PLAIN, None),
    ([], None),
], ids=["parent", "stacked", "host-only", "no-forward-spans", "no-records"])
def test_forwards_per_scene_on_canned_records(records, want, monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: records)
    got = cells.reader(METRIC).read({"traced_items": SCENES})
    assert got is None if want is None else got == pytest.approx(want)


def test_forwards_per_scene_without_traced_scenes(monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: STACKED)
    assert cells.reader(METRIC).read({"traced_items": 0}) is None


def test_forwards_per_scene_is_listed():
    entry, = [m for m in cells._json(cells.ROOT.parent / "BENCHMARK.json")["per_layer"]
              if m["name"] == METRIC]
    assert entry == {"name": METRIC, "unit": "forwards", "better": "lower",
                     "source": "program_span", "layer": "serving entry: eval.evaluator.Model",
                     "moves": "tta8_p90_ms", "workloads": ["flagship-tta8"]}


def test_forwards_per_scene_of_a_tta_scene_through_the_program():
    from highresnet_tpu_torch.eval.evaluator import Forward
    from highresnet_tpu_torch.models import HRNet
    from highresnet_tpu_torch.utils import profiling

    net = {"encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 8},
           "recursive": {"alpha_residual": True, "in_channels": 8, "kernel_size": 3},
           "decoder": {"deconv": {"in_channels": 8, "kernel_size": 3, "stride": 3,
                                  "out_channels": 8},
                       "final": {"in_channels": 8, "kernel_size": 1, "out_channels": 1}}}
    fwd = Forward.tta(HRNet(net, generator=torch.Generator().manual_seed(0)),
                      torch.device("cpu"), transforms=8)
    lrs = np.random.default_rng(0).random((1, 4, 16, 16), dtype=np.float32)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(SCENES):
            fwd(lrs, np.ones((1, 4), np.float32))
    assert cells.reader(METRIC).read({"traced_items": SCENES}) == 1.0
