"""The ``rams-archive`` cell on the CPU at a tiny width: the program against
the plain reference (correct), the reference at TF32 in the program's place
and the program with its served SR altered (not correct), a traced run; its
FLOP count against the reference's own convolutions, and its span readers
on canned records."""

import json
import shutil
import time

import pytest
import torch
import torch.nn.functional as F

from perfbench import cells, faults, harness, spans
from perfbench.flops_rams import rams_forward_flops
from perfbench.reference import rams as ref_rams
from perfbench.tests.conftest import ROOT

CPU = torch.device("cpu")
SEED = 2**31 + 54321  # larger than 32 signed bits hold
CELL = "rams-archive"
TINY_RAMS = {"filters": 8, "kernel_size": 3, "views": 9, "reduction": 4, "blocks": 2, "scale": 3}
TINY_TRAFFIC = {"batch": 2, "lr_size": 12, "min_views": 5, "pool": 2}


@pytest.fixture
def rams_root(tmp_path):
    """``tmp_path/perfbench``: the cell's configuration and traffic at a tiny
    width, with the benchmark's cells, drivers, readers and BENCHMARK.json."""
    root = tmp_path / "perfbench"
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in ("workloads", "drivers", "metrics", "configs", "traffic"):
        shutil.copytree(ROOT / d, root / d)
    cell = cells.load_cell(CELL)
    config = {**cell.config, "network": {"arch": "rams", "rams": TINY_RAMS}}
    (root / "configs" / f"{cell.config_name}.json").write_text(json.dumps(config))
    (root / "traffic" / f"{cell.traffic_name}.json").write_text(
        json.dumps({**cell.traffic, **TINY_TRAFFIC}))
    return root


def one(root, **kw):
    return harness.run(CELL, SEED, 0.2, kw.pop("trace", False), CPU, time.perf_counter(),
                       root=root, trace_path=root / "trace.json", **kw)


def test_reference_agrees_with_the_program(rams_root):
    r = one(rams_root)
    assert r["correct"], r["checks"]
    assert r["checks"]["sr_gap"]["value"] < 1e-5  # the same float32 convolutions on the CPU
    assert r["attempted"] > 0 and set(r["metrics"]) == {"archive_scenes_per_s", "setup_s"}


def test_control_is_not_correct(rams_root):
    assert not one(rams_root, control=True)["correct"]


def test_altered_output_is_not_correct(rams_root):
    with faults.plant("altered"):
        assert not one(rams_root)["correct"]


def test_traced_run_reports_per_layer_metrics(rams_root):
    r = one(rams_root, trace=True)
    assert r["correct"]
    names = {m["name"] for m in cells.per_layer(CELL, {"archive_scenes_per_s": "scenes/s"},
                                                rams_root)}
    assert {"features_ms.rams_archive", "reduce_ms.rams_archive", "gate_ms.rams_archive",
            "conv_roofline.rams_archive", "mfu.rams_archive", "idle_share.rams_archive"} <= names
    # a CPU run has no device trace; its spans carry device time only where CUDA is in use
    assert "mfu.rams_archive" in r["metrics"] and set(r["metrics"]) <= names
    assert not {"conv_roofline.rams_archive", "idle_share.rams_archive"} & set(r["metrics"])


@pytest.mark.parametrize("network", [{}, {"rams": TINY_RAMS}])
def test_flop_count_equals_the_references_convolutions(network, monkeypatch):
    """2 x MACs of every conv the reference runs, at each one's output size."""
    counted = []

    def counting(conv):
        def run(x, w, b=None, padding=0):
            y = conv(x, w, b, padding=padding)
            counted.append(2.0 * y.numel() * w[0].numel())
            return y
        return run

    monkeypatch.setattr(ref_rams.F, "conv3d", counting(F.conv3d))
    monkeypatch.setattr(ref_rams.F, "conv2d", counting(F.conv2d))
    size = 6
    net = ref_rams.RAMS(network)
    params = ref_rams.with_gains({k: torch.ones(s) for k, s, _, _ in ref_rams.param_spec(network)})
    net(params, torch.rand(2, 9, size, size), torch.ones(2, 9))
    assert sum(counted) == pytest.approx(rams_forward_flops(network, 2, size), rel=1e-12)


def rec(name, device_ms):
    return {"name": name, "id": 0, "parent": None, "root": 0, "host_ms": 1.0,
            "device_ms": device_ms}


@pytest.mark.parametrize("metric, want", [
    ("features_ms.rams_archive", (40.0 + 44.0) / 4),
    ("reduce_ms.rams_archive", 10.0 / 4),
    ("gate_ms.rams_archive", (1.0 + 2.0 + 3.0) / 4),
])
def test_span_readers_on_canned_records(metric, want, monkeypatch):
    records = [rec("rams.features", 40.0), rec("rams.gate", 1.0), rec("rams.gate", 2.0),
               rec("rams.features", 44.0), rec("rams.reduce", 10.0), rec("rams.gate", 3.0),
               rec("rams.upscale", 0.5), rec("hrnet.fuse", 7.0)]
    monkeypatch.setattr(spans, "records", lambda: records)
    assert cells.reader(metric).read({"traced_items": 4}) == pytest.approx(want)
    monkeypatch.setattr(spans, "records", lambda: [])  # a program without RAMS's spans
    assert cells.reader(metric).read({"traced_items": 4}) is None


@pytest.mark.cuda
def test_cell_on_the_card():
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", CELL, "--seed", "7",
                        "--seconds", "2", "--trace", "1"], cwd=ROOT.parent,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    assert {"features_ms.rams_archive", "reduce_ms.rams_archive",
            "gate_ms.rams_archive"} <= set(r["metrics"])
