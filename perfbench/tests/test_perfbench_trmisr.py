"""The ``trmisr-archive`` cell on the CPU at a tiny width: the program against
the plain reference (correct), the reference at TF32 in the program's place
and the program with its served SR altered (not correct), a traced run; its
FLOP count against the reference's own convolutions, linear layers and
attention products, and its span readers on canned records."""

import json
import shutil
import time

import pytest
import torch
import torch.nn.functional as F

from perfbench import cells, faults, flops, harness, spans
from perfbench.flops_trmisr import attend_bytes, trmisr_forward_flops
from perfbench.reference import trmisr as ref_trmisr
from perfbench.tests.conftest import ROOT

CPU = torch.device("cpu")
SEED = 2**31 + 65432  # larger than 32 signed bits hold
CELL = "trmisr-archive"
TINY = {"encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 8},
        "transformer": {"dim": 8, "depth": 2, "heads": 2, "head_dim": 4, "mlp_dim": 16}}
TINY_TRAFFIC = {"batch": 2, "views": 5, "lr_size": 12, "min_views": 3, "pool": 2}


@pytest.fixture
def trmisr_root(tmp_path):
    """``tmp_path/perfbench``: the cell's configuration and traffic at a tiny
    width, with the benchmark's cells, drivers, readers and BENCHMARK.json."""
    root = tmp_path / "perfbench"
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in ("workloads", "drivers", "metrics", "configs", "traffic"):
        shutil.copytree(ROOT / d, root / d)
    cell = cells.load_cell(CELL)
    config = {**cell.config, "network": {"arch": "trmisr", **TINY}}
    (root / "configs" / f"{cell.config_name}.json").write_text(json.dumps(config))
    (root / "traffic" / f"{cell.traffic_name}.json").write_text(
        json.dumps({**cell.traffic, **TINY_TRAFFIC}))
    return root


def one(root, **kw):
    return harness.run(CELL, SEED, 0.2, kw.pop("trace", False), CPU, time.perf_counter(),
                       root=root, trace_path=root / "trace.json", **kw)


def test_reference_agrees_with_the_program(trmisr_root):
    r = one(trmisr_root)
    assert r["correct"], r["checks"]
    assert r["checks"]["sr_gap"]["value"] < 1e-5  # the same float32 arithmetic on the CPU
    assert r["attempted"] > 0 and set(r["metrics"]) == {"archive_scenes_per_s", "setup_s"}


def test_control_is_not_correct(trmisr_root):
    assert not one(trmisr_root, control=True)["correct"]


def test_altered_output_is_not_correct(trmisr_root):
    with faults.plant("altered"):
        assert not one(trmisr_root)["correct"]


def test_traced_run_reports_per_layer_metrics(trmisr_root):
    r = one(trmisr_root, trace=True)
    assert r["correct"]
    names = {m["name"] for m in cells.per_layer(CELL, {"archive_scenes_per_s": "scenes/s"},
                                                trmisr_root)}
    assert names == {"idle_share.trmisr_archive", "mfu.trmisr_archive",
                     "conv_roofline.trmisr_archive", "transformer_ms.trmisr_archive",
                     "attend_roofline.trmisr_archive"}
    # a CPU run has no device trace, and its spans carry no device time
    assert set(r["metrics"]) == {"mfu.trmisr_archive"}


@pytest.mark.parametrize("network", [{}, TINY])
def test_flop_count_equals_the_references_products(network, monkeypatch):
    """2 x MACs of every conv and linear layer the reference runs at its
    output size, and of the attention's two products; ``conv`` without
    the latter."""
    counted = {"conv": [], "core": []}

    def conv2d(x, w, b=None, padding=0):
        y = F.conv2d(x, w, b, padding=padding)
        counted["conv"].append(2.0 * y.numel() * w[0].numel())
        return y

    def linear(x, w, b=None):
        counted["conv"].append(2.0 * x.numel() // x.shape[-1] * w.numel())
        return F.linear(x, w, b)

    plain_matmul = torch.matmul

    def matmul(a, b):
        y = plain_matmul(a, b)
        counted["core"].append(2.0 * y.numel() * a.shape[-1])
        return y

    monkeypatch.setattr(ref_trmisr.Ops, "conv2d", lambda self, *a, **k: conv2d(*a, **k))
    monkeypatch.setattr(ref_trmisr.Ops, "linear", lambda self, *a: linear(*a))
    monkeypatch.setattr(ref_trmisr.torch, "matmul", matmul)
    size, views = 4, 3
    params = {k: torch.ones(s) for k, s, _, _ in ref_trmisr.param_spec(network)}
    ref_trmisr.TRMISR(network)(params, torch.rand(2, views, size, size), torch.ones(2, views))
    conv = sum(counted["conv"])
    assert conv == pytest.approx(trmisr_forward_flops(network, 2, views, size, conv=True),
                                 rel=1e-12)
    assert conv + sum(counted["core"]) == pytest.approx(
        trmisr_forward_flops(network, 2, views, size), rel=1e-12)


def test_published_shares():
    """At the cell's shape the transformer is 85% of the forward's 648 GFLOP
    a scene, and the attention core must move 13.7 GB a scene."""
    net = json.loads((ROOT / "configs" / "trmisr-probav.json").read_text())["network"]
    total = trmisr_forward_flops(net, 1, 16, 128)
    assert total == pytest.approx(648.44e9, rel=1e-4)
    assert attend_bytes(net, 1, 16, 128) == pytest.approx(13.69e9, rel=1e-3)
    encoder_and_decoder = trmisr_forward_flops({**net, "transformer": {
        **net["transformer"], "depth": 0}}, 1, 16, 128)
    assert 1 - encoder_and_decoder / total == pytest.approx(0.85, abs=0.005)


def rec(name, device_ms):
    return {"name": name, "id": 0, "parent": None, "root": 0, "host_ms": 1.0,
            "device_ms": device_ms}


def test_span_readers_on_canned_records(monkeypatch):
    records = [rec("trmisr.transformer", 40.0), rec("trmisr.attend", 2.0),
               rec("trmisr.attend", 3.0), rec("trmisr.transformer", 44.0),
               rec("trmisr.encode", 7.0), rec("hrnet.fuse", 7.0)]
    monkeypatch.setattr(spans, "records", lambda: records)
    ctx = {"traced_items": 4, "attend_bytes_per_item": 1e9}
    assert cells.reader("transformer_ms.trmisr_archive").read(ctx) == pytest.approx(84.0 / 4)
    want = 100.0 * 1e9 / (5.0 / 4 * 1e-3) / flops.H100_HBM_BYTES_PER_S
    assert cells.reader("attend_roofline.trmisr_archive").read(ctx) == pytest.approx(want)
    monkeypatch.setattr(spans, "records", lambda: [])  # a program without TR-MISR's spans
    for metric in ("transformer_ms.trmisr_archive", "attend_roofline.trmisr_archive"):
        assert cells.reader(metric).read(ctx) is None


@pytest.mark.cuda
def test_cell_on_the_card():
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", CELL, "--seed", "7",
                        "--seconds", "2", "--trace", "1"], cwd=ROOT.parent,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    assert {"transformer_ms.trmisr_archive", "attend_roofline.trmisr_archive"} <= set(r["metrics"])
    assert r["metrics"]["attend_roofline.trmisr_archive"]["value"] <= 100.0
    assert r["metrics"]["conv_roofline.trmisr_archive"]["value"] <= 100.0
