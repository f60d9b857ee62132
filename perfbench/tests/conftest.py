"""Fixtures of the benchmark's tests: a copy of the benchmark's data files
at a tiny width that the CPU runs in seconds, whose drivers and readers
are the benchmark's own files."""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TINY_NETWORK = {
    "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 8},
    "recursive": {"alpha_residual": True, "in_channels": 8, "num_layers": 2, "kernel_size": 3},
    "decoder": {"deconv": {"in_channels": 8, "kernel_size": 3, "stride": 3, "out_channels": 8},
                "final": {"in_channels": 8, "kernel_size": 1, "out_channels": 1}},
}
TINY_TRAINING = {"batch_size": 2, "min_L": 4, "patch_size": 16, "register_size": 32}
TINY_TRAFFIC = {  # by kind
    "archive": {"batch": 2, "views": 5, "lr_size": 16, "min_views": 3, "pool": 2},
    "train": {"pool": 4, "steps_per_call": 2},
    "tta": {"views": 5, "lr_size": 16, "min_views": 3, "pool": 3},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """``tmp_path/perfbench``: the benchmark's cells, configurations and
    traffic at a tiny width, with its drivers, readers and BENCHMARK.json
    copied."""
    root = tmp_path / "perfbench"
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in ("workloads", "drivers", "metrics"):
        shutil.copytree(ROOT / d, root / d)
    (root / "configs").mkdir()
    for p in (ROOT / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["network"] = TINY_NETWORK
        c["training"].update(TINY_TRAINING)
        (root / "configs" / p.name).write_text(json.dumps(c))
    (root / "traffic").mkdir()
    for p in (ROOT / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t.update(TINY_TRAFFIC[t["kind"]])
        (root / "traffic" / p.name).write_text(json.dumps(t))
    return root


def cells():
    return sorted(p.stem for p in (ROOT / "workloads").glob("*.json"))
