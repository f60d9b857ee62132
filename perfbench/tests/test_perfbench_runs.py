"""Whole runs of every cell on the CPU at a tiny width: the program against
the plain reference (correct), the reference at TF32 in the program's
place (not correct), each fault the cell can have planted in the program
(not correct), a traced run, and the command without a card."""

import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench import faults, harness, run
from perfbench.tests.conftest import ROOT, cells

CPU = torch.device("cpu")
SEED = 2**31 + 12345  # larger than 32 signed bits hold
FAULTS = {"archive": ("altered",), "tta": ("altered",), "train": ("unchanged", "half_batch")}


def kind(cell):
    traffic = json.loads((ROOT / "workloads" / f"{cell}.json").read_text())["traffic"]
    return json.loads((ROOT / "traffic" / f"{traffic}.json").read_text())["kind"]


def one(root, cell, **kw):
    return harness.run(cell, SEED, 0.2, kw.pop("trace", False), CPU, time.perf_counter(),
                       root=root, trace_path=root / "trace.json", **kw)


@pytest.mark.parametrize("cell", cells())
def test_reference_agrees_with_the_program(tiny_root, cell):
    r = one(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert "setup_s" in r["metrics"] and len(r["metrics"]) == 2


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(tiny_root, cell):
    assert not one(tiny_root, cell, control=True)["correct"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in cells() for f in FAULTS[kind(c)]])
def test_fault_is_not_correct(tiny_root, cell, fault):
    with faults.plant(fault):
        assert not one(tiny_root, cell)["correct"]


@pytest.mark.parametrize("cell", cells())
def test_traced_run_reports_per_layer_metrics(tiny_root, cell):
    r = one(tiny_root, cell, trace=True)
    assert r["correct"]
    assert "setup_s" not in r["metrics"]
    assert any(name.startswith("mfu.") for name in r["metrics"])  # no device trace on the CPU


def test_command_without_a_card_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", "flagship-archive", "--seed", "1", "--seconds", "1"])
    assert code != 0
    assert capsys.readouterr().out == ""


def test_command_fails_in_a_bare_checkout(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: no program to run."""
    import shutil

    shutil.copytree(ROOT, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "flagship-archive",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", cell, "--seed", "7",
                        "--seconds", "2", "--trace", "1"], cwd=ROOT.parent,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
