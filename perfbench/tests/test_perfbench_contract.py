"""BENCHMARK.json against the benchmark's files: the names and units, every
cell's files found by name, a cell added by adding files alone, and the
imports the benchmark may not make."""

import ast
import json
import re
import shutil

from perfbench import cells, harness
from perfbench.tests.conftest import ROOT

BENCHMARK = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"[^\t\n\r]{1,200}$")


def test_names_units_and_lines():
    metrics = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]
    named = BENCHMARK["configs"] + BENCHMARK["workloads"] + metrics
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCHMARK[group]]
        assert len(names) == len(set(names)), group
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for w in BENCHMARK["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
    for c in BENCHMARK["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCHMARK["per_layer"]:
        assert LINE.match(m["layer"])
    assert all(LINE.match(word) for word in BENCHMARK["command"])


def test_every_cell_resolves_by_name():
    configs = {c["name"]: c["file"] for c in BENCHMARK["configs"]}
    for w in BENCHMARK["workloads"]:
        cell = cells.load_cell(w["name"])
        assert (cell.config_name, cell.traffic_name, cell.chips) == (
            w["config"], w["traffic"], w["chips"])
        assert cell.config_path == ROOT.parent / configs[w["config"]]
        drv = cells.driver(cell)
        assert set(cell.limits), w["name"]
        e2e = cells.e2e(cell, drv)
        for m in BENCHMARK["end_to_end"]:
            assert (w["name"] in m.get("workloads", [w["name"]])) == (
                m["name"] in set(e2e) | {"setup_s"})
            if m["name"] in e2e:
                assert e2e[m["name"]] == m["unit"]


def test_every_per_layer_metric_has_its_reader():
    e2e = {}
    for w in BENCHMARK["workloads"]:
        cell = cells.load_cell(w["name"])
        e2e[w["name"]] = set(cells.e2e(cell, cells.driver(cell)))
    for m in BENCHMARK["per_layer"]:
        assert callable(cells.reader(m["name"]).read), m["name"]
        assert {w for w, names in e2e.items() if m["moves"] in names} == set(m["workloads"])
    for w, names in e2e.items():
        reported = {m["name"] for m in cells.per_layer(w, names)}
        assert reported == {m["name"] for m in BENCHMARK["per_layer"] if w in m["workloads"]}


def test_a_dropped_in_cell_is_found_without_editing_code(tmp_path):
    root = tmp_path / "perfbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "traffic" / "archive-b4.json").write_text(json.dumps(
        {"kind": "archive", "batch": 4, "views": 16, "lr_size": 128, "min_views": 9, "pool": 4}))
    (root / "workloads" / "flagship-archive-b4.json").write_text(json.dumps(
        {"config": "hrnet-flagship", "traffic": "archive-b4", "chips": 1,
         "limits": {"sr_gap": 1e-4}}))
    (root / "metrics" / "calls.py").write_text(
        "def read(ctx):\n    return len(ctx['latencies_s'])\n")
    bench = json.loads(json.dumps(BENCHMARK))
    bench["workloads"].append({"name": "flagship-archive-b4", "config": "hrnet-flagship",
                               "traffic": "archive-b4", "chips": 1, "why": "batch 4"})
    for m in bench["per_layer"]:
        if m["moves"] == "archive_scenes_per_s":
            m["workloads"].append("flagship-archive-b4")
    bench["per_layer"].append({"name": "calls.archive", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "serving entry",
                               "moves": "archive_scenes_per_s",
                               "workloads": ["flagship-archive-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load_cell("flagship-archive-b4", root)
    drv = cells.driver(cell, root)
    assert cell.traffic["batch"] == 4 and drv.E2E
    names = [m["name"] for m in cells.per_layer(cell.name, drv.E2E, root)]
    assert "calls.archive" in names and "mfu.archive" in names
    assert cells.reader("calls.archive", root).read({"latencies_s": [1, 2]}) == 2
    assert cells.reader("mfu.archive", root).__file__.endswith("mfu.py")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_jax_and_a_reference_free_of_the_program():
    for path in ROOT.rglob("*.py"):
        names = set(_imports(path))
        assert not names & set(harness.FORBIDDEN), path
        if "reference" in path.relative_to(ROOT).parts:
            assert "highresnet_tpu_torch" not in names, path
    for path in ROOT.rglob("*.py"):
        if "tests" not in path.relative_to(ROOT).parts:
            text = path.read_text()
            assert "BENCH_" not in text and "bench.py" not in text, path
