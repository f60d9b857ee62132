"""Find a cell's files by name.

- a cell: ``workloads/<cell>.json``, holding ``config``, ``traffic``,
  ``chips``, the ``limits`` of its numbers compared for ``correct`` and,
  optionally, ``report_as``: the name under which the cell reports a
  metric of its driver (cells of one kind whose throughputs need bounds
  of their own);
- a configuration: ``configs/<config>.json``;
- a traffic mix: ``traffic/<traffic>.json``, whose ``kind`` names its
  driver, ``drivers/<kind>.py``, and whose other keys are that
  module's parameters;
- a per-layer metric: its entry in ``BENCHMARK.json`` (unit, the
  end-to-end metric it moves, its cells) and a reader with ``read(ctx)``,
  ``metrics/<metric>.py`` or, shared by the metric's cases, the file of
  the name's part before its first dot (``idle_share.train`` is read by
  ``metrics/idle_share.py``).

Adding any of them is adding files: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config_name: str
    config_path: Path
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    chips: int
    limits: Dict[str, float]
    report_as: Dict[str, str]


def _json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    return json.loads(path.read_text())


def load_module(path: Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    name = f"perfbench_{path.parent.name}_{path.stem}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, root: Path = ROOT) -> Cell:
    cell = _json(root / "workloads" / f"{name}.json")
    config_path = root / "configs" / f"{cell['config']}.json"
    return Cell(
        name=name,
        config_name=cell["config"],
        config_path=config_path,
        config=_json(config_path),
        traffic_name=cell["traffic"],
        traffic=_json(root / "traffic" / f"{cell['traffic']}.json"),
        chips=int(cell["chips"]),
        limits={k: float(v) for k, v in cell["limits"].items()},
        report_as=cell.get("report_as", {}),
    )


def driver(cell: Cell, root: Path = ROOT) -> ModuleType:
    return load_module(root / "drivers" / f"{cell.traffic['kind']}.py")


def e2e(cell: Cell, drv: ModuleType) -> Dict[str, str]:
    """The cell's end-to-end metrics and their units: its driver's, each
    under the name the cell's ``report_as`` gives it."""
    return {cell.report_as.get(k, k): unit for k, unit in drv.E2E.items()}


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    path = root / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = root / "metrics" / f"{metric.split('.')[0]}.py"
    return load_module(path)


def per_layer(cell: str, e2e, root: Path = ROOT) -> List[Dict[str, Any]]:
    """The per-layer entries of ``BENCHMARK.json`` (beside ``root``) that
    this cell reports: each moves one of its end-to-end metrics ``e2e``
    and, where it lists cells, lists this one."""
    entries = _json(root.parent / "BENCHMARK.json")["per_layer"]
    return [m for m in entries if m["moves"] in e2e and cell in m.get("workloads", [cell])]
