"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name:

* ``configs[].file``: the model configuration;
* ``portbench/traffic/<traffic>.json``: the traffic mix, whose ``runner``
  names ``portbench/runners/<runner>.py``;
* the configuration's ``family`` names ``portbench/families/<family>.py``;
* ``portbench/limits/<workload>.json``: the limits of the numbers that
  decide ``correct``;
* ``portbench/metrics/<metric>.py``: each per-layer metric's reader.

A later cell, mix or metric is new files and new entries, never an edit.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The module in ``path``, loaded by its file (a metric's name holds a
    dot, so it is no import name)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    name = f"portbench._files.{path.parent.name}.{path.stem}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def runner(self) -> ModuleType:
        return importlib.import_module(f"portbench.runners.{self.traffic['runner']}")

    def family(self) -> ModuleType:
        return importlib.import_module(f"portbench.families.{self.config['family']}")


def _applies(metric: dict, workload: str, reported: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load_cell(name: str, bench: Optional[dict] = None, root: Path = ROOT,
              package: Path = PACKAGE) -> Cell:
    """The cell ``name`` of ``bench`` (``root/BENCHMARK.json`` by default),
    its mix and limits from ``package``."""
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(package / "traffic" / f"{w['traffic']}.json")
    limits = load_json(package / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer)


def metric_reader(name: str, package: Path = PACKAGE) -> ModuleType:
    return load_module(package / "metrics" / f"{name}.py")


def all_files(bench: dict, root: Path = ROOT, package: Path = PACKAGE) -> Dict[str, List[Path]]:
    """Every file the benchmark's names resolve to, by kind."""
    files = {"configs": [root / c["file"] for c in bench["configs"]],
             "traffic": [], "runners": [], "families": [], "limits": [], "metrics": []}
    for w in bench["workloads"]:
        traffic = package / "traffic" / f"{w['traffic']}.json"
        files["traffic"].append(traffic)
        files["limits"].append(package / "limits" / f"{w['name']}.json")
        if traffic.is_file():
            files["runners"].append(PACKAGE / "runners" / f"{load_json(traffic)['runner']}.py")
    for c in bench["configs"]:
        path = root / c["file"]
        if path.is_file():
            files["families"].append(PACKAGE / "families" / f"{load_json(path)['family']}.py")
    files["metrics"] = [package / "metrics" / f"{m['name']}.py" for m in bench["per_layer"]]
    return files
