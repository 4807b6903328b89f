"""Resolution of a cell by name: its entry in ``BENCHMARK.json``, its
configuration's file, its traffic mix's file, its own file of limits and
parameters, its metrics and the modules that read them.  Everything is
found by name, so a configuration, a mix, a metric or a cell is added as
files and entries, with no file here edited:

* ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives), whose
  ``system`` names ``systems/<system>.py`` and whose ``reference`` names
  ``reference/<reference>.py``;
* ``traffic/<traffic>.json``, read by ``harness/traffic.py``;
* ``cells/<cell>.json``: the limits of the numbers compared and the cell's
  trace and sample counts;
* ``metrics/<metric>.py`` for each metric, with a ``read``; a metric
  ``<base>.<part>`` (one quantity split by the end-to-end metric that its
  cells report) without a file of its own is read by ``metrics/<base>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

__all__ = ["Cell", "resolve", "load_module", "BENCH_DIR", "ROOT"]


@dataclass
class Cell:
    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    params: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path
    modules: Dict[str, ModuleType] = field(default_factory=dict)

    @property
    def bench_dir(self) -> Path:
        return self.root / BENCH_DIR.name

    def system(self) -> ModuleType:
        return self._module("systems", self.config["system"])

    def reference(self) -> ModuleType:
        return self._module("reference", self.config["reference"])

    def reader(self, metric: str) -> ModuleType:
        own = self.bench_dir / "metrics" / f"{metric}.py"
        if not own.is_file() and "." in metric:
            metric = metric.split(".")[0]
        return self._module("metrics", metric)

    def _module(self, kind: str, name: str) -> ModuleType:
        key = f"{kind}/{name}"
        if key not in self.modules:
            self.modules[key] = load_module(
                self.bench_dir / kind / f"{name}.py",
                f"{BENCH_DIR.name}_{kind}_{name.replace('.', '_')}")
        return self.modules[key]


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file at ``path`` as module ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read."""
    bench = _json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[entry["config"]]
    bdir = root / BENCH_DIR.name
    return Cell(
        name=name, entry=entry, config=_json(root / conf["file"]),
        traffic=_json(bdir / "traffic" / f"{entry['traffic']}.json"),
        params=_json(bdir / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root)
