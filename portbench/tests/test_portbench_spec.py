"""Every cell resolves its configuration, traffic, limits, metrics and
modules by name, and a configuration, a mix, a metric or a cell added as new
files in a copy is found with no file edited."""

import json
import shutil

import pytest

from portbench.harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    cell = spec.resolve(name)
    assert cell.config["name"] == cell.entry["config"]
    assert hasattr(cell.system(), "System")
    assert hasattr(cell.reference(), "OctetLattice")
    assert {"res", "c_gap", "g_gap"} <= set(cell.params["limits"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) == 2
    assert cell.per_layer
    for m in cell.per_layer + cell.end_to_end:
        assert callable(cell.reader(m["name"]).read)
    # each per-layer metric moves an end-to-end metric this cell reports
    assert {m["moves"] for m in cell.per_layer} <= e2e


def test_contract_shape():
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert json.loads((spec.ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = [m["name"] for m in BENCH["per_layer"] + BENCH["end_to_end"]]
    # a metric's own reader, or its base's where a quantity is split
    assert all((spec.BENCH_DIR / "metrics" / f"{n}.py").is_file()
               or (spec.BENCH_DIR / "metrics" / f"{n.split('.')[0]}.py")
               .is_file() for n in names)


def test_added_files_are_found(tmp_path):
    root = tmp_path / "copy"
    shutil.copytree(spec.BENCH_DIR, root / spec.BENCH_DIR.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bdir = root / spec.BENCH_DIR.name
    # a new configuration, a new mix, a new metric and a new cell: files
    # and entries only
    conf = json.loads((bdir / "configs" / "edge50.json").read_text())
    conf.update(name="edge40", lattice=dict(conf["lattice"], cells=40))
    (bdir / "configs" / "edge40.json").write_text(json.dumps(conf))
    mix = json.loads((bdir / "traffic" / "descent.json").read_text())
    mix["step0"] = 0.02
    (bdir / "traffic" / "creep.json").write_text(json.dumps(mix))
    (bdir / "metrics" / "steps_in_window.py").write_text(
        "def read(readings):\n    return float(len(readings['steps']))\n")
    (bdir / "cells" / "edge40.creep.json").write_text(
        (bdir / "cells" / "edge50.descent.json").read_text())
    bench["configs"].append({"name": "edge40", "source": "x",
                             "file": "portbench/configs/edge40.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "edge40.creep", "config": "edge40",
                               "traffic": "creep", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "solver", "moves": "step_s",
                               "workloads": ["edge40.creep"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("edge40.creep", root)
    assert cell.config["lattice"]["cells"] == 40
    assert cell.traffic["step0"] == 0.02
    assert "steps_in_window" in [m["name"] for m in cell.per_layer]
    assert cell.reader("steps_in_window").read({"steps": [1, 2]}) == 2.0
    assert cell.system().__file__.startswith(str(root))
    with pytest.raises(KeyError):
        spec.resolve("no.such.cell", root)
