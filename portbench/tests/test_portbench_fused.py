"""The ``octet50fused.descent`` cell's own pieces: the fused kernels' bytes
and operations (``harness/roofline_fused.py``) against the program's
``FusedSmoother.work`` at 3^3, the readers of B3's, B4's and B5's
rooflines and of the fused launch path on readings made by hand (None
where they find nothing, or where the counted launches and the trace's
events disagree), the cell's resolution, and a traced run of it at 3^3 on
the CPU profiler."""

import math
import time

import pytest
import torch

from portbench.harness import core, roofline, roofline_fused as rf, spec
from portbench.reference import octet_beams
from pylatticedso_tpu_torch.utils.timing import timing
from test_portbench_spans import _CpuTrace, _registry

CELL = "octet50fused.descent"
KIND = "NVIDIA H100 80GB HBM3"
NEW = ["b3_roofline", "b4_roofline", "b5_roofline",
       "fused_launch_ms_per_cg_iter"]
SEED = 2 ** 31 + 1291
CLASSES, TYPES = len(octet_beams.node_classes()), octet_beams.strut_types()


def _reader(name):
    return spec.resolve(CELL).reader(name)


def test_cell_resolves():
    cell = spec.resolve(CELL)
    assert cell.entry["chips"] == 1 and cell.config["name"] == "octet50fused"
    assert cell.config["solver"]["mg"]["fused"] is True
    assert cell.config["solver"]["fused_storage"] == "bfloat16"
    assert cell.traffic == spec.resolve("octet100.descent").traffic
    assert {m["name"] for m in cell.end_to_end} == {"step_s", "setup_s"}
    layer = {m["name"] for m in cell.per_layer}
    shared = {m["name"] for m in spec.resolve("octet100.descent").per_layer}
    assert set(NEW) <= layer
    assert layer - set(NEW) == shared - {"coarse_graph_share"}
    assert hasattr(cell.system(), "System") and hasattr(cell.system(), "View")


@pytest.fixture(scope="module")
def smoother():
    from pylatticedso_tpu_torch.parallel.structured import StructuredLattice
    sl = StructuredLattice("Octet", (3,) * 3, (1.0,) * 3, 1013.0, 0.3,
                           dtype=torch.float32, device="cpu")
    fz = sl.make_matvec()[0].apply.fused
    assert (fz.nc, fz.n_e, fz.mv.n_sides) == (CLASSES, TYPES, 2 * TYPES)
    return fz


@pytest.mark.parametrize("itemsize", [2, 4])
def test_work_equals_the_programs(smoother, itemsize):
    g = smoother.grid
    assert rf.residual_work(g, CLASSES, TYPES, itemsize) == \
        smoother.work("residual", itemsize)
    for final in (False, True):
        assert rf.cheb_run_work(g, CLASSES, TYPES, final, itemsize) == \
            smoother.work("cheb_run", itemsize, final=final)
    for degree in (1, 2, 24):
        for x0 in (False, True):
            assert rf.cheb_full_work(g, CLASSES, TYPES, degree, x0,
                                     itemsize) == \
                smoother.work("cheb_full", itemsize, degree=degree,
                              with_x0=x0)


GRIDS = [(51, 51, 51), (26, 26, 26), (8, 8, 8)]


def _bound(work):
    return roofline.bound_s(work, roofline.peaks(KIND))


def _readings():
    """Two traced CG iterations' launches and a trace whose kernels each
    take four times their bound: every share reads 25%."""
    B3, B4, B4f = [2, 2, 2], [0, 2, 0], [2, 2, 0]
    B5 = [{"level": 2, "grid": list(GRIDS[2]), "degree": 2,
           "with_x0": x0, "launches": 2} for x0 in (False, True)]
    b3 = sum(n * _bound(rf.residual_work(g, CLASSES, TYPES))
             for n, g in zip(B3, GRIDS))
    b4m = sum(n * _bound(rf.cheb_run_work(g, CLASSES, TYPES, False))
              for n, g in zip(B4, GRIDS))
    b4f = sum(n * _bound(rf.cheb_run_work(g, CLASSES, TYPES, True))
              for n, g in zip(B4f, GRIDS))
    b5 = [2 * _bound(rf.cheb_full_work(GRIDS[2], CLASSES, TYPES, 2, x0))
          for x0 in (False, True)]
    bf = rf.BF16
    by_name = {
        f"mg_residual_kernel<{bf}, false>(x)": [4 * b3, 6],
        f"mg_residual_kernel<{bf}, true>(x)": [1.0, 3],
        f"mg_cheb_run_kernel<{bf}, false, false>(x)": [4 * b4m, 2],
        f"mg_cheb_run_kernel<{bf}, true, false>(x)": [4 * b4f, 4],
        f"mg_cheb_full_kernel<{bf}, false, 0>(x)": [4 * b5[0], 2],
        f"mg_cheb_full_kernel<{bf}, true, 1>(x)": [4 * b5[1], 2],
        f"mg_cheb_full_dense_kernel<{bf}, true, 1>(x)": [1.0, 7],
        "elementwise": [0.1, 100]}
    tr = {"busy_s": 0.5, "wall_s": 2.0, "events": 126, "iterations": 2,
          "steps": 1, "by_name": by_name,
          "launches": {"B1": [4, 0, 0], "grids": GRIDS, "B3": B3, "B4": B4,
                       "B4_final": B4f, "B5": B5}}
    return {"steps": [], "trace": tr, "kind": KIND,
            "reference": octet_beams}


@pytest.mark.parametrize("name", NEW[:3])
def test_rooflines(name):
    assert _reader(name).read(_readings()) == pytest.approx(25.0)


@pytest.mark.parametrize("name", NEW[:3])
def test_rooflines_read_nothing(name):
    read = _reader(name).read
    r = _readings()
    # no trace; a card not in the peaks' table; a program without the B4
    # split, whose system reports B1's launches alone
    assert read(dict(r, trace=None)) is None
    assert read(dict(r, kind="cpu")) is None
    old = dict(r["trace"], launches={"B1": [4, 0, 0], "grids": GRIDS})
    assert read(dict(r, trace=old)) is None
    # counts that differ from the trace's events
    tr = r["trace"]
    key = {"b3_roofline": "B3", "b4_roofline": "B4_final",
           "b5_roofline": "B5"}[name]
    bad = dict(tr["launches"])
    bad[key] = [dict(s, launches=3) for s in bad[key]] if key == "B5" \
        else [n + 1 for n in bad[key]]
    assert read(dict(r, trace=dict(tr, launches=bad))) is None


def test_b4_split_is_checked():
    """B4's middle steps and final emits are held to their own events: the
    same total split otherwise reads nothing."""
    r = _readings()
    tr = r["trace"]
    moved = dict(tr["launches"], B4=[0, 3, 0], B4_final=[2, 1, 0])
    assert _reader("b4_roofline").read(dict(r, trace=dict(
        tr, launches=moved))) is None


def test_fused_launch_ms():
    read = _reader("fused_launch_ms_per_cg_iter").read
    r = {"steps": [], "trace": {"iterations": 40, "steps": 2}}
    t = _registry({"mg.fused.b3": (20.0, 80), "mg.fused.b4": (30.0, 120),
                   "mg.fused.b5": (10.0, 160), "mg.level.0": (200.0, 40)})
    assert read(r, t) == pytest.approx(1.5)
    assert read(r, _registry({"mg.fused.b5": (4.0, 8)})) == \
        pytest.approx(0.1)
    # the cycle replayed its graph in every traced application: no launch
    # span, 0
    assert read(r, _registry({"mg.level.0": (200.0, 40),
                              "mg.graph.replay": (8.0, 40)})) == 0.0
    # no spans (a program without them, or no profiler session); no trace
    assert read(r, _registry({"mg.level.0": (200.0, 40)})) is None
    assert read({"steps": [], "trace": None}, t) is None


def test_traced_run(monkeypatch):
    """The cell at 3^3 (one level, its smoother B5's plain version) through
    the harness's traced run: correct, every span reader that has spans to
    read finite; the kernels' readers read nothing (no CUDA launch)."""
    monkeypatch.setattr(core, "DeviceTrace", _CpuTrace)
    cell = spec.resolve(CELL)
    cell.config["lattice"]["cells"] = 3
    notes = {}
    timing.reset()
    try:
        out = core.run(cell, SEED, 0.5, True, torch.device("cpu"),
                       time.perf_counter(), notes.update)
    finally:
        timing.reset()
    assert out["correct"], out["checks"]
    assert notes["traced_launches"]["B4_final"] == [0]
    for m in cell.per_layer:
        if m["source"] == "program_span" and m["name"] not in NEW:
            v = out["metrics"][m["name"]]["value"]
            assert math.isfinite(v) and v >= 0, m["name"]
    assert not set(NEW) & set(out["metrics"])
