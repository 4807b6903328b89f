"""The port's timing registry (``pylatticedso_tpu_torch.utils.timing``):
hot spans record only under ``torch.profiler`` and on its clock, the
spans of the design step (``step``, ``pcg``, ``sync``, ``mg.level.<k>``,
``mg.state``) nest and add up, the timeline is bounded, idle gaps are
named by the span open on the host, and the coarse phases count as
before."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.fem.bc import apply_boundary_conditions
from pylatticedso_tpu_torch.fem.solve import pcg
from pylatticedso_tpu_torch.parallel import multigrid as mg
from pylatticedso_tpu_torch.parallel.sharding import (
    ShardedLattice, make_compliance_step, make_mesh)
from pylatticedso_tpu_torch.parallel.structured import (
    StructuredLattice, make_structured_compliance_step)
from pylatticedso_tpu_torch.utils import timing as timing_mod
from pylatticedso_tpu_torch.utils.timing import (Timing, name_idle_gaps,
                                                 timing)

torch.set_num_threads(1)

MG = {"nu": (1, 2), "coarse_degree": 24, "smooth_frac": 0.35,
      "power_iters": 5, "fused": False, "lo_smoother": False}


@pytest.fixture(autouse=True)
def _fresh():
    timing.reset()
    yield
    timing.reset()


def _records(name):
    return [(t0, t1) for n, t0, t1 in timing.timeline() if n == name]


def _inside(inner, outer):
    """Every interval of ``inner`` lies in one of ``outer``."""
    return all(any(o0 <= t0 <= t1 <= o1 for o0, o1 in outer)
               for t0, t1 in inner)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _spd(n=40, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, n))
    A = torch.tensor(q @ q.T + n * np.eye(n))
    b = torch.tensor(rng.standard_normal(n))
    return (lambda x: A @ x), b


def _structured(n, geom="Octet"):
    sl = StructuredLattice(geom, (n,) * 3, (1.0,) * 3, 1013.0, 0.3,
                           kappa=0.9, dtype=torch.float64, device="cpu")
    fixed = sl.select_nodes(lambda x, y, z: z == 0.0)
    top = sl.select_nodes(lambda x, y, z: z == float(n))
    free = sl.node_valid & ~fixed
    f = np.zeros((sl.nc, 6) + sl.grid)
    f[:, 2][top] = -1.0 / top.sum()
    step = make_structured_compliance_step(sl, free, f, tol=1e-8,
                                           maxiter=500, precond="mg",
                                           mg_opts=dict(MG))
    r = 0.05 + 0.01 * torch.rand((n,) * 3, dtype=torch.float64,
                                 generator=torch.Generator().manual_seed(3))
    return step, r


def test_spans_record_only_under_the_profiler():
    A, b = _spd()
    pcg(A, b, tol=1e-10)
    assert timing.count("pcg") == 0 and timing.count("sync") == 0
    assert timing.timeline() == []
    timing.timed("outside", abs)(-1)
    timing.spanned("outside")(abs)(-1)
    assert timing.count("outside") == 0
    # off: the function itself, nothing allocated per call
    assert timing.timed("a", abs) is abs
    _profiled(lambda: pcg(A, b, tol=1e-10))
    assert timing.count("pcg") == 1 and timing.total("pcg") > 0


def test_pcg_records_one_pcg_and_a_sync_per_iteration_and_one():
    A, b = _spd()
    res, _ = _profiled(lambda: pcg(A, b, tol=1e-10))
    assert res.converged and res.iterations > 3
    assert timing.count("pcg") == 1
    assert timing.count("sync") == res.iterations + 1
    assert timing.total("sync") <= timing.total("pcg")
    assert _inside(_records("sync"), _records("pcg"))


def test_span_and_kineto_records_share_a_clock():
    a = torch.randn(300, 300)

    def run():
        for _ in range(5):
            timing.timed("matmul", torch.mm)(a, a)
    _, prof = _profiled(run)
    spans = _records("matmul")
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(spans) == len(ops) == 5
    for (t0, t1), (s, e) in zip(spans, ops):
        assert t0 <= s <= e <= t1


def test_structured_step_spans_nest_and_add_up():
    step, r = _structured(4)
    nL = len(step.hierarchy["levels"])
    assert nL == 2
    state, _ = _profiled(lambda: step.precond_state(r))
    (c, g, u), _ = _profiled(lambda: step(r, None, state))
    it = step.last_solve["iterations"]
    assert it > 0 and bool(torch.isfinite(c))
    names = set(timing._counts)
    assert names == {"mg.state", "step", "pcg", "sync"} | {
        f"mg.level.{k}" for k in range(nL)}
    assert timing.count("step") == timing.count("pcg") == 1
    assert timing.count("mg.state") == 1
    assert timing.count("sync") == it + 1
    # one visit of every level a V-cycle: one before CG, one an iteration
    # but the last
    for k in range(nL):
        assert timing.count(f"mg.level.{k}") == it
    lv0, lv1 = timing.total("mg.level.0"), timing.total("mg.level.1")
    assert lv1 <= lv0 <= timing.total("pcg") <= timing.total("step")
    assert timing.total("sync") <= timing.total("pcg")
    # self totals add up to the roots' inclusive totals, to the nanosecond
    assert sum(timing._self.values()) == \
        timing._total["step"] + timing._total["mg.state"]
    assert timing._total["pcg"] == timing._self["pcg"] + \
        timing._total["sync"] + timing._total["mg.level.0"]
    assert timing._total["step"] == timing._self["step"] + \
        timing._total["pcg"]
    # on the timeline: every span in the one it is counted under
    assert _inside(_records("pcg"), _records("step"))
    assert _inside(_records("sync"), _records("pcg"))
    assert _inside(_records("mg.level.0"), _records("pcg"))
    assert _inside(_records("mg.level.1"), _records("mg.level.0"))
    assert timing.timeline()[-1][0] == "step"


def test_fused_vcycle_emits_the_same_names():
    sl = StructuredLattice("BCC", (4,) * 3, (1.0,) * 3, 1013.0, 0.3,
                           dtype=torch.float32, device="cpu")
    fixed = sl.select_nodes(lambda x, y, z: z == 0.0)
    free = np.broadcast_to((sl.node_valid & ~fixed)[:, None],
                           (sl.nc, 6) + sl.grid)
    h = mg.build_mg_hierarchy(sl, free)
    r = torch.full((4,) * 3, 0.05)
    st = mg.mg_precond_state(h, r, power_iters=3, fused=True)
    v = torch.ones((sl.nc, 6) + sl.grid) * h["levels"][0].free
    seen = {}
    for fused in (False, True):
        timing.reset()
        _profiled(lambda: mg.mg_apply(h, st, fused=fused)(v))
        seen[fused] = [n for n, _, _ in timing.timeline()]
        for k in range(1, len(h["levels"])):
            assert _inside(_records(f"mg.level.{k}"),
                           _records(f"mg.level.{k - 1}"))
    want = [f"mg.level.{k}" for k in reversed(range(len(h["levels"])))]
    assert seen[False] == seen[True] == want


def test_edge_step_syncs():
    cfg = {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                        "number_of_cells": {"x": 2, "y": 2, "z": 2},
                        "radii": [0.05], "geom_types": ["Octet"]},
           "boundary_conditions": {
               "Displacement": {"Fixed": {
                   "Surface": ["Zmin"],
                   "DOF": ["X", "Y", "Z", "RX", "RY", "RZ"],
                   "Value": [0, 0, 0, 0, 0, 0]}},
               "Force": {"Load": {"Surface": ["Zmax"], "DOF": ["Z"],
                                  "Value": [-1.0]}}}}
    lat = build_lattice(cfg)
    bc = apply_boundary_conditions(lat)
    shl = ShardedLattice(make_mesh(devices=["cpu"]), lat.nodes, lat.edges,
                         1013.0, 0.3, dtype=torch.float64)
    step = make_compliance_step(shl, ~bc.fixed, bc.f_applied, tol=1e-8,
                                maxiter=1000)
    r = shl.radius_padded(lat.radius)
    _profiled(lambda: step.chunked(r, chunk=8))
    ch = step.chunked
    calls = timing.count("pcg")
    assert ch.last_converged and calls > 1
    assert timing.count("step") == 1
    # every pcg call: one sync before its loop and one an iteration; the
    # step's read of the residual, outside pcg, is sync.step
    assert timing.count("sync") == ch.last_iterations + calls
    assert timing.count("sync.step") == 1
    assert _inside(_records("sync"), _records("pcg"))
    assert not _inside(_records("sync.step"), _records("pcg"))
    assert _inside(_records("sync.step"), _records("step"))
    assert timing.total("sync") <= timing.total("pcg") <= \
        timing.total("step")


def test_timeline_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setattr(timing_mod, "CAPACITY", 4)
    t = Timing()

    def run():
        for k in range(10):
            t.timed(f"s{k}", abs)(-k)
    _profiled(run)
    assert [r[0] for r in t.timeline()] == ["s6", "s7", "s8", "s9"]
    assert t.dropped == 6
    assert sum(t.count(f"s{k}") for k in range(10)) == 10
    t.reset()
    assert t.timeline() == [] and t.dropped == 0


def test_idle_gaps_are_named_by_the_open_span():
    # host: step [0, 100) holding pcg [10, 90) holding sync [40, 60)
    timeline = [("sync", 40, 60), ("pcg", 10, 90), ("step", 0, 100)]
    # device: busy [5, 20), [15, 30) (merged), [50, 55), [65, 70), [95, 98)
    # and [120, 130): gaps [30, 50), [55, 65), [70, 95), [98, 120)
    device = [(15, 30), (5, 20), (50, 55), (65, 70), (95, 98), (120, 130),
              (7, 7)]
    assert name_idle_gaps(device, timeline) == [
        (30, 50, "pcg", "sync"), (55, 65, "sync", "pcg"),
        (70, 95, "pcg", "step"), (98, 120, "step", None)]
    assert name_idle_gaps([], timeline) == []
    assert name_idle_gaps(device, []) == [
        (30, 50, None, None), (55, 65, None, None), (70, 95, None, None),
        (98, 120, None, None)]


def test_coarse_phases_count_as_before(capsys):
    t = Timing()

    @t.timeit(category="outer")
    def outer():
        inner()

    @t.timeit
    def inner():
        pass

    outer()
    outer()
    with t.phase("block", category="io"):
        inner()
    name_o = "test_coarse_phases_count_as_before.<locals>.outer"
    name_i = "test_coarse_phases_count_as_before.<locals>.inner"
    assert t.count(name_o) == 2 and t.count(name_i) == 3
    assert t.count("block") == 1
    assert 0 < t.self_total(name_o) <= t.total(name_o)
    # self times add up to the roots' (two outer calls and the block)
    assert sum(t._self.values()) == t._total[name_o] + t._total["block"]
    # no profiler: phases record, but nothing goes to the timeline
    assert t.timeline() == []
    out = t.summary()
    assert name_o in out and "outer" in out and "io" in out
    assert out in capsys.readouterr().out
    assert t.summary(pattern="block").count("\n") == 1
    t.reset()
    assert t.count(name_o) == 0 and t.total(name_o) == 0.0
