"""The readers of the program's spans: their arithmetic on a registry and
readings filled by hand, None where the spans are absent, and a traced run
of every cell at 3^3 on the CPU profiler (the harness's CUDA trace swapped
for a CPU one), where each reads a finite number and the ``sync`` spans
count the traced CG iterations and one more per ``pcg`` call."""

import math
import time

import pytest
import torch

from portbench.harness import core, spec
from portbench.harness.trace import DeviceTrace
from pylatticedso_tpu_torch.utils.timing import Timing, timing

SPAN_READERS = ["dispatch_ms_per_cg_iter", "sync_wait_ms_per_cg_iter",
                "vcycle_dispatch_ms_per_cg_iter",
                "coarse_dispatch_ms_per_cg_iter", "outside_cg_ms_per_step",
                "state_dispatch_ms"]
CELLS = ["octet100.descent", "edge50.descent", "octet100.explore"]
SEED = 2 ** 31 + 977


def _reader(name):
    return spec.resolve("octet100.explore").reader(name)


def _registry(ms_counts):
    t = Timing()
    for name, (ms, n) in ms_counts.items():
        t._total[name] = int(ms * 1e6)
        t._counts[name] = n
    return t


def _readings(iterations=40, steps=2):
    return {"steps": [], "trace": {"iterations": iterations,
                                   "steps": steps}}


def test_values():
    t = _registry({"step": (1000.0, 2), "pcg": (800.0, 2),
                   "sync": (40.0, 42), "sync.step": (2.0, 2),
                   "mg.level.0": (600.0, 40),
                   "mg.level.1": (450.0, 40), "mg.state": (150.0, 1)})
    r = _readings()
    want = {"dispatch_ms_per_cg_iter": 19.0,
            "sync_wait_ms_per_cg_iter": 1.05,
            "vcycle_dispatch_ms_per_cg_iter": 15.0,
            "coarse_dispatch_ms_per_cg_iter": 11.25,
            "outside_cg_ms_per_step": 100.0,
            "state_dispatch_ms": 150.0}
    for name, v in want.items():
        assert _reader(name).read(r, t) == pytest.approx(v)
    for name in ("dispatch_ms_per_cg_iter", "sync_wait_ms_per_cg_iter",
                 "outside_cg_ms_per_step"):
        assert _reader(name + ".edge").read(r, t) == \
            _reader(name).read(r, t)
    # one level: nothing below the fine one
    one = _registry({"pcg": (800.0, 2), "mg.level.0": (600.0, 40)})
    assert _reader("coarse_dispatch_ms_per_cg_iter").read(r, one) == 0.0


@pytest.mark.parametrize("name", SPAN_READERS)
def test_nothing_to_read(name):
    # no spans (a program without them, or no profiler session)
    assert _reader(name).read(_readings(), Timing()) is None
    # spans but no trace
    t = _registry({"step": (1.0, 1), "pcg": (1.0, 1), "sync": (1.0, 2),
                   "mg.level.0": (1.0, 1), "mg.state": (1.0, 1)})
    assert _reader(name).read({"steps": [], "trace": None}, t) is None


class _CpuTrace(DeviceTrace):
    """The harness's trace with CPU activity: a profiler session, so the
    program's spans record, and no CUDA call."""

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.prof.__enter__()
        self._t = time.perf_counter()

    def stop(self):
        self.wall_s = time.perf_counter() - self._t
        self.prof.__exit__(None, None, None)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_every_span_metric(name, monkeypatch):
    monkeypatch.setattr(core, "DeviceTrace", _CpuTrace)
    cell = spec.resolve(name)
    cell.config["lattice"]["cells"] = 3
    notes = {}
    timing.reset()
    try:
        out = core.run(cell, SEED, 0.5, True, torch.device("cpu"),
                       time.perf_counter(), notes.update)
        counts = {n: timing.count(n)
                  for n in ("step", "pcg", "sync", "sync.step")}
    finally:
        timing.reset()
    assert out["correct"], out["checks"]
    listed = [m["name"] for m in cell.per_layer
              if m["source"] == "program_span"]
    assert listed
    for m in listed:
        v = out["metrics"][m]["value"]
        assert math.isfinite(v) and v >= 0, (m, v)
    t_from, t_n = cell.params["trace_from"], notes["traced_steps"]
    traced_iters = sum(notes["cg_iterations"][t_from:t_from + t_n])
    assert counts["step"] == t_n
    assert counts["sync"] == traced_iters + counts["pcg"]
    # the edge step also reads its residual once a step, outside pcg
    assert counts["sync.step"] == (t_n if name.startswith("edge") else 0)
