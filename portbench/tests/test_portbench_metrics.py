"""The per-layer readers and the trace's sums on readings made by hand: each
returns nothing where it finds nothing to read, and B1's roofline is the
yardstick's bound over the kernel's time."""

import pytest

from portbench.harness import roofline, spec
from portbench.harness.trace import DeviceTrace
from portbench.reference import octet_beams

READERS = ["cg_iters_per_step", "refresh_ms", "device_events_per_cg_iter",
           "b1_roofline", "device_ms_per_cg_iter", "idle_share"]
KIND = "NVIDIA H100 80GB HBM3"


def _reader(name):
    return spec.resolve("octet100.descent").reader(name)



def _readings(trace=True):
    grids = [(101, 101, 101), (51, 51, 51)]
    work = [roofline.stencil_work(g, 4, 24) for g in grids]
    bound = sum(roofline.bound_s(w, roofline.peaks(KIND)) for w in work)
    tr = {"busy_s": 0.5, "wall_s": 2.0, "events": 3000, "iterations": 2,
          "by_name": {"stencil_matvec_kernel<float, float, int2>(x)":
                      [4.0 * bound, 2],
                      "stencil_matvec_kernel<double, double>(x)": [1.0, 5],
                      "elementwise": [0.1, 2993]},
          "launches": {"B1": [1, 1], "grids": grids}}
    return {"steps": [{"iterations": 30}, {"iterations": 40}],
            "refresh_ms": [100.0, 300.0], "trace": tr if trace else None,
            "kind": KIND, "reference": octet_beams}


def test_values():
    r = _readings()
    r["window_s"], r["setup_s"] = 50.0, 12.5
    assert _reader("step_s").read(r) == 25.0
    assert _reader("step_s.edge").read(r) == 25.0
    assert _reader("setup_s").read(r) == 12.5
    for name in ("cg_iters_per_step", "device_events_per_cg_iter",
                 "device_ms_per_cg_iter", "idle_share"):
        assert _reader(name + ".edge").read(r) == _reader(name).read(r)
    assert _reader("cg_iters_per_step").read(r) == 35
    assert _reader("refresh_ms").read(r) == 200
    assert _reader("device_events_per_cg_iter").read(r) == 1500
    assert _reader("device_ms_per_cg_iter").read(r) == 250
    assert _reader("idle_share").read(r) == 75
    assert _reader("b1_roofline").read(r) == pytest.approx(25.0)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name):
    r = _readings(trace=False)
    r["steps"], r["refresh_ms"] = [], []
    assert _reader(name).read(r) is None


def test_roofline_silent_when_launches_disagree():
    r = _readings()
    r["trace"]["launches"]["B1"] = [1, 2]
    assert _reader("b1_roofline").read(r) is None
    r = _readings()
    r["kind"] = "some other card"
    assert _reader("b1_roofline").read(r) is None


def test_b1_bound_at_50():
    # the port's own count at 51^3 (PERF.md's kernel table: 0.01233 ms)
    nbytes, ops = roofline.stencil_work((51, 51, 51), 4, 24)
    assert 1e3 * roofline.bound_s((nbytes, ops), roofline.PEAKS["H100"]) \
        == pytest.approx(0.01233, abs=1e-5)


class _Ev:
    def __init__(self, s, e, name):
        self.s, self.e, self.n = s, e, name

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s

    def name(self):
        return self.n


def test_trace_union_and_gaps():
    tr = DeviceTrace(device=None)
    evs = [_Ev(0, 100, "a"), _Ev(50, 150, "b"), _Ev(300, 400, "c"),
           _Ev(350, 380, "d"), _Ev(1000, 1100, "a")]

    class _P:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return evs
    tr.prof = _P
    tr.wall_s = 2e-6
    s = tr.summary()
    assert s["busy_s"] == pytest.approx(350e-9)
    assert s["events"] == 5
    assert s["by_name"]["a"] == [pytest.approx(200e-9), 2]
    assert s["idle_gaps"][0] == ["c -> a", pytest.approx(600e-9)]
    assert s["idle_gaps"][1] == ["b -> c", pytest.approx(150e-9)]
