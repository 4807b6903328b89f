"""Rehearsal of ``chip_smoke.py``'s mesh phase on the CPU at
``smoke_mesh.SMALL``: (m1)-(m3) and the per-slab kernel checks run their
control flow on the plain versions over virtual meshes of CPU devices
(nothing is timed as a device number), their gates hold, the ``kernels``
entries take the per-slab launches, and the gates fail loudly when what
they check is broken."""

import pytest
import torch

from pylatticedso_tpu_torch import smoke_mesh as sm
from pylatticedso_tpu_torch.kernels.stencil import StencilMatvec

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def rep():
    return sm.mesh_phase(CPU, sm.SMALL, log=lambda s: None)


def test_m1_rehearses(rep):
    m1 = rep["m1"]
    assert m1["n"] == 3 and m1["bitwise"] and m1["finite"]
    assert len(m1["errors"]) == 1 + sm.SMALL["m1_warm"]
    for c, g in m1["errors"] + m1["batch_errors"]:
        assert c <= sm.C_TOL and g <= sm.G_TOL
    assert m1["cold_iterations"] == m1["reference_cold_iterations"]
    assert callable(m1["profile_drive"])


def test_m2_rehearses(rep):
    m2 = rep["m2"]
    assert set(m2["routes"]) == set(sm.M2_ROUTES)
    for route, r in m2["routes"].items():
        assert r["grid_axis"] == 0 and r["slabs"] == [[2, 5, 5]] * 4
        assert r["bitwise"] and r["finite"]
        assert r["errors"] and all(c <= sm.C_TOL and g <= sm.G_TOL
                                   for c, g in r["errors"])
        # no kernel on the CPU: nothing counted
        assert r["launches"] == {"per_slab": {}, "gathered": {}}
        assert "runner" not in r
    assert m2["routes"]["f32"]["sharded_levels"] == 1
    # the profiled drives: the sharded step and the one-device step from
    # the same cold solution, the same CG iterations
    r = m2["routes"]["f32"]
    assert r["profile_drive"](0) == r["one_device"]["profile_drive"](0) > 0


def test_m3_rehearses(rep):
    m3 = rep["m3"]
    assert m3["dryrun"]["mesh"] == {"dp": 2, "shard": 4}
    for phase in ("unstructured", "structured", "hybrid", "mg"):
        assert m3["dryrun"][phase]["rel"] < 1e-4
    for c, g in m3["bcc_f64"]["errors"]:
        assert c <= sm.C64_TOL and g <= sm.G64_TOL
    assert m3["lo"]["sharded_levels"] == m3["warped"]["sharded_levels"] == 1


def test_slab_kernels_rehearse(rep):
    kinds = [c["kernel"] for c in rep["kernels"]]
    assert kinds == ["B1"] * 4 + ["B3"] * 4 + ["B4"] * 4 + ["B1f64"] * 4 \
        + ["B2"] * 4 + ["B1w"] * 4
    for c in rep["kernels"]:
        assert c["max_rel_err"] == 0.0 and c["same_bits"] and c["ms"] is None
    assert [c["gathered_bits_differ"] for c in rep["kernels"]
            if "gathered_bits_differ" in c] == [0, 0, 0]


def test_annotate_kernels(rep):
    entries = [{"name": StencilMatvec.name, "launches": 5,
                "max_abs_err": 0.0, "max_rel_err": 0.0, "cases": []}]
    fake = dict(rep, m2={"routes": {"f32": {"launches": {
        "per_slab": {"B1": [3, 3, 3, 2]}, "gathered": {}}}}},
        m3={k: {"launches": {"per_slab": {}, "gathered": {}}}
            for k in ("bcc_f64", "lo", "warped")})
    out = sm.annotate_kernels(entries, fake)[0]
    assert out["launches"] == 16 and out["launches_per_slab"] == [3, 3, 3, 2]
    assert out["launches_mesh"] == {"(m2) f32": [3, 3, 3, 2]}
    assert [c["case"] for c in out["cases"]][:1] == \
        ["(m2) f32 fine level slab 0"]


def test_log_lines(rep):
    lines = []
    sm.log_mesh(rep, "CPU rehearsal", lines.append)
    assert lines[0].startswith("mesh (m1) bench.py's second mode 3^3")
    assert sum(line.startswith("mesh (m2)") for line in lines) == 2
    assert lines[-1].startswith("mesh phase")
    assert all("[CPU rehearsal]" in line for line in lines)


def test_gates_fail_loudly(monkeypatch):
    with pytest.raises(AssertionError, match="B3 not launched"):
        sm._check_launches("(m2)", {"per_slab": {"B3": [1, 1, 0, 1]}},
                           ["B3"], True)
    bad = {"errors": [(0.0, 2e-3)], "bitwise": True, "finite": True}
    with pytest.raises(AssertionError, match="sharded against one device"):
        sm._gate("(m2)", bad, sm.C_TOL, sm.G_TOL)
    with pytest.raises(AssertionError, match="differs in its bits"):
        sm._gate("(m2)", dict(bad, bitwise=False), sm.C_TOL, sm.G_TOL)
    monkeypatch.setattr(sm, "C_TOL", -1.0)
    with pytest.raises(AssertionError, match=r"\(m1\): sharded"):
        sm.m1_phase(CPU, 2, 1, 2)
