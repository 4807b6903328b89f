"""Rehearsal of ``chip_smoke.py``'s warped phase on the CPU at n = 4
(``smoke_warped.SMALL``): (w1)-(w3) run their control flow on the plain
versions (nothing is timed as a device number), their gates hold, the
``kernels`` entries of B1w and the warped r^2-cotangent are built, and
each gate fails loudly when what it checks is broken."""

import numpy as np
import pytest
import torch

from pylatticedso_tpu_torch import smoke_warped as sw
from pylatticedso_tpu_torch.kernels.stencil import StencilMatvec

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def rep():
    return sw.warped_phase(CPU, sw.SMALL)


def test_w1_rehearses(rep):
    w1 = rep["w1"]
    assert w1["n"] == 4 and w1["levels"] == [[4, 4, 4], [2, 2, 2]]
    assert w1["bitwise"] and w1["finite"]
    assert w1["c_rel_err"] <= sw.C_TOL and w1["g_rel_err"] <= sw.G_TOL
    assert len(w1["warm_s"]) == sw.SMALL["steps"]
    assert w1["cold_iterations"] > max(w1["warm_iterations"])
    assert "warped (node_transform)" in w1["fused_refusal"]
    # no kernel on the CPU: every counter read, all zero
    assert w1["kernel_launches"] == {
        k: [0, 0] for k in ("B1", "B1f64", "VJP", "B2", "B3", "B4", "B5",
                            "B3c", "B4c", "B5c", "B1w", "B1wf64", "VJPw")}


def test_warped_kernels_rehearse(rep):
    cases = rep["kernels"]
    # every MG grid, both storages, the matvec and the r^2-cotangent
    assert [(c["kernel"], c["storage"], c["level"]) for c in cases] == [
        (k, s, lvl) for s in ("f32", "f64") for lvl in (0, 1)
        for k in ("B1w", "VJPw")]
    for c in cases:
        assert c["max_rel_err"] == 0.0 and c["same_bits"]
        assert c["ms"] is None and c["device_ms"] is None      # no card
        assert c["bound_by"] == "bytes"
    fine = [c for c in cases if c["level"] == 0 and c["kernel"] == "B1w"]
    # float64 moves twice the bytes of float32, geometry rows included
    assert fine[1]["bytes"] == 2 * fine[0]["bytes"]


def test_kernel_entries(rep):
    entries = sw.kernel_entries(rep)
    assert [e["name"] for e in entries] == [
        StencilMatvec.name_w, StencilMatvec.name_w_f64,
        StencilMatvec.name_vjp_w]
    keys = {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"}
    for e in entries:
        assert keys <= set(e)
        assert e["route"] == "cuda" and e["library_ms"] is None
        assert e["source"] == "pylatticedso_tpu_torch/csrc/stencil_matvec.cu"
        assert e["replaces"] == "pylatticedso_tpu/parallel/stencil_pallas.py:88"
        assert e["launches"] == 0                                 # the CPU
    assert entries[0]["cases"][0]["case"].startswith("warped Octet 4^3")
    assert [c["case"] for c in entries[2]["cases"]][:2] == [
        "warped Octet 4^3 (MG level 0)", "warped Octet 2^3 (MG level 1)"]


def test_w2_rehearses(rep):
    w2 = rep["w2"]
    assert w2["routed"] == "StructuredOptimizationProblem"
    assert w2["cells"] == [6, 2, 2] and w2["maps"] == 2
    assert w2["objective"] < w2["feasible_start_objective"]
    assert w2["value_rel_err"] <= sw.W2_V_TOL
    assert w2["grad_rel_err"] <= sw.W2_G_TOL
    assert w2["plain_gather_calls"] == 0
    assert set(w2["kernel_launches"]) >= set(sw.WARPED_COUNTERS)


def test_w3_rehearses(rep):
    w3 = rep["w3"]
    assert w3["sdf_abs_err"] == 0.0 and w3["rho_rel_err"] == 0.0
    assert 0 < w3["rho_device"] < w3["rho_sum_of_cylinders"]
    assert w3["volume"] > 0 and w3["triangles"] > 0
    assert w3["chunk_bytes"] <= sw.solid_mesh.SDF_CHUNK_BYTES


def test_log_lines(rep):
    lines = []
    sw.log_warped(rep, "CPU rehearsal", lines.append)
    assert lines[0].startswith("warped (w1) 4^3 Octet")
    assert sum(line.startswith(("B1w warped", "VJPw warped"))
               for line in lines) == len(rep["kernels"])
    assert lines[-2].startswith("warped (w2)")
    assert lines[-1].startswith("warped (w3)")
    assert all("[CPU rehearsal]" in line for line in lines)


def test_launch_gate_fails_loudly():
    ok = {"B1w": [3, 1], "B1": [0, 0], "B2": [0, 0]}
    sw._launch_check("(w1)", ok, sw.W1_KERNELS)
    with pytest.raises(AssertionError, match="B1w launched 0 times"):
        sw._launch_check("(w1)", dict(ok, B1w=[3, 0]), sw.W1_KERNELS)
    with pytest.raises(AssertionError, match="B1 launched 2 times"):
        sw._launch_check("(w1)", dict(ok, B1=[2, 0]), sw.W1_KERNELS)


def test_w1_gates_fail_loudly(monkeypatch):
    monkeypatch.setattr(sw, "C_TOL", -1.0)
    with pytest.raises(AssertionError, match="vs f64"):
        sw.w1_phase(CPU, 2, 1)


def test_kernel_gate_fails_loudly(rep, monkeypatch):
    """A wrapper whose result is off by 1e-3 fails the kernel gate."""
    real = StencilMatvec.__call__

    def off(self, u, r2p):
        return real(self, u, r2p) * (1.0 + 1e-3)

    monkeypatch.setattr(StencilMatvec, "__call__", off)
    sl, free, f = sw._problem(2, CPU, torch.float32)
    from pylatticedso_tpu_torch.parallel.multigrid import build_mg_hierarchy
    h = build_mg_hierarchy(sl, free)
    with pytest.raises(AssertionError, match="B1w f32 .* rel err"):
        sw.warped_kernel_phase(CPU, {torch.float32: h})


def test_w2_gate_fails_loudly(monkeypatch):
    monkeypatch.setattr(sw, "W2_G_TOL", -1.0)
    with pytest.raises(AssertionError, match="structured vs unstructured"):
        sw.w2_phase(CPU, 1)


def test_w3_gate_fails_loudly(monkeypatch):
    monkeypatch.setattr(sw, "SDF_TOL", -1.0)
    with pytest.raises(AssertionError, match="SDF"):
        sw.w3_phase(CPU, 12, (1, 1, 1), 12)


def test_taper_twist_keeps_the_axis_and_the_bottom():
    w = sw.taper_twist(50)
    x, y, z = np.array([25.0, 30.0]), np.array([25.0, 25.0]), np.zeros(2)
    X, Y, Z = w(x, y, z)
    np.testing.assert_allclose(X, x)                # no twist at z = 0
    np.testing.assert_allclose(Y, y)
    np.testing.assert_allclose(Z, 0.1 * np.sin(x))
    X, Y, _Z = w(np.array([25.0]), np.array([25.0]), np.array([50.0]))
    np.testing.assert_allclose([X[0], Y[0]], [25.0, 25.0])   # the axis
