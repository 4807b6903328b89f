"""Rehearsal of chip_smoke.py on the CPU at n=4: the phases' control flow
only (every wrapper runs its plain version, nothing is timed as a device
number), and the script's refusals without a card or without the port."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pylatticedso_tpu_torch import smoke

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def test_phases_rehearse_on_cpu():
    lines = []
    rep = smoke.run(device="cpu", n=4, steps=2, windows=1,
                    log=lines.append)
    assert rep["device"]["platform"] == "cpu"
    assert [c["case"].split()[0] for c in rep["cases"]] == \
        ["Octet", "Octet", "BCC+Hybrid1+Hybrid4"]
    assert all(c["max_rel_err"] == 0.0 for c in rep["cases"])
    # B2-B5: every grid (the hybrid's coarse level too), both storages
    fc = rep["fused_cases"]
    assert {c["kernel"] for c in fc} == {"B2", "B3", "B4", "B5"}
    assert {c["storage"] for c in fc if c["kernel"] != "B2"} == \
        {"f32", "bf16"}
    assert {c["case"] for c in fc if c["kernel"] == "B5"} == \
        {"Octet 4^3 (MG level 0)", "Octet 2^3 (MG level 1)",
         "BCC+Hybrid1+Hybrid4 4^3", "BCC+Hybrid1+Hybrid4 2^3"}
    assert any(c["variant"] == "degree 24" for c in fc)
    assert {c["variant"] for c in fc if c["kernel"] == "B4"} == \
        {"step", "final"}
    assert all(c["max_rel_err"] == 0.0 for c in fc)
    assert set(rep["mains"]) == {"fused", "lo", "f32"}
    for route, main in rep["mains"].items():
        assert main["route"] == route
        assert main["levels"] == [[4, 4, 4], [2, 2, 2]]
        assert main["single_levels"] == [True, True]
        assert main["bitwise"] and main["finite"]
        assert main["compliance_rel_err"] <= 1e-5
        # no kernel on the CPU
        assert main["kernel_launches"] == {
            k: [0, 0] for k in ("B1", "B1f64", "VJP", "B2", "B3", "B4",
                                "B5")}
    # B1's float64 instance at every MG level, its VJP in both precisions
    assert [c["case"] for c in rep["cases64"]] == \
        ["Octet 4^3 (MG level 0)", "Octet 2^3 (MG level 1)"]
    assert all(c["max_rel_err"] == 0.0 for c in rep["cases64"])
    assert [c["case"] for c in rep["vjp_cases"]] == \
        ["Octet 4^3 f32", "Octet 4^3 f64"]
    assert all(c["max_rel_err"] <= c["tol"] for c in rep["vjp_cases"])
    assert [(c["kernel"], c["case"]) for c in rep["probe"]["cases"]] == \
        [("P1", "1d"), ("P1", "2d"), ("P2", "8x128")]
    # the design-gradient paths under their gates
    design = rep["design"]
    assert design["a"]["grad_rel_err"] <= smoke.IMPLICIT_VS_ANALYTIC_TOL
    assert design["a"]["iterations"]["adjoint"] is not None
    assert design["a"]["iterations_analytic"]["adjoint"] is None
    assert design["b"]["fd_rel_err"] <= smoke.FD_TOL
    assert design["b"]["directional"] != 0.0
    assert [sd["tol"] for sd in design["b"]["signed_direction"]] == \
        [smoke.DESIGN_TOL64, smoke.FD_SOLVE_TOL]
    c = design["c"]
    assert c["bitwise"] and c["finite"] and c["plain_gather_calls"] == 0
    assert c["grad_rel_err_vs_f64"] <= smoke.FUSED_VS_F64_TOL
    assert len(c["warm_iterations"]) == 2
    names = [k["name"] for k in rep["kernels"]]
    assert names == ["stencil_matvec_f32", "stencil_matvec_f64",
                     "stencil_vjp_r2", "stencil_matvec_bf16",
                     "mg_residual", "mg_cheb_run", "mg_cheb_full",
                     "probe_chain", "probe_scale"]
    for k in rep["kernels"]:
        for key in ("name", "route", "source", "replaces", "launches",
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            assert key in k
        assert (ROOT / k["source"]).exists()
        assert k["bound_ms"] > 0 and k["library_ms"] is None  # no card
        assert k["launches"] == 0
    json.dumps(rep["kernels"])
    for route in ("fused", "lo", "f32"):
        assert any(line.startswith(f"main path [{route}] 4^3 Octet")
                   for line in lines)
    for path in ("a", "b", "c"):
        assert any(line.startswith(f"design ({path})") for line in lines)
    assert all("[CPU rehearsal, host clock]" in line for line in lines
               if " ms" in line)


def test_launch_gates_name_the_missing_kernel():
    single = [False, True]
    ok = {"B1": [3, 1], "B2": [0, 0], "B3": [2, 0], "B4": [4, 0],
          "B5": [0, 3]}
    smoke._check_launches("fused", ok, single)
    with pytest.raises(AssertionError, match="B5 launched 0 times"):
        smoke._check_launches("fused", dict(ok, B5=[0, 0]), single)
    with pytest.raises(AssertionError, match="B2 launched"):
        smoke._check_launches("f32", dict(ok, B3=[0, 0], B4=[0, 0],
                                          B5=[0, 0], B2=[1, 0]), single)


def test_launch_gates_of_the_design_paths():
    """The float64 paths run B1's double instance, never the float32 one;
    an implicit path launches the r^2-cotangent kernel on the fine level."""
    single = [False, True]
    ok = {"B1": [0, 0], "B1f64": [3, 1], "VJP": [1, 0], "B2": [0, 0],
          "B3": [0, 0], "B4": [0, 0], "B5": [0, 0]}
    smoke._check_launches("f32", ok, single, implicit=True, f64=True)
    with pytest.raises(AssertionError, match="VJP launched 0 times"):
        smoke._check_launches("f32", dict(ok, VJP=[0, 0]), single,
                              implicit=True, f64=True)
    with pytest.raises(AssertionError, match="B1 launched 1 times"):
        smoke._check_launches("f32", dict(ok, B1=[1, 0]), single,
                              implicit=True, f64=True)
    with pytest.raises(AssertionError, match="VJP launched 1 times"):
        smoke._check_launches("f32", ok, single, f64=True)


def test_level_cells_follow_the_hierarchy():
    assert smoke.level_cells(50) == [50, 25, 13, 7, 4, 2]


def test_budget_fails_loudly():
    b = smoke.Budget(0.0)
    with pytest.raises(RuntimeError, match="wall budget"):
        b.check("build")


def _run(script_dir):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=script_dir,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(ROOT)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_chip_smoke_refuses_without_the_port(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = _run(tmp_path)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
