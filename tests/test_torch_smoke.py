"""Rehearsal of chip_smoke.py on the CPU at n=4: the phases' control flow
only (every wrapper runs its plain version, nothing is timed as a device
number), and the script's refusals without a card or without the port."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pylatticedso_tpu_torch import probes, smoke, smoke_ddm, smoke_statics
from pylatticedso_tpu_torch.opti import ddm_optimizer

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def test_phases_rehearse_on_cpu():
    lines = []
    rep = smoke.run(device="cpu", n=4, steps=2, windows=1,
                    log=lines.append, ddm_size=smoke_ddm.SMALL)
    assert rep["device"]["platform"] == "cpu"
    assert [c["case"].split()[0] for c in rep["cases"]] == \
        ["Octet", "Octet", "BCC+Hybrid1+Hybrid4"]
    assert all(c["max_rel_err"] == 0.0 for c in rep["cases"])
    # the slab kernels' plans (B1 f32 and f64, B2, B4): the rule's runs,
    # one thread per (class, point), no shared memory; the card's blocks
    # per SM are not asked off the card; the times before the redesign,
    # records, only in the log
    slab = [c for c in rep["cases"] + rep["cases64"]] + [
        c for c in rep["fused_cases"] if c["kernel"] in ("B2", "B4")]
    assert len(slab) == 3 + 2 + 4 + 4 * 2 * 2      # four grids of B2, B4
    for c in slab:
        p = c["plan"]
        assert p["run"] == (8 if c["case"].startswith("BCC+") else 32)
        assert p["threads"] == 128 and p["smem_bytes"] == 0
        assert p["blocks_per_sm"] is None and p["halo"] == [1, 1, 1]
        assert "before_ms" not in c and c["device_ms"] is None  # no card
    assert smoke.SLAB_BEFORE_MS[("B4", "Octet 50^3 (MG level 0)", "bf16",
                                 "step")] > 0
    assert all("not recorded" in line for line in lines
               if "vs before the redesign" in line
               or "| before the redesign" in line)
    for tag in ("B1 Octet 4^3", "B1<double> Octet 4^3", "B2 Octet 4^3",
                "B4 Octet 4^3 (MG level 0) f32 step"):
        assert any(line.startswith(tag) and "slab plan: runs of 32 points"
                   in line and "before the redesign" in line
                   for line in lines), tag
    # B3 on its slab plan and the r^2-cotangent on its beam plan (runs of
    # 32 points, one warp per edge, 4 edges a block), at every grid, with
    # a CUDA-graph time on the card (none here); the parent's times,
    # records, only in the log
    b3 = [c for c in rep["fused_cases"] if c["kernel"] == "B3"]
    assert len(b3) == 4 * 2                         # four grids, two storages
    for c in b3:
        p = c["plan"]
        assert p["run"] == (8 if c["case"].startswith("BCC+") else 32)
        assert p["threads"] == 128 and p["blocks_per_sm"] is None
        assert c["device_ms"] is None and "before_ms" not in c
    assert any(line.startswith("B3 Octet 4^3 (MG level 0) bf16 residual: "
                               "slab plan: runs of 32 points") and
               "before the redesign not recorded" in line for line in lines)
    assert [(c["case"], c["storage"]) for c in rep["vjp_grids"]] == [
        (case, st) for case in ("Octet 2^3 (MG level 1)",
                                "BCC+Hybrid1+Hybrid4 4^3",
                                "BCC+Hybrid1+Hybrid4 2^3")
        for st in ("f32", "f64")]
    for c in rep["vjp_cases"] + rep["vjp_grids"]:
        p = c["plan"]
        assert (p["run"], p["edges"], p["threads"]) == (32, 4, 128)
        assert p["blocks_per_sm"] is None and p["smem_bytes"] == 0
        assert c["device_ms"] is None and c["max_rel_err"] <= c["tol"]
        assert "before_ms" not in c
    assert smoke.SLAB_BEFORE_FROM == {"B3": "203cb5d", "r2": "203cb5d"}
    assert smoke.SLAB_BEFORE_MS[("B3", "Octet 50^3 (MG level 0)", "bf16",
                                 "residual")] > 0
    assert smoke.SLAB_BEFORE_MS[("r2", "Octet 50^3 f64", "f64", "vjp")] > 0
    for tag in ("B1 VJP Octet 4^3 f32", "B1 VJP Octet 4^3 f64",
                "r^2-cotangent BCC+Hybrid1+Hybrid4 2^3 f64"):
        assert any(line.startswith(tag) and "beam plan: runs of 32 points, "
                   "a warp per edge, 4 edges = 128 threads a block" in line
                   and "before the redesign not recorded" in line
                   for line in lines), tag
    # B2-B5 and B3c-B5c: every grid (the hybrid's coarse level too), both
    # storages; every case counts the elements whose bits differ from the
    # plain version's (none here: the plain version on both sides)
    fc = rep["fused_cases"]
    assert {c["kernel"] for c in fc} == {"B2", "B3", "B4", "B5", "B3c",
                                         "B4c", "B5c"}
    for tag in ("B3", "B4", "B5"):
        f32c = {(c["case"], c["storage"], c["variant"]) for c in fc
                if c["kernel"] == tag}
        assert {(c["case"], c["storage"], c["variant"]) for c in fc
                if c["kernel"] == tag + "c"} == f32c
        assert any(line.startswith(f"{tag}c vs {tag} Octet 4^3 (MG level 0) "
                                   f"bf16") for line in lines)
    assert all(c["bits_differ"] == 0 for c in fc)
    for c in fc:
        if c["kernel"] in ("B3c", "B4c", "B5c"):
            assert c["tol"] == 1e-2
            assert c["bound_ms"] == pytest.approx(
                1e3 * max(c["bytes"] / smoke.PEAK_BYTES_PER_S,
                          c["ops"] / smoke.PEAK_BF16_PER_S))
    assert {c["storage"] for c in fc if c["kernel"] != "B2"} == \
        {"f32", "bf16"}
    assert {c["case"] for c in fc if c["kernel"] == "B5"} == \
        {"Octet 4^3 (MG level 0)", "Octet 2^3 (MG level 1)",
         "BCC+Hybrid1+Hybrid4 4^3", "BCC+Hybrid1+Hybrid4 2^3"}
    assert any(c["variant"] == "degree 24" for c in fc)
    assert {c["variant"] for c in fc if c["kernel"] == "B4"} == \
        {"step", "final"}
    assert all(c["max_rel_err"] == 0.0 for c in fc)
    # B5: its plan, every cluster size and layout swept; the time before
    # the redesign, a record and not a measurement, only in the log (the
    # 50^3 levels only)
    for c in fc:
        if c["kernel"] not in ("B5", "B5c"):
            continue
        assert set(c["plan"]) == {"cluster", "layout", "threads", "ipt",
                                  "group", "r2_smem", "smem_bytes"}
        # B5c's plan groups G lanes per item, and its sweep runs every G;
        # its rule keeps d in global scratch where a block holds many
        # items (the hybrid's 4^3 level here)
        assert (c["plan"]["group"] == 1) == (c["kernel"] == "B5")
        if c["kernel"] == "B5c":
            assert {x["group"] for x in c["sweep"]} >= {1, 4}
        else:
            assert c["plan"]["layout"] == "bcast"
        swept = {(x["cluster"], x["layout"]) for x in c["sweep"]}
        assert (c["plan"]["cluster"], c["plan"]["layout"]) in swept
        assert any(lay == "global" for _, lay in swept)
        assert all(x["ms"] is None for x in c["sweep"])       # no card
        assert "before_ms" not in c
    assert smoke.B5_BEFORE_MS[("Octet 7^3 (MG level 3)", "bf16",
                               "degree 2, x0")] > 0
    assert any(line.startswith("B5 Octet 4^3")
               and "before the redesign not recorded |" in line
               for line in lines)
    assert set(rep["mains"]) == {"fused", "lo", "f32", "fused-bf16c"}
    for route, main in rep["mains"].items():
        assert main["route"] == route
        assert main["levels"] == [[4, 4, 4], [2, 2, 2]]
        assert main["single_levels"] == [True, True]
        assert main["bitwise"] and main["finite"]
        assert main["compliance_rel_err"] <= 1e-5
        # no kernel on the CPU
        assert main["kernel_launches"] == {
            k: [0, 0] for k in ("B1", "B1f64", "VJP", "B2", "B3", "B4",
                                "B5", "B3c", "B4c", "B5c")}
        assert main["b5_clusters"] == [{}, {}]
    # B1's float64 instance at every MG level, its VJP in both precisions
    assert [c["case"] for c in rep["cases64"]] == \
        ["Octet 4^3 (MG level 0)", "Octet 2^3 (MG level 1)"]
    assert all(c["max_rel_err"] == 0.0 for c in rep["cases64"])
    assert [c["case"] for c in rep["vjp_cases"]] == \
        ["Octet 4^3 f32", "Octet 4^3 f64"]
    assert all(c["max_rel_err"] <= c["tol"] for c in rep["vjp_cases"])
    assert [(c["kernel"], c["case"]) for c in rep["probe"]["cases"]] == \
        [("P1", "1d"), ("P1", "2d"), ("P2", "8x128")]
    p2 = rep["probe"]["cases"][-1]
    assert p2["ms"] is None and p2["library_ms"] is None     # no card
    # P1's bound in FP32 instructions: a multiply and an add, each rounded
    # on its own, a step, at half the FMA-counted float32 peak; its
    # CUDA-graph time is measured on the card only
    want_ms = {"1d": 0.00367, "2d": 0.02934}
    for c in rep["probe"]["cases"][:2]:
        assert c["bound_by"] == "operations" and c["device_ms"] is None
        assert c["bound_ms"] == pytest.approx(
            1e3 * probes.flops(c["case"]) / (smoke.PEAK_F32_PER_S / 2))
        assert round(c["bound_ms"], 5) == want_ms[c["case"]]
        assert any(line.startswith(f"P1 {c['case']}: bitwise equal") and
                   "(device, graph replay not measured)" in line
                   for line in lines)
    # the optimizer through optimize_lattice: (o1) at n, (o2) at min(8, n)
    o1, o2 = rep["optimizer"]["o1"], rep["optimizer"]["o2"]
    assert (o1["cells"], o1["params"], o1["iterations"]) == (4, 64, 3)
    assert o1["accepted"] >= 1
    assert o1["objective"] <= o1["first_objective"]
    assert o1["density"] <= smoke.OPT_DENSITY + smoke.OPT_DENSITY_SLACK
    assert o1["fd_rel_err"] <= smoke.OPT_FD_TOL
    assert len(o1["evaluations"]) == smoke.OPT_ITERS + 1
    assert all(e["forward"] > 0 and e["adjoint"] > 0
               for e in o1["evaluations"])
    assert set(o1["setup_s"]) == {"problem", "node_map", "fields", "step"}
    assert o1["plain_gather_calls"] == 0
    assert o1["kernel_launches"] == {
        k: [0, 0] for k in ("B1", "B1f64", "VJP", "B2", "B3", "B4", "B5",
                            "B3c", "B4c", "B5c")}
    assert o2["cells"] == 4
    assert o2["routed"] == "StructuredOptimizationProblem"
    assert o2["density"] <= smoke.OPT_DENSITY + smoke.OPT_DENSITY_SLACK
    assert o2["objective"] <= o2["feasible_start_objective"]
    assert o2["unstructured"]["fd_rel_err"] <= smoke.OPT_FD_TOL
    assert o2["same_bits_structured"] and o2["same_bits_unstructured"]
    assert any(line.startswith("optimizer (o1) 4^3 Octet unit_cell (64 "
                               "radii") for line in lines)
    assert any(line.startswith("optimizer (o2) 4^3 Octet FEM_AUTO -> "
                               "StructuredOptimizationProblem")
               for line in lines)
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
    assert c["b5_clusters"] == [{}, {}]
    assert c["grad_rel_err_vs_f64"] <= smoke.FUSED_VS_F64_TOL
    assert len(c["warm_iterations"]) == 2
    names = [k["name"] for k in rep["kernels"]]
    assert names == ["stencil_matvec_f32", "stencil_matvec_f64",
                     "stencil_vjp_r2", "stencil_matvec_bf16",
                     "mg_residual", "mg_cheb_run", "mg_cheb_full",
                     "mg_residual_bf16c", "mg_cheb_run_bf16c",
                     "mg_cheb_full_bf16c", "probe_chain", "probe_scale"]
    for k in rep["kernels"]:
        for key in ("name", "route", "source", "replaces", "launches",
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            assert key in k
        assert (ROOT / k["source"]).exists()
        assert k["bound_ms"] > 0 and k["library_ms"] is None  # no card
        assert k["launches"] == 0
    json.dumps(rep["kernels"])
    assert not any("before_ms" in c for k in rep["kernels"]
                   for c in k["cases"])
    # the full-lattice statics: (s1) bench.py's second mode at n = 4,
    # (s2) the step's other forms at min(8, n), (s3) the statics and the
    # simulation layer (the beam-flexion config cut to 1x1x1 cells at n = 4)
    st = rep["statics"]
    s1, s2, s3 = st["s1"], st["s2"], st["s3"]
    assert (s1["n"], s1["dofs"], s1["beams"]) == (4, 6 * 365, 1728)
    assert s1["bitwise"] and s1["finite"] and s1["u_shape"] == [6, 365]
    assert s1["setup_s"]["width"] == 12            # Octet's node degree
    assert len(s1["warm_s"]) == len(s1["warm_iterations"]) == 2
    assert s1["cold"]["iterations"] > 0 and s1["cold"]["chunked_iters"] == 256
    assert s1["reference"]["c_rel_err"] <= smoke_statics.C_TOL
    assert s1["reference"]["g_rel_err"] <= smoke_statics.G_TOL
    assert s1["reference"]["iterations"] > s1["cold"]["iterations"]
    assert s1["profile"]["route"] == "statics" and "profile_drive" not in s1
    assert len(s1["profile"]["iterations"]) == 2
    assert s2["n"] == 4 and s2["batch_bits"] and s2["descent_bits"]
    assert s2["repeat_bits"] and s2["fd_rel_err"] <= smoke_statics.S2_FD_TOL
    assert s2["form_c_rel_err"] <= smoke_statics.S2_C_TOL
    assert s2["form_g_rel_err"] <= smoke_statics.S2_G_TOL
    assert s2["block_iterations"] <= s2["jacobi_iterations"]
    assert s3["cells"] == [1, 1, 1]
    for name in ("solve_fem_lattice", "solve_fem_penalized",
                 "homogenize_cell"):
        assert s3[name]["same_bits"] and s3[name]["rel_err"] == 0.0, name
    assert s3["solve_fem_lattice"]["iterations"] > 0
    for tag in ("statics (s1) bench.py's second mode, 4^3 Octet (2190 DOF, "
                "1728 beams)", "statics (s2) 4^3 Octet f64",
                "statics (s3) solve_fem_lattice [1, 1, 1] BCC",
                "statics (s3) solve_fem_penalized",
                "statics (s3) homogenize_cell Octet f64",
                "profile [statics]"):
        assert any(line.startswith(tag) for line in lines), tag
    assert lines.index(next(x for x in lines if x.startswith("profile ["))) \
        > lines.index(next(x for x in lines if x.startswith("statics (s3)")))
    # the DDM phase at the rehearsal's size (2x1x1 three-point bending, a
    # 5-point grid per geometry; the 3-cell L-beam, a 3-point grid), after
    # the statics and before the profiles, under every gate
    d1, d2, d3 = (rep["ddm"][k] for k in ("d1", "d2", "d3"))
    assert (d1["cells"], d1["n_cells"], d1["params"]) == ([2, 1, 1], 2, 6)
    assert d1["samples"] == 125 and 0 < d1["m_rb"] <= 125
    assert d1["refined"] and d1["route"] == "dense"   # 6N = 366 here
    assert d1["interface_dofs"] == 6 * d1["nodes"]
    assert 0 < d1["free_dofs"] <= 6 * d1["interface_nodes"]
    assert d1["surrogate_rel_err"] <= smoke_ddm.SURROGATE_TOL
    assert d1["device_vs_cpu_rel_err"] == 0.0       # the CPU on both sides
    assert d1["refined_vs_plain"]["objective"] <= smoke_ddm.REFINED_OBJ_TOL
    assert d1["refined_vs_plain"]["gradient"] <= smoke_ddm.REFINED_GRAD_TOL
    assert d1["fd_rel_err"] <= smoke_ddm.FD_TOL and d1["bitwise"]
    for evals in (d1["refined_evals"], d1["plain_evals"]):
        assert len(evals) == 3
        assert all(e["objective"] > 0 and e["forward"] > 0
                   and e["adjoint"] > 0 for e in evals)
    assert d1["profile"]["route"] == "ddm" and "profile_drive" not in d1
    assert len(d1["profile"]["iterations"]) == 2
    assert d2["cells"] == 3 and d2["dense"] and d2["refined"]
    assert d2["accepted"] >= 1 and d2["objective"] <= d2["start_objective"]
    assert d2["density"] <= smoke_ddm.DENSITY + smoke_ddm.DENSITY_SLACK
    assert d3["cantilever"]["u_rel_l2"] <= smoke_ddm.FEM_TOL
    assert d3["cantilever"]["compliance_rel_err"] <= smoke_ddm.FEM_TOL
    t = d3["tpb_penalized"]
    assert t["groups"] == 1 and t["cpu_rel_err"] == 0.0
    assert t["f32_rel_l2"] <= smoke_ddm.F32_TOL
    assert d3["fe2"]["rel_err"] <= smoke_ddm.FE2_TOL
    for tag in ("ddm (d1) three-point bending 2x1x1 BCC+Hybrid1+Hybrid4 "
                "(2 cells, 6 radii", "ddm (d1) refined route (dense",
                "ddm (d1) plain f64 CG", "ddm (d1) gates:",
                "ddm (d2) L-beam (3 cells", "ddm (d3) cantilever_ddm",
                "ddm (d3) three-point bending [2, 1, 1] penalized exact",
                "ddm (d3) FE2", "profile [ddm]"):
        assert any(line.startswith(tag) for line in lines), tag
    assert lines.index(next(x for x in lines if x.startswith("ddm (d1)"))) \
        > lines.index(next(x for x in lines if x.startswith("statics (s3)")))
    assert lines.index(next(x for x in lines if x.startswith("profile ["))) \
        > lines.index(next(x for x in lines if x.startswith("ddm (d3) FE2")))
    # the profile of each route's own step and of path (c)'s, taken after
    # every phase
    for route, main in rep["mains"].items():
        assert main["profile"]["route"] == route
        assert len(main["profile"]["iterations"]) == \
            smoke.PROFILE_STEPS.get(route, 2)
        assert "profile_inputs" not in main
        assert any(line.startswith(f"profile [{route}]") for line in lines)
    assert rep["design"]["c"]["profile"]["route"] == "design"
    assert "profile_inputs" not in rep["design"]["c"]
    assert any(line.startswith("profile [design]") for line in lines)
    assert lines.index(next(x for x in lines if x.startswith("profile ["))) \
        > lines.index(next(x for x in lines if x.startswith("design (c)")))
    for route in ("fused", "lo", "f32", "fused-bf16c"):
        assert any(line.startswith(f"main path [{route}] 4^3 Octet")
                   for line in lines)
        assert any(line.startswith(f"CG iterations [{route}]: cold ") and
                   ", [fused] " in line for line in lines)
    for path in ("a", "b", "c"):
        assert any(line.startswith(f"design ({path})") for line in lines)
    assert all("[CPU rehearsal, host clock]" in line for line in lines
               if " ms" in line)


def test_profile_phase_reports_busy_share_and_b5():
    """The profile phase's fields on a built step (on the CPU no device
    event: busy 0)."""
    dev = torch.device("cpu")
    with smoke._env(PLDSO_MG_FUSED_DTYPE=smoke.FUSED_STORAGE):
        step, _, _ = smoke._route_step(4, dev, "fused", 1e-6, 6000)
        r = torch.full((4, 4, 4), 0.05)
        pstate = step.precond_state(r)
        _, _, u = step(r, None, pstate)
        prof = smoke.profile_phase(step, r, u, pstate, dev, "fused",
                                   steps=1)
    assert prof["route"] == "fused" and len(prof["iterations"]) == 1
    assert prof["device_busy_ms"] == 0.0 and prof["idle_share"] == 1.0
    assert prof["b5_ms"] == 0.0 and prof["b5_launches"] == 0
    assert prof["wall_ms"] > 0 and prof["phase_s"] >= prof["wall_ms"] / 1e3


def test_statics_gates_fail_loudly(monkeypatch):
    """(s1)'s comparison with its float64 reference and (s2)'s central
    difference raise when they miss (tolerances set to 0 here), and two
    results that differ in one bit are not the same bits."""
    dev = torch.device("cpu")
    monkeypatch.setattr(smoke_statics, "C_TOL", 0.0)
    with pytest.raises(AssertionError, match="f64 reference"):
        smoke_statics.s1_phase(dev, 2, steps=1)
    monkeypatch.setattr(smoke_statics, "S2_FD_TOL", 0.0)
    with pytest.raises(AssertionError, match="central difference"):
        smoke_statics.s2_phase(dev, 2)
    from pylatticedso_tpu_torch.fem.statics import FEMResult
    u = np.ones((3, 6))
    a = FEMResult(u=u, reaction=u, compliance=1.0, energy=0.5,
                  iterations=1, residual=0.0)
    b = FEMResult(u=np.nextafter(u, 2.0), reaction=u, compliance=1.0,
                  energy=0.5, iterations=1, residual=0.0)
    got = smoke_statics._results_agree(a, b, 1e-10)
    assert got["ok"] and not got["same_bits"]
    assert smoke_statics._results_agree(a, a, 0.0)["same_bits"]


def test_ddm_matrix_free_route_rehearses(monkeypatch):
    """(d1)'s card route, the matrix-free refined solve (6N = 27,246 >
    DENSE_MAX_DOF at full width), at the rehearsal's size: the same gates
    with the dense plan switched off."""
    monkeypatch.setattr(ddm_optimizer, "DENSE_MAX_DOF", 0)
    d1 = smoke_ddm.d1_phase(torch.device("cpu"), smoke_ddm.SMALL)
    assert d1["route"] == "matrix-free" and d1["refined"]
    assert d1["refined_vs_plain"]["objective"] <= smoke_ddm.REFINED_OBJ_TOL
    assert d1["refined_vs_plain"]["gradient"] <= smoke_ddm.REFINED_GRAD_TOL
    assert d1["bitwise"] and d1["fd_rel_err"] <= smoke_ddm.FD_TOL
    # the f32 inner CG takes more iterations than the dense factor's passes
    assert all(e["forward"] > 3 for e in d1["refined_evals"])
    assert d1["profile_drive"](0) > 0


def test_ddm_gates_fail_loudly(monkeypatch):
    """(d2)'s density gate raises when it misses (its slack made negative
    here), and (d3)'s FE2 gate (its tolerance set to 0)."""
    dev = torch.device("cpu")
    monkeypatch.setattr(smoke_ddm, "DENSITY_SLACK", -1.0)
    with pytest.raises(AssertionError, match=r"\(d2\) objective"):
        smoke_ddm.d2_phase(dev, smoke_ddm.SMALL)
    monkeypatch.setattr(smoke_ddm, "FE2_TOL", 0.0)
    with pytest.raises(AssertionError, match="FE2 vs exact"):
        smoke_ddm.d3_phase(dev, smoke_ddm.SMALL)


def test_paired_timing_takes_both_in_turns():
    calls = []
    a, b = smoke._paired_ms(lambda: calls.append("a"),
                            lambda: calls.append("b"), torch.device("cpu"),
                            reps=4, batch=2)
    assert a >= 0 and b >= 0
    # each sample warms up once, then runs its batch: a first, then b
    # first, in turns
    assert calls[:6] == ["a"] * 3 + ["b"] * 3
    assert calls[6:12] == ["b"] * 3 + ["a"] * 3


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


def test_launch_gates_of_the_bf16_compute_route():
    """The fused-bf16c route runs B3c-B5c on the fused route's levels and
    none of B3-B5; the fused route none of B3c-B5c; the route's switch is
    the variable alone, set for it and unset for every other route."""
    single = [False, True]
    ok = {"B1": [3, 1], "B2": [0, 0], "B3": [0, 0], "B4": [0, 0],
          "B5": [0, 0], "B3c": [2, 0], "B4c": [4, 0], "B5c": [0, 3]}
    smoke._check_launches("fused-bf16c", ok, single)
    with pytest.raises(AssertionError, match="B4 launched 1 times"):
        smoke._check_launches("fused-bf16c", dict(ok, B4=[1, 0]), single)
    with pytest.raises(AssertionError, match="B5c launched 0 times"):
        smoke._check_launches("fused-bf16c", dict(ok, B5c=[0, 0]), single)
    with pytest.raises(AssertionError, match="B3c launched 2 times"):
        smoke._check_launches("fused", dict(ok, B3=[2, 0], B4=[4, 0],
                                            B5=[0, 3]), single)
    assert smoke.ROUTES["fused-bf16c"] == smoke.ROUTES["fused"]
    assert smoke.ROUTE_ENV["fused-bf16c"] == {"PLDSO_MG_FUSED_COMPUTE":
                                              "bf16"}
    assert all(smoke.ROUTE_ENV[r] == {"PLDSO_MG_FUSED_COMPUTE": None}
               for r in ("fused", "lo", "f32"))
    mp = pytest.MonkeyPatch()
    mp.setenv("PLDSO_MG_FUSED_COMPUTE", "bf16")
    try:
        with smoke._env(**smoke.ROUTE_ENV["fused"]):
            assert "PLDSO_MG_FUSED_COMPUTE" not in os.environ
        assert os.environ["PLDSO_MG_FUSED_COMPUTE"] == "bf16"
    finally:
        mp.undo()


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
