"""The domain-decomposition phase of ``chip_smoke.py`` (``ddm_phase``):
the surrogate-DDM route on the card, three cells.

* (d1) the three-point-bending surrogate chain at full width
  (``scripts/ddm_ab_tpu.py``'s ``tpb``: 10x5x5 cells of BCC + Hybrid1 +
  Hybrid4, r 0.05, periodic; 250 cells, 750 radii under ``unit_cell``;
  relative density at most 0.3 from the shipped density fit; cg_tol 1e-9,
  cg_maxiter 2000, no penalization).  Offline: ``build_schur_surrogate``
  on the reference grid (step 0.01 from 0.01 to 0.1, 1,000 samples), the
  chained condensation in float64 on the device, the greedy basis on the
  host.  Online: one warm-up and ``evals`` value-and-gradient evaluations
  at perturbed designs on the refined route (matrix-free float32 CG with
  float64 residuals: 6N = 27,246 > ``DENSE_MAX_DOF``) and on plain float64
  CG (``refined=False``).  Gates: at 5 training samples the surrogate's S
  within 10 x tol_greedy (relative Frobenius) of a direct chained
  condensation on the device, whose S is within 1e-12 of the CPU's;
  refined against plain at ``GATE_TOL`` (the JAX package's
  ``test_ddm_refined_matches_plain_objective_and_gradient``: cg_tol 1e-11,
  objective 1e-9, gradient 1e-6 of max |g|); g.v against a central
  difference (1e-5); an evaluation repeated from the same theta and warm
  start the same bits; objective > 0 and no NaN.  Its ``profile_drive``
  continues on the refined route with descent steps of ``DRIVE_STEP``.
* (d2) ``ddm_ab_tpu.py``'s ``lbeam`` (6x1x6 cells with a 3x1x3 block
  erased: 27 cells, 3 geometries, periodic) through ``optimize_lattice``
  with ``"simulation_type": "DDM"``, relative density at most 0.3,
  ``max_iterations`` 3: a penalized surrogate trained once in numpy
  (``schur_penalized_batch``, grid step ``D2_STEP``), the robust drive
  (feasible start, move limit 0.1, ``slsqp_polish``) on the dense refined
  branch (6N = 3,690).  Gates: an accepted iterate, the objective no worse
  than the feasible start's, density within 1e-6 of the bound, no NaN,
  the dense branch taken.
* (d3) the exact DDM solver in float64: ``cantilever_ddm`` (4x2x2 BCC)
  against ``solve_fem(subdivide_h=0.05, penalization=True)`` on the device
  (interface u rel L2 1e-8, compliance 1e-8, the reference's own oracle);
  (d1)'s lattice penalized (one Schur group) on the device against the
  CPU (1e-10), and its float32 device operator with the refined solve
  against float64 (1e-8); ``schur_fe2`` on one BCC cell at target_h 0.3
  against ``schur_complement`` (1e-9).

No kernel of the port's ``csrc`` runs here: the JAX package computes this
route outside Pallas (dense Cholesky factors and solves, batched products
and ``segment_sum``), and the port's is torch with its per-node and
per-entry sums in a fixed order.  Every config is inline (the card's copy
of the repo has no ``data/``) and every surrogate is trained in a
temporary working directory, so no cache is read.  Each gate raises.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from .ddm.schur import (discretize_cell, discretize_cell_chained,
                        schur_batch_chained, schur_complement, schur_fe2)
from .ddm.solver import build_ddm_system, solve_ddm
from .design import build_lattice
from .fem.statics import solve_fem
from .materials import MatProperties
from .opti import optimize_lattice
from .opti import ddm_optimizer
from .opti.ddm_optimizer import DDMOptimizationProblem, build_schur_surrogate
from .opti.density import KrigingDensity
from .sim.penalization import compute_l_zones
from .smoke_statics import _timed
from .utils.timing import timing

__all__ = ["ddm_phase", "d1_phase", "d2_phase", "d3_phase", "tpb_config",
           "lbeam_config", "cantilever_ddm_config", "HYBRID_DENSITY_FIT",
           "FULL", "SMALL"]

GEOM3 = ["BCC", "Hybrid1", "Hybrid4"]
SIM = {"enable": True, "material": "VeroClear", "periodicity": True}
CLAMP = {"DOF": ["X", "Y", "Z", "RX", "RY", "RZ"], "Value": [0] * 6}
#: the relative-density fit of the three geometries, a byte copy of the JAX
#: package's cache ``data/outputs/density_datasets/`` (the card's machine
#: has no scikit-learn to refit it)
HYBRID_DENSITY_FIT = (Path(__file__).resolve().parent / "fits"
                      / "BCC_Hybrid1_Hybrid4_0.01_0.1_10.gpr.npz")
R_MIN, R_MAX = 0.01, 0.1         # the radius range of the surrogates
TOL_GREEDY = 1e-6
DENSITY = 0.3
DENSITY_SLACK = 1e-6
CG_TOL, CG_MAXITER = 1e-9, 2000  # ddm_ab_tpu.py's problem
GATE_TOL = 1e-11                 # refined against plain, and g.v, at this
SURROGATE_TOL = 10 * TOL_GREEDY  # (d1) S at training samples vs direct
DEVICE_CPU_TOL = 1e-12           # (d1) chained S on the device vs the CPU
REFINED_OBJ_TOL, REFINED_GRAD_TOL = 1e-9, 1e-6
FD_EPS, FD_TOL = 1e-3, 1e-5      # step in theta (normalized radii)
DRIVE_STEP = 1e-3                # the profile's descent step in theta
FEM_TOL = 1e-8                   # (d3) DDM against the subdivided FEM
D3_CPU_TOL = 1e-10               # (d3) device against the CPU, float64
F32_TOL = 1e-8                   # (d3) refined float32 against float64
FE2_TOL = 1e-9
D2_ITERS = 3

#: cells, grid steps and depth: ``FULL`` on the card, ``SMALL`` in the CPU
#: rehearsal (a 2x1x1 lattice and a 3-point grid per geometry)
FULL = {"tpb": (10, 5, 5), "lbeam": ((6, 1, 6), (3, 1, 3)),
        "cantilever": (4, 2, 2), "d1_step": 0.01, "d2_step": 0.02,
        "evals": 6, "samples": 5}
SMALL = {"tpb": (2, 1, 1), "lbeam": ((2, 1, 2), (1, 1, 1)),
         "cantilever": (2, 1, 1), "d1_step": 0.0225, "d2_step": 0.045,
         "evals": 2, "samples": 5}


def tpb_config(cells: Tuple[int, int, int] = FULL["tpb"]) -> Dict:
    """``scripts/ddm_ab_tpu.py``'s ``tpb`` (three-point bending): BCC +
    Hybrid1 + Hybrid4 at r 0.05, periodic, Xmax fixed in X, Xmin and Zmin
    simply supported on the Xmax/Zmin cells, -0.1 in Z on Xmax/Zmax."""
    return {
        "geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                     "number_of_cells": dict(zip("xyz", cells)),
                     "radii": [0.05] * 3, "geom_types": GEOM3},
        "simulation_parameters": SIM,
        "boundary_conditions": {
            "Displacement": {
                "Fixed": {"Surface": ["Xmax"], "DOF": ["X"], "Value": [0]},
                "SimpleSupport": {"Surface": ["Xmin", "Zmin"],
                                  "DOF": ["Y", "Z"], "Value": [0, 0],
                                  "SurfaceCells": ["Xmax", "Zmin"]}},
            "Force": {"Load": {"Surface": ["Xmax", "Zmax"], "DOF": ["Z"],
                               "Value": [-0.1]}}}}


def lbeam_config(cells=FULL["lbeam"][0], block=FULL["lbeam"][1],
                 iters: int = D2_ITERS) -> Dict:
    """``ddm_ab_tpu.py``'s ``lbeam`` (an L-beam: the block of ``block``
    cells erased at the top of the x range), Zmax clamped, -0.1 in Z on
    Xmax/Zmin, with the DDM optimization block."""
    nx, _, nz = cells
    bx, by, bz = block
    return {
        "geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                     "number_of_cells": dict(zip("xyz", cells)),
                     "radii": [0.1] * 3, "geom_types": GEOM3},
        "supplementary": {"erased_blocks": {"block_0": {
            "start_point": {"x": float(nx - bx), "y": 0.0,
                            "z": float(nz - bz)},
            "dimensions_block": {"x": float(bx), "y": float(by),
                                 "z": float(bz)}}}},
        "simulation_parameters": SIM,
        "boundary_conditions": {
            "Force": {"Load": {"Surface": ["Xmax", "Zmin"], "DOF": ["Z"],
                               "Value": [-0.1]}},
            "Displacement": {"Encastre": {"Surface": ["Zmax"], **CLAMP}}},
        "optimization_informations": {
            "simulation_type": "DDM", "objective_type": "compliance",
            "objective_function": "min",
            "optimization_parameters": {"type": "unit_cell"},
            "constraints": {"relative_density": {"value": DENSITY,
                                                 "mode": "upper"}},
            "max_iterations": iters}}


def cantilever_ddm_config(cells=FULL["cantilever"]) -> Dict:
    """``data/inputs/preset_lattice/simulation/cantilever_ddm.json``:
    ``cells`` BCC cells, r 0.08, Xmin clamped, -0.5 in Z on Xmax, exact
    Schur with block Jacobi."""
    return {
        "geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                     "number_of_cells": dict(zip("xyz", cells)),
                     "radii": [0.08], "geom_types": ["BCC"]},
        "simulation_parameters": {
            "enable": True, "material": "VeroClear", "periodicity": False,
            "DDM": {"enable_preconditioner": True,
                    "preconditioner_type": "block_jacobi",
                    "max_iterations": 2000,
                    "schur_complement_computation": {"type": "exact"}}},
        "boundary_conditions": {
            "Displacement": {"Fixed": {"Surface": ["Xmin"], **CLAMP}},
            "Force": {"Load": {"Surface": ["Xmax"], "DOF": ["Z"],
                               "Value": [-0.5]}}}}


@contextlib.contextmanager
def _workdir():
    """A new, empty working directory for the block: a surrogate trained
    there reads no cache (and its own cache write fails, as the packages
    allow)."""
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            yield
        finally:
            os.chdir(old)


def _train(lattice, device, **kw):
    """``build_schur_surrogate`` in a new working directory, timed: (the
    surrogate, {"train_s", "condense_s", "greedy_s"})."""
    names = ("schur_batch_chained", "schur_penalized_batch",
             "reduce_basis_greedy")
    before = {k: timing.total(k) for k in names}
    with _workdir():
        sur, s = _timed(lambda: build_schur_surrogate(
            lattice, MatProperties("VeroClear"), R_MIN, R_MAX,
            tol_greedy=TOL_GREEDY, device=device, **kw), device)
    spent = {k: timing.total(k) - before[k] for k in names}
    return sur, {"train_s": s,
                 "condense_s": spent["schur_batch_chained"]
                 + spent["schur_penalized_batch"],
                 "greedy_s": spent["reduce_basis_greedy"]}


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _eval_points(x0: np.ndarray, k: int, seed: int):
    """``ddm_ab_tpu.py``'s designs: x0 + U(-0.1, 0.1), clipped to
    [0.05, 0.95]."""
    rng = np.random.default_rng(seed)
    return [np.clip(x0 + rng.uniform(-0.1, 0.1, x0.shape), 0.05, 0.95)
            for _ in range(k)]


def _evaluations(prob, points, device):
    """Objective then gradient at each point (the second from the
    value-and-gradient cache), timed, with the solves' CG iterations."""
    out = []
    for x in points:
        (v, g), s = _timed(lambda: (prob.objective(x), prob.gradient(x)),
                           device)
        out.append({"s": s, "objective": v, "gradient": g,
                    **prob.last_solves})
    return out


def _refined_kw(device: torch.device) -> Dict:
    """On the card the problem's own choice (refined on a CUDA device); in
    the CPU rehearsal the card's route, forced."""
    return {} if device.type == "cuda" else {"refined": True}


def d1_phase(device: torch.device, size: Dict = FULL, seed: int = 11) -> Dict:
    """(d1): the three-point-bending surrogate chain (the module's
    docstring)."""
    cpu = torch.device("cpu")
    mat = MatProperties("VeroClear")
    lat, build_s = _timed(lambda: build_lattice(tpb_config(size["tpb"])),
                          device)
    sur, train = _train(lat, device, step=size["d1_step"], share_weights=True)

    # the surrogate at training samples against a direct condensation
    disc = discretize_cell_chained(lat, 0, share_weights=True)
    idx = np.linspace(0, len(sur.samples) - 1, size["samples"]).round()
    mus = sur.samples[idx.astype(int)]
    args = (mus, mat.young_modulus, mat.poisson_ratio)
    S_dev = schur_batch_chained(disc, *args, device=device)
    S_cpu = schur_batch_chained(disc, *args, device=cpu)
    S_sur = sur.reconstruct_batch(mus)
    sur_err = max(float(torch.linalg.norm(S_sur[i] - S_dev[i])
                        / torch.linalg.norm(S_dev[i]))
                  for i in range(len(mus)))
    cpu_err = _rel(S_dev.cpu(), S_cpu)

    kw = dict(opt_params={"type": "unit_cell"},
              constraints={"relative_density": {"value": DENSITY,
                                                "mode": "upper"}},
              cg_tol=CG_TOL, cg_maxiter=CG_MAXITER, surrogate=sur,
              density_model=KrigingDensity.load(HYBRID_DENSITY_FIT),
              device=device)
    prob, prob_s = _timed(lambda: DDMOptimizationProblem(
        lat, **kw, **_refined_kw(device)), device)
    plain, plain_s = _timed(lambda: DDMOptimizationProblem(
        lat, **kw, refined=False), device)
    N = prob._n_nodes
    route = "dense" if prob._dense is not None else "matrix-free"

    points = _eval_points(prob.param.x0, size["evals"] + 1, seed)
    ev_ref = _evaluations(prob, points, device)
    ev_plain = _evaluations(plain, points, device)
    at_tol = max(abs(a["objective"] - b["objective"]) / abs(b["objective"])
                 for a, b in zip(ev_ref, ev_plain))
    at_tol_g = max(_rel(a["gradient"], b["gradient"])
                   for a, b in zip(ev_ref, ev_plain))

    # the gates at GATE_TOL, cold: refined against plain, and g.v against
    # a central difference on the refined route
    x = points[1]
    zero = torch.zeros((N, 6), dtype=torch.float64, device=prob.device)
    prob.cg_tol = plain.cg_tol = GATE_TOL
    (v_r, _), g_r = prob._vg_aux(x, zero)
    (v_p, _), g_p = plain._vg_aux(x, zero)
    gate_solves = {"refined": dict(prob.last_solves),
                   "plain": dict(plain.last_solves)}
    obj_err = abs(float(v_r) - float(v_p)) / abs(float(v_p))
    grad_err = _rel(g_r.cpu(), g_p.cpu())
    v = np.random.default_rng(seed).uniform(0.5, 1.5, x.shape)
    v /= np.linalg.norm(v)
    gv = float(np.dot(g_r.cpu().numpy(), v))
    fd = (float(prob._vg_aux(x + FD_EPS * v, zero)[0][0])
          - float(prob._vg_aux(x - FD_EPS * v, zero)[0][0])) / (2 * FD_EPS)
    fd_err = abs(fd - gv) / abs(gv)
    prob.cg_tol = plain.cg_tol = CG_TOL

    # the same bits from the same theta and warm start
    u0 = prob._u_warm
    (va, ua), ga = prob._vg_aux(points[-1], u0)
    (vb, ub), gb = prob._vg_aux(points[-1], u0)
    bitwise = bool(torch.equal(va, vb) and torch.equal(ga, gb)
                   and torch.equal(ua, ub))

    objs = [e["objective"] for e in ev_ref + ev_plain]
    finite = all(np.isfinite(e["objective"])
                 and np.isfinite(e["gradient"]).all()
                 for e in ev_ref + ev_plain)
    free = prob._iface_free
    rep = {
        "cells": list(size["tpb"]), "n_cells": lat.num_cells,
        "params": prob.param.n_params, "nodes": N, "beams": lat.num_edges,
        "interface_dofs": 6 * N,
        "interface_nodes": len(torch.unique(torch.cat(
            [g.bn.reshape(-1) for g in prob._groups]))),
        "free_dofs": int(free.sum()), "route": route,
        "refined": prob.refined, "build_lattice_s": build_s, **train,
        "samples": len(sur.samples), "m_rb": int(sur.basis.shape[1]),
        "n_boundary": sur.n_boundary, "problem_s": prob_s,
        "plain_problem_s": plain_s, "gate_samples": len(mus),
        "surrogate_rel_err": sur_err,
        "device_vs_cpu_rel_err": cpu_err,
        "refined_evals": [{k: e[k] for k in ("s", "objective", "forward",
                                             "adjoint")} for e in ev_ref],
        "plain_evals": [{k: e[k] for k in ("s", "objective", "forward",
                                           "adjoint")} for e in ev_plain],
        "at_cg_tol": {"objective": at_tol, "gradient": at_tol_g},
        "gate_tol": GATE_TOL, "gate_solves": gate_solves,
        "refined_vs_plain": {"objective": obj_err, "gradient": grad_err},
        "directional": gv, "finite_difference": fd, "fd_rel_err": fd_err,
        "bitwise": bitwise, "finite": finite,
    }
    if not (finite and min(objs) > 0):
        raise AssertionError(f"(d1) a non-finite or non-positive "
                             f"evaluation: {objs}")
    want = "matrix-free" if 6 * N > ddm_optimizer.DENSE_MAX_DOF else "dense"
    if not (prob.refined and route == want):
        raise AssertionError(f"(d1) the refined route was not taken: "
                             f"refined {prob.refined}, {route}")
    if not (sur_err <= SURROGATE_TOL and cpu_err <= DEVICE_CPU_TOL):
        raise AssertionError(f"(d1) S at training samples: surrogate "
                             f"{sur_err:.3e} (tol {SURROGATE_TOL:g}), device "
                             f"vs CPU {cpu_err:.3e} (tol {DEVICE_CPU_TOL:g})")
    if not (obj_err <= REFINED_OBJ_TOL and grad_err <= REFINED_GRAD_TOL):
        raise AssertionError(f"(d1) refined vs plain at cg_tol {GATE_TOL:g}:"
                             f" objective {obj_err:.3e}, gradient "
                             f"{grad_err:.3e}")
    if not fd_err <= FD_TOL:
        raise AssertionError(f"(d1) g.v {gv:.9e} vs the central difference "
                             f"{fd:.9e}: {fd_err:.3e}")
    if not bitwise:
        raise AssertionError("(d1) a repeated evaluation differs in its bits")

    state = {"x": points[-1], "u": prob._u_warm,
             "g": ev_ref[-1]["gradient"]}

    def drive(k):
        """One more refined value-and-gradient, a descent step of
        ``DRIVE_STEP`` (of max |g|) in theta from the last point, warm
        started from its solution (an optimizer's late iterations)."""
        g = state["g"]
        state["x"] = np.clip(state["x"] - DRIVE_STEP * g / np.abs(g).max(),
                             0.05, 0.95)
        (_, state["u"]), g = prob._vg_aux(state["x"], state["u"])
        state["g"] = g.cpu().numpy()
        return prob.last_solves["forward"] + prob.last_solves["adjoint"]

    rep["profile_drive"] = drive
    return rep


def d2_phase(device: torch.device, size: Dict = FULL) -> Dict:
    """(d2): the penalized L-beam through ``optimize_lattice`` (the
    module's docstring)."""
    cells, block = size["lbeam"]
    lat = build_lattice(lbeam_config(cells, block))
    sur, train = _train(lat, device, step=size["d2_step"], penalization=True,
                        share_weights=True)
    (problem, res), drive_s = _timed(lambda: optimize_lattice(
        lat, surrogate=sur, density_model=KrigingDensity.load(
            HYBRID_DENSITY_FIT), device=device, **_refined_kw(device)),
        device)
    N = problem._n_nodes
    x_start = problem.feasible_x0()
    v_start = problem.objective(x_start)
    evals = _evaluations(problem, _eval_points(np.asarray(res.theta), 3, 7),
                         device)
    hist = [h["objective"] for h in problem.history]
    rep = {"cells": lat.num_cells, "geometries": lat.config.n_geom,
           "params": problem.param.n_params, "interface_dofs": 6 * N,
           "dense": problem._dense is not None, "refined": problem.refined,
           "step": size["d2_step"], "samples": len(sur.samples),
           "m_rb": int(sur.basis.shape[1]), **train, "drive_s": drive_s,
           "eval_s": [e["s"] for e in evals],
           "eval_solves": [(e["forward"], e["adjoint"]) for e in evals],
           "start_objective": v_start, "objective": res.objective,
           "density": res.density, "iterations": res.iterations,
           "history_objective": hist, "message": res.message,
           "accepted": int(np.isfinite(hist).sum())}
    if not (problem.refined and rep["dense"]
            and 6 * N <= ddm_optimizer.DENSE_MAX_DOF):
        raise AssertionError(f"(d2) the dense refined branch was not taken: "
                             f"{rep}")
    if not (rep["accepted"] >= 1 and np.isfinite(res.objective)
            and np.isfinite(res.radii).all()):
        raise AssertionError(f"(d2) no accepted iterate or a NaN: {rep}")
    if not (res.objective <= v_start
            and res.density <= DENSITY + DENSITY_SLACK):
        raise AssertionError(f"(d2) objective {res.objective:.9e} vs the "
                             f"start's {v_start:.9e}, density "
                             f"{res.density:.9f}")
    return rep


def d3_phase(device: torch.device, size: Dict = FULL) -> Dict:
    """(d3): the exact DDM solver (the module's docstring)."""
    cpu = torch.device("cpu")
    rep = {}
    # cantilever_ddm against the subdivided, penalized FEM on the device
    lat = build_lattice(cantilever_ddm_config(size["cantilever"]))
    sys_ = build_ddm_system(lat, dtype=torch.float64, device=device)
    ddm, ddm_s = _timed(lambda: solve_ddm(lat, system=sys_, tol=1e-12),
                        device)
    fem, fem_s = _timed(lambda: solve_fem(
        lat, subdivide_h=0.05, penalization=True, tol=1e-13, device=device),
        device)
    iface = sys_.interface_nodes
    u_err = float(np.linalg.norm(ddm.u[iface] - fem.u[iface])
                  / np.linalg.norm(fem.u[iface]))
    c_err = abs(ddm.compliance - fem.compliance) / abs(fem.compliance)
    rep["cantilever"] = {"cells": list(size["cantilever"]),
                         "groups": len(sys_.S), "ddm_iterations":
                         ddm.iterations, "fem_iterations": fem.iterations,
                         "ddm_s": ddm_s, "fem_s": fem_s, "u_rel_l2": u_err,
                         "compliance_rel_err": c_err,
                         "compliance": ddm.compliance}
    if not (u_err <= FEM_TOL and c_err <= FEM_TOL):
        raise AssertionError(f"(d3) DDM vs FEM: {rep['cantilever']}")

    # (d1)'s lattice, penalized exact: device f64, CPU f64, device f32
    lat = build_lattice(tpb_config(size["tpb"]))
    runs = {}
    for name, dev, dtype, tol in (("device", device, torch.float64, 1e-12),
                                  ("cpu", cpu, torch.float64, 1e-12),
                                  ("f32", device, torch.float32, 1e-12)):
        s, cond_s = _timed(lambda: build_ddm_system(lat, dtype=dtype,
                                                    device=dev), dev)
        r, solve_s = _timed(lambda: solve_ddm(lat, system=s, tol=tol), dev)
        runs[name] = {"result": r, "condense_s": cond_s, "solve_s": solve_s,
                      "groups": len(s.S)}
    # the condensed cell's interior (the lattice-wide L-zones, as
    # build_ddm_system's groups take them)
    disc = discretize_cell(lat, 0, penalization=True, share_weights=True,
                           l_zones=compute_l_zones(lat.nodes, lat.edges,
                                                   lat.radius,
                                                   periodicity=True))
    dev_r, cpu_r, f32_r = (runs[k]["result"] for k in ("device", "cpu",
                                                       "f32"))
    cpu_err = max(_rel(dev_r.u, cpu_r.u), _rel(dev_r.reaction,
                                               cpu_r.reaction),
                  abs(dev_r.compliance - cpu_r.compliance)
                  / abs(cpu_r.compliance))
    f32_err = float(np.linalg.norm(f32_r.u - dev_r.u)
                    / np.linalg.norm(dev_r.u))
    rep["tpb_penalized"] = {
        "cells": list(size["tpb"]), "groups": runs["device"]["groups"],
        "interior_dofs": len(disc.interior_dofs),
        "compliance": dev_r.compliance, "cpu_rel_err": cpu_err,
        "f32_rel_l2": f32_err,
        **{f"{k}_{m}": runs[k][m] for k in runs
           for m in ("condense_s", "solve_s")},
        **{f"{k}_iterations": runs[k]["result"].iterations for k in runs}}
    if not (cpu_err <= D3_CPU_TOL and f32_err <= F32_TOL):
        raise AssertionError(f"(d3) penalized tpb: {rep['tpb_penalized']}")

    # FE2 against the exact condensation, one BCC cell
    cell = build_lattice({
        "geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                     "number_of_cells": {"x": 1, "y": 1, "z": 1},
                     "radii": [0.08], "geom_types": ["BCC"]},
        "simulation_parameters": {"enable": True, "material": "VeroClear"},
        "boundary_conditions": {}})
    mat = MatProperties("VeroClear")
    d = discretize_cell(cell, 0, target_h=0.3, penalization=False)
    S_exact = schur_complement(d, cell.cell_radii[0], mat.young_modulus,
                               mat.poisson_ratio, device=device).cpu().numpy()
    S_fe2, fe2_s = _timed(lambda: schur_fe2(cell, 0, mat, target_h=0.3,
                                            device=device), device)
    fe2_err = float(np.linalg.norm(S_fe2 - S_exact) / np.linalg.norm(S_exact))
    rep["fe2"] = {"rel_err": fe2_err, "s": fe2_s,
                  "columns": int(S_fe2.shape[0])}
    if not fe2_err <= FE2_TOL:
        raise AssertionError(f"(d3) FE2 vs exact: {fe2_err:.3e}")
    return rep


def ddm_phase(device: torch.device, size: Dict = FULL) -> Dict:
    """(d1), (d2) and (d3) in order; raises on the first failed gate."""
    return {"d1": d1_phase(device, size), "d2": d2_phase(device, size),
            "d3": d3_phase(device, size)}
