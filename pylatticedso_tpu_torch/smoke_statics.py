"""The statics phase of ``chip_smoke.py``: the full-lattice path on the
card (``statics_phase``), three cells.

* (s1) ``bench.py``'s second mode (``BENCH_MODE`` other than structured)
  at full width: an n^3 Octet lattice through ``build_lattice``, Zmin
  clamped in all six DOF, -1.0 on Zmax in Z (3,090,906 DOF and 3,030,000
  beams at n = 50); ``ShardedLattice`` in float32 and
  ``make_compliance_step`` with block Jacobi, tol 1e-6, maxiter 6000; one
  cold ``step.chunked(r, chunk=256)``, then ``steps`` warm steps with the
  bench's update ``rr = clip(rr - 1e-4 g, 0.01, 0.1) * (rr > 0)`` from
  ``rr = 1.001 r``.  Gates: every chunked solve converges; a warm step
  repeated from the same ``(rr, u)`` gives the same bits in c, g and u; at
  the cold radii c within 1e-5 and g within 1e-3 (of max |g|) of a float64
  ``step.chunked`` at tol 1e-10 on the same device; no NaN.  Its
  ``profile_drive`` continues the descent, one warm step a call.
* (s2) the step's other forms at ``small``^3 Octet in float64: ``step(r)``
  against ``step.chunked`` (c 1e-10, g 1e-8), g.v against a central
  difference (1e-6), ``step.batch`` of two candidates and
  ``descent_loop(r, 3)`` the bits of the single steps, block Jacobi in no
  more CG iterations than Jacobi, the same bits on a second call.
* (s3) the statics and the simulation layer in float64 on the device and
  on the CPU in one process: ``solve_fem_lattice`` (auto subdivision) on
  the beam-flexion preset's config, ``solve_fem(penalization=True)`` on
  it, ``homogenize_cell`` on one Octet cell.  Gates: u, reaction,
  compliance and C within 1e-10 of the CPU's, the same bits on a second
  call on the device.

No kernel of the port's ``csrc`` runs here: the JAX package's path is XLA
gathers, ``segment_sum`` and ``cho_solve``, and the port's is plain torch
with its per-node sums in a fixed order.  Every config is inline (the
card's copy of the repo has no ``data/``).  Each gate raises.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from .design import build_lattice
from .fem.bc import apply_boundary_conditions
from .fem.homogenization import homogenize_cell
from .fem.statics import solve_fem
from .parallel.sharding import ShardedLattice, make_compliance_step, make_mesh
from .sim.utils_simulation import solve_fem_lattice

__all__ = ["statics_phase", "s1_phase", "s2_phase", "s3_phase",
           "bench2_config", "flexion_config", "FLEXION_CELLS"]

E_MOD, NU = 1013.0, 0.3          # bench.py's second mode
TOL, MAXITER, CHUNK, LR = 1e-6, 6000, 256, 1e-4
REF_TOL = 1e-10                  # the float64 reference solve
C_TOL, G_TOL = 1e-5, 1e-3        # (s1) f32 against the f64 reference
SMALL = 8                        # (s2)'s cells per side
S2_TOL = 1e-12                   # (s2)'s CG tolerance
S2_C_TOL, S2_G_TOL, S2_FD_TOL = 1e-10, 1e-8, 1e-6
FD_REL_STEP = 1e-4               # central-difference step, of the radius
S3_TOL = 1e-10                   # (s3) device against the CPU
FLEXION_CELLS = (6, 3, 3)        # the beam-flexion preset
CLAMP = {"DOF": ["X", "Y", "Z", "RX", "RY", "RZ"], "Value": [0] * 6}


def bench2_config(n: int) -> Dict:
    """``bench.py``'s second mode: n^3 Octet, r 0.05, Zmin clamped, -1.0
    on Zmax in Z."""
    return {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                         "number_of_cells": {"x": n, "y": n, "z": n},
                         "radii": [0.05], "geom_types": ["Octet"]},
            "boundary_conditions": {
                "Displacement": {"Fixed": {"Surface": ["Zmin"], **CLAMP}},
                "Force": {"Load": {"Surface": ["Zmax"], "DOF": ["Z"],
                                   "Value": [-1.0]}}}}


def flexion_config(cells: Tuple[int, int, int] = FLEXION_CELLS) -> Dict:
    """``data/inputs/preset_lattice/simulation/beam_flexion.json`` inline
    (``cells`` BCC cells, r 0.1, Xmin clamped, Xmax and Zmax Z = -0.01)."""
    return {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                         "number_of_cells": dict(zip("xyz", cells)),
                         "radii": [0.1], "geom_types": ["BCC"]},
            "simulation_parameters": {"enable": True, "material": "VeroClear",
                                      "periodicity": False},
            "boundary_conditions": {"Displacement": {
                "Fixed": {"Surface": ["Xmin"], **CLAMP},
                "Displacement": {"Surface": ["Xmax", "Zmax"], "DOF": ["Z"],
                                 "Value": [-0.01]}}}}


OCTET_CELL = {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                           "number_of_cells": {"x": 1, "y": 1, "z": 1},
                           "radii": [0.05], "geom_types": ["Octet"]},
              "simulation_parameters": {"enable": True,
                                        "material": "VeroClear",
                                        "periodicity": True}}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """(fn(), seconds) on the host clock, the device synchronized."""
    _sync(device)
    t = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t


def _same(*pairs) -> bool:
    return all(torch.equal(a, b) for a, b in pairs)


def _rel(a, b) -> float:
    """max |a - b| over max |b| (tensors or arrays, compared in f64)."""
    a = torch.as_tensor(np.asarray(a.cpu() if torch.is_tensor(a) else a),
                        dtype=torch.float64)
    b = torch.as_tensor(np.asarray(b.cpu() if torch.is_tensor(b) else b),
                        dtype=torch.float64)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _finite(*ts) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts)


def _bench2_step(lat, bc, device, dtype, tol):
    """The sharded lattice and step of bench.py's second mode, timed: the
    frames and the ordered table, the step's operands."""
    mesh = make_mesh(devices=[device])
    shl, t_shl = _timed(lambda: ShardedLattice(
        mesh, lat.nodes, lat.edges, E_MOD, NU, dtype=dtype), device)
    step, t_step = _timed(lambda: make_compliance_step(
        shl, ~bc.fixed, bc.f_applied, tol=tol, maxiter=MAXITER), device)
    return shl, step, {"lattice_s": t_shl, "step_s": t_step}


def s1_phase(device: torch.device, n: int, steps: int = 8) -> Dict:
    """(s1): bench.py's second mode at n^3 (see the module's docstring)."""
    lat, build_s = _timed(lambda: build_lattice(bench2_config(n)), device)
    bc, bc_s = _timed(lambda: apply_boundary_conditions(lat), device)
    shl, step, setup = _bench2_step(lat, bc, device, torch.float32, TOL)
    r = shl.radius_padded(lat.radius)
    _, setup["factors_s"] = _timed(lambda: step.preconditioner(r), device)
    setup["width"] = shl.width

    (c0, g0, u0, it0), cold_s = _timed(lambda: step.chunked(r, chunk=CHUNK),
                                       device)
    cold = {"s": cold_s, "iterations": step.chunked.last_iterations,
            "chunked_iters": it0, "residual": step.chunked.last_residual}
    rr, u = r * 1.001, u0
    warm_s, warm_it, out = [], [], None
    for _ in range(steps):
        prev = (rr, u)
        out, s = _timed(lambda: step.chunked(rr, u, chunk=CHUNK), device)
        if not step.chunked.last_converged:
            raise AssertionError("(s1) a warm step did not converge")
        c, g, u, _ = out
        warm_s.append(s)
        warm_it.append(step.chunked.last_iterations)
        rr = torch.clamp(rr - LR * g, 0.01, 0.1) * (rr > 0)
    # the last warm step again, from the same (rr, u)
    c_b, g_b, u_b, _ = step.chunked(*prev, chunk=CHUNK)
    bitwise = _same((c, c_b), (g, g_b), (u, u_b))

    # the float64 reference at the cold radii, on the same device
    shl64, step64, _ = _bench2_step(lat, bc, device, torch.float64, REF_TOL)
    (c64, g64, _, _), ref_s = _timed(lambda: step64.chunked(
        shl64.radius_padded(lat.radius), chunk=CHUNK), device)
    ref_iters = step64.chunked.last_iterations
    del shl64, step64
    c_err, g_err = _rel(c0, c64), _rel(g0, g64)

    warm_total = sum(warm_s)
    rep = {
        "n": n, "dofs": 6 * lat.num_nodes, "beams": lat.num_edges,
        "build_lattice_s": build_s, "bc_s": bc_s, "setup_s": setup,
        "cold": cold, "warm_s": warm_s, "warm_iterations": warm_it,
        "s_per_step": warm_total / steps,
        "ms_per_iteration": 1e3 * warm_total / max(sum(warm_it), 1),
        "cold_ms_per_iteration": 1e3 * cold_s / max(cold["iterations"], 1),
        "compliance": float(c), "compliance_cold": float(c0),
        "reference": {"compliance": float(c64), "iterations": ref_iters,
                      "s": ref_s, "c_rel_err": c_err, "g_rel_err": g_err},
        "bitwise": bitwise, "finite": _finite(c0, g0, u0, c, g, u),
        "u_shape": list(u.shape),
    }
    if not rep["finite"]:
        raise AssertionError(f"(s1) non-finite result: {rep}")
    if tuple(u.shape) != (6, lat.num_nodes) or g.shape[0] != lat.num_edges:
        raise AssertionError(f"(s1) shapes: u {tuple(u.shape)}, g "
                             f"{tuple(g.shape)}")
    if not bitwise:
        raise AssertionError("(s1) a repeated warm step differs in its bits")
    if not (c_err <= C_TOL and g_err <= G_TOL):
        raise AssertionError(f"(s1) f32 against the f64 reference: c "
                             f"{c_err:.3e} (tol {C_TOL}), g {g_err:.3e} "
                             f"(tol {G_TOL})")

    state = {"r": rr, "u": u}

    def drive(k):
        """One more warm step of the bench's descent."""
        r_k = state["r"]
        _, g_k, state["u"], _ = step.chunked(r_k, state["u"], chunk=CHUNK)
        state["r"] = torch.clamp(r_k - LR * g_k, 0.01, 0.1) * (r_k > 0)
        return step.chunked.last_iterations

    rep["profile_drive"] = drive
    rep["lattice"] = (lat, bc)         # (m1)'s, popped by smoke.run
    return rep


def s2_phase(device: torch.device, small: int = SMALL, seed: int = 5) -> Dict:
    """(s2): the step's other forms at small^3 Octet in float64."""
    lat = build_lattice(bench2_config(small))
    bc = apply_boundary_conditions(lat)
    shl = ShardedLattice(make_mesh(devices=[device]), lat.nodes, lat.edges,
                         E_MOD, NU, dtype=torch.float64)
    step = make_compliance_step(shl, ~bc.fixed, bc.f_applied, tol=S2_TOL,
                                maxiter=20000)
    r = shl.radius_padded(lat.radius)
    c, g = step(r)
    cc, gc, u, _ = step.chunked(r, chunk=CHUNK)
    block_iters = step.chunked.last_iterations
    form_c, form_g = _rel(c, cc), _rel(g, gc)

    v = torch.as_tensor(np.random.default_rng(seed).uniform(
        0.5, 1.5, lat.num_edges), dtype=torch.float64, device=r.device)
    h = FD_REL_STEP * float(r.max())
    cp = step.chunked(r + h * v, u, chunk=CHUNK)[0]
    cm = step.chunked(r - h * v, u, chunk=CHUNK)[0]
    fd = float(cp - cm) / (2.0 * h)
    gv = float(torch.dot(g, v))
    fd_err = abs(gv - fd) / abs(fd)

    r2 = r * 1.1
    cb, gb = step.batch(torch.stack([r, r2]))
    c2, g2 = step(r2)
    batch_bits = _same((cb[0], c), (gb[0], g), (cb[1], c2), (gb[1], g2))
    rd, cd = step.descent_loop(r, 3)
    rh, keep = r, (r > 0).to(r.dtype)
    for _ in range(3):
        ch, gh = step(rh)
        rh = torch.clamp(rh - LR * gh, 0.01, 0.1) * keep
    descent_bits = _same((rd, rh), (cd, ch))

    jac = make_compliance_step(shl, ~bc.fixed, bc.f_applied, tol=S2_TOL,
                               maxiter=20000, preconditioner="jacobi")
    jac.chunked(r, chunk=CHUNK)
    jacobi_iters = jac.chunked.last_iterations

    c_r, g_r = step(r)
    cc_r, gc_r, u_r, _ = step.chunked(r, chunk=CHUNK)
    repeat_bits = _same((c_r, c), (g_r, g), (cc_r, cc), (gc_r, gc), (u_r, u))
    rep = {"n": small, "dofs": 6 * lat.num_nodes, "beams": lat.num_edges,
           "compliance": float(c), "form_c_rel_err": form_c,
           "form_g_rel_err": form_g, "directional": gv,
           "finite_difference": fd, "fd_h": h, "fd_rel_err": fd_err,
           "batch_bits": batch_bits, "descent_bits": descent_bits,
           "block_iterations": block_iters, "jacobi_iterations": jacobi_iters,
           "repeat_bits": repeat_bits, "finite": _finite(c, g, cc, gc, u)}
    if not rep["finite"]:
        raise AssertionError(f"(s2) non-finite result: {rep}")
    if not (form_c <= S2_C_TOL and form_g <= S2_G_TOL):
        raise AssertionError(f"(s2) step against step.chunked: c "
                             f"{form_c:.3e}, g {form_g:.3e}")
    if not fd_err <= S2_FD_TOL:
        raise AssertionError(f"(s2) g.v {gv:.9e} against the central "
                             f"difference {fd:.9e}: {fd_err:.3e}")
    if not (batch_bits and descent_bits and repeat_bits):
        raise AssertionError(f"(s2) bits: batch {batch_bits}, descent "
                             f"{descent_bits}, repeat {repeat_bits}")
    if block_iters > jacobi_iters:
        raise AssertionError(f"(s2) block Jacobi took {block_iters} CG "
                             f"iterations, Jacobi {jacobi_iters}")
    return rep


def _results_agree(a, b, tol) -> Dict:
    """Two ``FEMResult``s: the largest relative gap over u, reaction and
    compliance, and whether their bits are the same."""
    err = max(_rel(a.u, b.u), _rel(a.reaction, b.reaction),
              abs(a.compliance - b.compliance) / abs(b.compliance))
    same = (np.array_equal(a.u, b.u) and np.array_equal(a.reaction,
                                                        b.reaction)
            and a.compliance == b.compliance)
    return {"rel_err": err, "same_bits": same, "ok": err <= tol}


def s3_phase(device: torch.device,
             cells: Tuple[int, int, int] = FLEXION_CELLS) -> Dict:
    """(s3): statics, penalized statics and homogenization, on ``device``
    twice and on the CPU once, in float64."""
    cpu = torch.device("cpu")
    lat = build_lattice(flexion_config(cells))
    cell = build_lattice(OCTET_CELL)
    runs = {
        "solve_fem_lattice": lambda d: solve_fem_lattice(lat, device=d),
        "solve_fem_penalized": lambda d: solve_fem(lat, penalization=True,
                                                   device=d),
    }
    rep = {"cells": list(cells), "dofs": 6 * lat.num_nodes}
    for name, fn in runs.items():
        a, s_dev = _timed(lambda: fn(device), device)
        b = fn(device)
        c, s_cpu = _timed(lambda: fn(cpu), cpu)
        agree = _results_agree(a, c, S3_TOL)
        rep[name] = {"compliance": a.compliance, "iterations": a.iterations,
                     "residual": a.residual, "device_s": s_dev,
                     "cpu_s": s_cpu, "rel_err": agree["rel_err"],
                     "same_bits": _results_agree(a, b, 0.0)["same_bits"]}
        if not (agree["ok"] and rep[name]["same_bits"]):
            raise AssertionError(f"(s3) {name}: {rep[name]}")
    h, s_dev = _timed(lambda: homogenize_cell(cell, device=device), device)
    h2 = homogenize_cell(cell, device=device)
    hc, s_cpu = _timed(lambda: homogenize_cell(cell, device=cpu), cpu)
    rep["homogenize_cell"] = {
        "C00": float(h.C[0, 0]), "Ex": float(h.orthotropic["Ex"]),
        "device_s": s_dev, "cpu_s": s_cpu, "rel_err": _rel(h.C, hc.C),
        "same_bits": bool(np.array_equal(h.C, h2.C)
                          and np.array_equal(h.u_fluct, h2.u_fluct))}
    if not (rep["homogenize_cell"]["rel_err"] <= S3_TOL
            and rep["homogenize_cell"]["same_bits"]):
        raise AssertionError(f"(s3) homogenize_cell: "
                             f"{rep['homogenize_cell']}")
    return rep


def statics_phase(device: torch.device, n: int, steps: int = 8,
                  small: int = SMALL,
                  cells: Tuple[int, int, int] = FLEXION_CELLS) -> Dict:
    """(s1), (s2) and (s3) in order; raises on the first failed gate."""
    return {"s1": s1_phase(device, n, steps),
            "s2": s2_phase(device, small),
            "s3": s3_phase(device, cells)}
