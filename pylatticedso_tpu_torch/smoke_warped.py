"""The warped phase of ``chip_smoke.py``: warped lattices on the card
(``warped_phase``), three cells.

* (w1) the main path on a warped lattice: the n^3 Octet warped by the
  taper and twist of ``tests/test_structured.py:324-330`` stretched over
  the block (z scaled by 2/n inside the taper and twist, the axis at the
  block's centre; ``taper_twist``), clamped at z = 0 with a unit load
  spread over the top face (both faces in unwarped coordinates), float32
  MG-PCG at tol 1e-6 with ``bench.py``'s options on the unfused f32
  V-cycle (a warped level has no fused smoother, in JAX as here), one cold
  step and ``steps`` warm steps with the bench's update.  Gates: a
  repeated step the same bits; at the cold radii c within 1e-5 and g
  within 1e-3 (of max |g|) of a float64 warped step at tol 1e-10; B1w on
  every level and no other stencil or fused kernel; the fused V-cycle on
  it raises, naming the warp.  Then B1w in float32 and float64 and the
  warped r^2-cotangent against their plain versions at every multigrid
  grid (1e-5 / 1e-12, the VJP's 1e-5 / 1e-12), the same bits on repeat,
  timed against their bounds (``warped_kernel_phase``).
* (w2) the warped optimizer: the lattice of
  ``examples/optimization/warped_lattice_optimization.py`` (6x2x2 Octet,
  ``curve_lattice`` and ``move_to_cylinder_form``) through
  ``optimize_lattice`` FEM_AUTO in float64 with SLSQP: it must route to
  the structured problem on the warped operator and lower the compliance
  from the feasible start; value and gradient against the unstructured
  ``OptimizationProblem`` on the same device at rel 1e-9 / 1e-7 (the
  bounds of ``tests/test_structured_optimizer.py:120``); B1w float64 and
  the warped r^2-cotangent launched in the drive, no unwarped kernel.
* (w3) the solid mesh: ``get_relative_density_mesh`` of one BCC cell at
  resolution 72 with the signed distance on the device against the CPU
  (SDF 2e-6 absolute, density 1e-5 relative), and an Octet block at
  resolution 96: time, bytes of one chunk, volume.

Every config is inline (the card's copy of the repo has no ``data/``),
the Octet density fit is the port's ``fits/`` copy.  Each gate raises.
``FULL`` is the card's size, ``SMALL`` the CPU rehearsal's.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import smoke
from .io import solid_mesh
from .kernels.stencil import StencilMatvec
from .parallel.multigrid import mg_apply
from .parallel.structured import (StructuredLattice,
                                  make_structured_compliance_step)

__all__ = ["warped_phase", "w1_phase", "w2_phase", "w3_phase",
           "warped_kernel_phase", "kernel_entries", "log_warped",
           "taper_twist", "FULL", "SMALL"]

FULL = {"n": 50, "steps": 8, "w2_iters": 4, "bcc_res": 72,
        "block": (3, 3, 3), "block_res": 96}
SMALL = {"n": 4, "steps": 2, "w2_iters": 2, "bcc_res": 24,
         "block": (2, 2, 1), "block_res": 24}

TOL, MAXITER = 1e-6, 6000
REF_TOL = 1e-10                  # the float64 reference step
C_TOL, G_TOL = 1e-5, 1e-3        # (w1) f32 against the f64 reference
KERNEL_TOL = {torch.float32: smoke.KERNEL_REL_TOL,
              torch.float64: smoke.KERNEL_F64_TOL}
W2_V_TOL, W2_G_TOL = 1e-9, 1e-7  # (w2) structured against unstructured
SDF_TOL = 2e-6                   # (w3) device SDF against the CPU's
RHO_TOL = 1e-5
LR = 1e-4                        # bench.py's descent step
MG_F32 = dict(smoke.MG_OPTS, **smoke.ROUTES["f32"])
# the routing switches, unset for this phase: the unfused f32 V-cycle and
# the analytic gradient
CLEAN_ENV = dict(PLDSO_MG_FUSED=None, PLDSO_MG_BF16=None,
                 PLDSO_MG_FUSED_COMPUTE=None, PLDSO_GRAD=None,
                 PLDSO_SELFADJOINT=None)
# (w1) and (w2) must launch these; no other stencil or fused kernel
W1_KERNELS = ("B1w",)
W2_KERNELS = ("B1wf64", "VJPw")
# the warped kernels' launch counters on the stencil wrapper, by tag
WARPED_COUNTERS = {"B1w": "launches_warped",
                   "B1wf64": "launches_warped_f64",
                   "VJPw": "launches_vjp_warped"}


def taper_twist(n: int) -> Callable:
    """``tests/test_structured.py``'s smooth non-affine taper and twist
    (every instance its own length and frame) stretched over an n^3 block:
    the taper and the twist read z * 2 / n, about the block's axis."""
    c, k = n / 2.0, 2.0 / n

    def warp(x, y, z):
        zs = k * z
        s = 1.0 + 0.15 * zs
        th = 0.25 * zs
        xc, yc = x - c, y - c
        return (c + s * (np.cos(th) * xc - np.sin(th) * yc),
                c + s * (np.sin(th) * xc + np.cos(th) * yc),
                z + 0.1 * np.sin(x))

    return warp


def _problem(n: int, device, dtype):
    """The warped n^3 Octet, clamped at unwarped z = 0, -1 spread over the
    unwarped top face in Z."""
    sl = StructuredLattice("Octet", (n, n, n), (1.0, 1.0, 1.0), smoke.E_MOD,
                           smoke.NU, dtype=dtype, device=device,
                           node_transform=taper_twist(n))
    z0 = np.stack([sl.class_pos_unwarped[c][2] for c in range(sl.nc)])
    fixed = (z0 == 0.0) & sl.node_valid
    top = (z0 == float(n)) & sl.node_valid
    free = sl.node_valid & ~fixed
    f = np.zeros((sl.nc, 6) + sl.grid)
    for c in range(sl.nc):
        f[c, 2][top[c]] = -1.0 / int(top.sum())
    return sl, free, f


def _zero(ctr) -> None:
    smoke._zero(ctr)
    for ws in ctr["mvs"]:
        for w in ws:
            for attr in WARPED_COUNTERS.values():
                setattr(w, attr, 0)


def _read(ctr) -> Dict[str, List[int]]:
    """Per MG level, the launches of every stencil and fused kernel."""
    out = smoke._read(ctr)
    for tag, attr in WARPED_COUNTERS.items():
        out[tag] = [sum(getattr(w, attr) for w in ws) for ws in ctr["mvs"]]
    return out


def _launch_check(label: str, counts: Dict[str, List[int]], want) -> None:
    """``want`` kernels launched on every level, no other kernel on any."""
    for k, per_level in counts.items():
        for lvl, c in enumerate(per_level):
            if (c > 0) != (k in want):
                raise AssertionError(f"{label}: {k} launched {c} times on "
                                     f"MG level {lvl}: {counts}")


def w1_phase(device: torch.device, n: int, steps: int) -> Dict:
    """(w1): the drive, its gates, the reference and the fused refusal;
    ``hierarchies`` keeps the f32 and f64 steps' levels for the kernel
    checks."""
    cuda = device.type == "cuda"
    t = time.perf_counter()
    sl, free, f = _problem(n, device, torch.float32)
    step = make_structured_compliance_step(
        sl, free, f, tol=TOL, maxiter=MAXITER, precond="mg", mg_opts=MG_F32)
    build_s = time.perf_counter() - t
    ctr = smoke._counters(step)
    _zero(ctr)

    r0 = torch.full((n, n, n), 0.05, dtype=torch.float32, device=device)
    smoke._sync(device)
    t = time.perf_counter()
    pstate = step.precond_state(r0)
    c, g, u = step(r0, None, pstate)
    smoke._sync(device)
    cold_s = time.perf_counter() - t
    cold_iters = step.last_solve["iterations"]
    step(r0 * 1.0005, None, pstate)
    c_b, g_b, _ = step(r0, None, pstate)
    bitwise = smoke._same_bits((c, g), (c_b, g_b))
    rr, uu, warm_s, iters = r0 * 1.001, u, [], []
    for _ in range(steps):
        smoke._sync(device)
        t = time.perf_counter()
        cc, gg, uu = step(rr, uu, pstate)
        smoke._sync(device)
        warm_s.append(time.perf_counter() - t)
        iters.append(step.last_solve["iterations"])
        rr = torch.clamp(rr - LR * gg, 0.01, 0.1)
    counts = _read(ctr)
    plain = smoke._plain_calls(ctr)

    # the fused V-cycle on a warped hierarchy: no level has a fused
    # smoother, and the request raises (JAX warns and runs unfused)
    try:
        mg_apply(step.hierarchy, pstate, fused=True,
                 **{k: v for k, v in smoke.MG_OPTS.items()
                    if k != "power_iters"})
        refusal = None
    except RuntimeError as e:
        refusal = str(e)

    t = time.perf_counter()
    sl64, free64, f64 = _problem(n, device, torch.float64)
    step64 = make_structured_compliance_step(
        sl64, free64, f64, tol=REF_TOL, maxiter=MAXITER, precond="mg",
        mg_opts=MG_F32)
    c64, g64, _u64 = step64(r0.double())
    smoke._sync(device)
    ref_s = time.perf_counter() - t
    c_err = abs(float(c) - float(c64)) / abs(float(c64))
    g_err = float((g.double() - g64).abs().max() / g64.abs().max())
    finite = bool(torch.isfinite(cc) and torch.isfinite(gg).all()
                  and torch.isfinite(uu).all())
    rep = {"n": n, "dofs": 6 * sl.n_nodes, "beams": sl.n_edges,
           "levels": [list(lvl.slat.num_cells)
                      for lvl in step.hierarchy["levels"]],
           "build_s": build_s, "cold_s": cold_s,
           "cold_iterations": cold_iters, "warm_s": warm_s,
           "warm_iterations": iters, "s_per_step": float(np.mean(warm_s)),
           "compliance": float(c), "compliance_f64": float(c64),
           "c_rel_err": c_err, "g_rel_err": g_err, "bitwise": bitwise,
           "reference_iterations": step64.last_solve["iterations"],
           "reference_s": ref_s, "kernel_launches": counts,
           "plain_gather_calls": plain, "fused_refusal": refusal,
           "finite": finite,
           "hierarchies": {torch.float32: step.hierarchy,
                           torch.float64: step64.hierarchy}}
    if not finite:
        raise AssertionError(f"(w1) non-finite step: c {float(cc)}")
    if not bitwise:
        raise AssertionError("(w1) two identical warped steps differ "
                             "bitwise in c or g")
    if not (c_err <= C_TOL and g_err <= G_TOL):
        raise AssertionError(f"(w1) f32 warped step vs f64: c {c_err:.3e} "
                             f"(tol {C_TOL}), g {g_err:.3e} (tol {G_TOL})")
    if refusal is None or "warped (node_transform)" not in refusal:
        raise AssertionError(f"(w1) the fused V-cycle on a warped lattice "
                             f"did not raise naming the warp: {refusal}")
    if cuda:
        _launch_check("(w1)", counts, W1_KERNELS)
        if plain:
            raise AssertionError(f"(w1) the plain gather form ran {plain} "
                                 f"times as an operator")
    return rep


def warped_kernel_phase(device: torch.device, hierarchies: Dict,
                        seed: int = 6) -> List[Dict]:
    """B1w (float32, float64) and the warped r^2-cotangent against their
    plain versions at every multigrid grid of (w1), the levels' own
    operators: limits ``KERNEL_TOL`` and ``smoke.VJP_TOL`` relative to the
    plain result's largest value, the same bits on a second launch, times
    (CUDA events, graph replay, the plain version) and bounds."""
    cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for dt, levels in hierarchies.items():
        storage = "f64" if dt == torch.float64 else "f32"
        item = 8 if dt == torch.float64 else 4
        peak = smoke.PEAK_F64_PER_S if dt == torch.float64 \
            else smoke.PEAK_F32_PER_S
        for i, lvl in enumerate(levels["levels"]):
            sl, mv = lvl.slat, lvl.matvec
            B = mv.apply
            label = f"warped Octet {sl.num_cells[0]}^3 (MG level {i})"
            shape = (sl.nc, 6) + sl.grid
            u = torch.randn(shape, generator=gen, device=device, dtype=dt)
            g = torch.randn(shape, generator=gen, device=device, dtype=dt)
            r = 0.04 + 0.05 * torch.rand(sl.num_cells, generator=gen,
                                         device=device, dtype=dt)
            r2p = mv.prepare(r)
            up, gp = F.pad(u, smoke.PAD), F.pad(g, smoke.PAD)
            for kind in ("matvec", "vjp"):
                if kind == "matvec":
                    kern = (lambda: B.launch(up, r2p)) if cuda \
                        else (lambda: B(u, r2p))
                    plain = lambda: mv.apply_gather(u, r2p)
                    tol, work = KERNEL_TOL[dt], B.work(itemsize=item)
                    plan = B.slab_plan(dt, smoke._index(device))
                else:
                    kern = (lambda: B.launch_vjp(up, gp, r2p)) if cuda \
                        else (lambda: B.vjp_r2(g, u, r2p))
                    plain = lambda: B.plain_vjp_r2(g, u, r2p)
                    tol, work = smoke.VJP_TOL[dt], B.vjp_work(itemsize=item)
                    plan = B.beam_plan(dt, smoke._index(device))
                got = kern()
                same = torch.equal(got, kern())
                abs_err, rel_err = smoke._err(got, plain())
                rec = {"kernel": "B1w" if kind == "matvec" else "VJPw",
                       "case": label, "storage": storage, "variant": kind,
                       "level": i, "max_abs_err": abs_err,
                       "max_rel_err": rel_err, "tol": tol,
                       "same_bits": same, **smoke._bound_of(work, peak),
                       "plan": smoke._plan_rec(plan)}
                if cuda:
                    rec["ms"] = smoke._median_ms(kern, device, reps=7,
                                                 batch=20)
                    rec["device_ms"] = smoke._graph_ms(kern, device)
                    rec["plain_ms"] = smoke._median_ms(plain, device,
                                                       reps=3, batch=2)
                else:
                    rec["ms"] = rec["device_ms"] = None
                    rec["plain_ms"] = smoke._median_ms(plain, device, reps=1)
                out.append(rec)
                if not same:
                    raise AssertionError(f"{rec['kernel']} {storage} on "
                                         f"{label}: two identical launches "
                                         f"differ bitwise")
                if not rel_err <= tol:
                    raise AssertionError(f"{rec['kernel']} {storage} on "
                                         f"{label}: rel err {rel_err:.3e} "
                                         f"> {tol}")
    return out


def _w2_config() -> Dict:
    """``examples/optimization/warped_lattice_optimization.py``'s lattice
    and load, with the optimizer's block: FEM_AUTO, compliance min, one
    radius per cell, relative density at most 0.10."""
    return {
        "geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                     "number_of_cells": {"x": 6, "y": 2, "z": 2},
                     "radii": [0.05], "geom_types": ["Octet"]},
        "boundary_conditions": {
            "Displacement": {"Fixed": {"Surface": ["Xmin"],
                                       "DOF": ["X", "Y", "Z", "RX", "RY",
                                               "RZ"],
                                       "Value": [0, 0, 0, 0, 0, 0]}},
            "Force": {"Load": {"Surface": ["Xmax"], "DOF": ["Z"],
                               "Value": [-0.1]}}},
        "optimization_informations": {
            "simulation_type": "FEM_AUTO", "objective_type": "compliance",
            "objective_function": "min",
            "optimization_parameters": {"type": "unit_cell"},
            "constraints": {"relative_density": {"value": 0.10,
                                                 "mode": "upper"}}}}


def w2_phase(device: torch.device, iters: int) -> Dict:
    """(w2): ``optimize_lattice`` on the warped cantilever; the launch
    counts of the structured problem's wrappers (made inside the drive, at
    0) are read just after it."""
    from .design import build_lattice
    from .design.transforms import curve_lattice, move_to_cylinder_form
    from .opti import optimize_lattice
    from .opti.density import KrigingDensity
    from .opti.optimizer import OptimizationProblem
    from .opti.structured_optimizer import StructuredOptimizationProblem

    cuda = device.type == "cuda"
    model = KrigingDensity.load(smoke.OCTET_DENSITY_FIT)
    lat = build_lattice(_w2_config())
    curve_lattice(lat, center=(3.0, 1.0, 8.0), curvature_strength=0.01)
    move_to_cylinder_form(lat, radius=7.0)
    t = time.perf_counter()
    sp, res = optimize_lattice(lat, driver="slsqp", max_iterations=iters,
                               density_model=model, device=device)
    smoke._sync(device)
    drive_s = time.perf_counter() - t
    if not isinstance(sp, StructuredOptimizationProblem):
        raise AssertionError(f"(w2) FEM_AUTO routed the warped lattice to "
                             f"{type(sp).__name__}")
    if sp._slat.node_transform is None:
        raise AssertionError("(w2) the structured problem is not warped")
    # the problem's one operator (Jacobi, the structured problem's
    # default), read as one level
    counts = _read({"mvs": [[sp._step.matvec.apply]]})
    plain = sp._step.matvec.plain_calls
    start = sp.objective(sp.feasible_x0())

    up = OptimizationProblem(lat, opt_params={"type": "unit_cell"},
                             constraints=lat.config.optimization[
                                 "constraints"],
                             density_model=model, device=device)
    x0 = np.asarray(sp.param.x0) * 0.9 + 0.03
    sp._u_warm = None
    t = time.perf_counter()
    vs, gs = sp._value_and_grad(x0)
    smoke._sync(device)
    vg_s = time.perf_counter() - t
    t = time.perf_counter()
    vu, gu = up._value_and_grad(x0)
    smoke._sync(device)
    vg_u_s = time.perf_counter() - t
    v_err = abs(float(vs) - float(vu)) / abs(float(vu))
    gs64, gu64 = gs.double().cpu(), gu.double().cpu()
    g_err = float(((gs64 - gu64).abs() / gu64.abs().clamp_min(1e-300))
                  .max())
    rep = {"cells": list(lat.config.num_cells), "dofs": 6 * lat.num_nodes,
           "beams": lat.num_edges, "params": sp.param.n_params,
           "routed": type(sp).__name__, "maps": len(lat.node_transforms),
           "drive_s": drive_s, "iterations": res.iterations,
           "objective": res.objective, "feasible_start_objective": start,
           "density": res.density, "message": res.message,
           "evaluations": list(sp.evaluations), "value_rel_err": v_err,
           "grad_rel_err": g_err, "structured_vg_s": vg_s,
           "unstructured_vg_s": vg_u_s, "kernel_launches": counts,
           "plain_gather_calls": plain}
    if not res.objective < start:
        raise AssertionError(f"(w2) SLSQP's objective {res.objective:.9e} "
                             f"is not below the feasible start's "
                             f"{start:.9e}")
    if not (v_err <= W2_V_TOL and g_err <= W2_G_TOL):
        raise AssertionError(f"(w2) warped structured vs unstructured: "
                             f"value {v_err:.3e} (tol {W2_V_TOL}), "
                             f"gradient {g_err:.3e} (tol {W2_G_TOL})")
    if cuda:
        _launch_check("(w2)", counts, W2_KERNELS)
        if plain:
            raise AssertionError(f"(w2) the plain gather form ran {plain} "
                                 f"times as an operator")
    return rep


def w3_phase(device: torch.device, bcc_res: int, block, block_res: int
             ) -> Dict:
    """(w3): the solid mesh's signed distance on the device."""
    from .design import build_lattice

    def cfg(n, geom, r):
        return {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                             "number_of_cells": dict(zip("xyz", n)),
                             "radii": [r], "geom_types": [geom]}}

    bcc = build_lattice(cfg((1, 1, 1), "BCC", 0.08))
    timed = {}
    for dev in (device, torch.device("cpu")):
        smoke._sync(device)
        t = time.perf_counter()
        sdf, _o, _h = solid_mesh.lattice_sdf_grid(bcc, bcc_res, device=dev)
        smoke._sync(device)
        sdf_s = time.perf_counter() - t
        t = time.perf_counter()
        rho = solid_mesh.get_relative_density_mesh(bcc, bcc_res, device=dev)
        timed[dev.type] = (sdf, sdf_s, rho, time.perf_counter() - t)
    sdf_d, sdf_s_d, rho_d, rho_s_d = timed[device.type]
    sdf_c, sdf_s_c, rho_c, rho_s_c = timed["cpu"]
    sdf_err = float(np.abs(sdf_d - sdf_c).max())
    rho_err = abs(rho_d - rho_c) / abs(rho_c)

    blk = build_lattice(cfg(tuple(block), "Octet", 0.05))
    smoke._sync(device)
    t = time.perf_counter()
    sdf_b, origin, spacing = solid_mesh.lattice_sdf_grid(blk, block_res,
                                                         device=device)
    smoke._sync(device)
    block_sdf_s = time.perf_counter() - t
    t = time.perf_counter()
    tris = solid_mesh.marching_tetrahedra(sdf_b, origin, spacing)
    vol = solid_mesh.mesh_volume(tris)
    mesh_s = time.perf_counter() - t
    pb, eb = solid_mesh.sdf_chunks(sdf_b.size, blk.num_edges)
    b = blk.get_lattice_boundary_box()
    rep = {"bcc_resolution": bcc_res, "bcc_points": int(sdf_d.size),
           "sdf_abs_err": sdf_err, "rho_device": rho_d, "rho_cpu": rho_c,
           "rho_rel_err": rho_err, "rho_sum_of_cylinders":
           bcc.get_relative_density(), "sdf_s_device": sdf_s_d,
           "sdf_s_cpu": sdf_s_c, "rho_s_device": rho_s_d,
           "rho_s_cpu": rho_s_c, "block": list(block),
           "block_resolution": block_res, "block_points": int(sdf_b.size),
           "block_beams": blk.num_edges, "block_sdf_s": block_sdf_s,
           "block_mesh_s": mesh_s, "chunk": [pb, eb],
           "chunk_bytes": pb * eb * 3 * 4, "triangles": len(tris),
           "volume": vol, "block_rho": vol / ((b[1] - b[0]) * (b[3] - b[2])
                                              * (b[5] - b[4]))}
    if not sdf_err <= SDF_TOL:
        raise AssertionError(f"(w3) SDF on {device} vs the CPU: "
                             f"{sdf_err:.3e} > {SDF_TOL}")
    if not rho_err <= RHO_TOL:
        raise AssertionError(f"(w3) mesh density on {device} vs the CPU: "
                             f"{rho_err:.3e} > {RHO_TOL}")
    if not (0 < rho_d < rep["rho_sum_of_cylinders"] and vol > 0
            and len(tris) > 0):
        raise AssertionError(f"(w3) mesh density {rho_d} or volume {vol}")
    return rep


def warped_phase(device: torch.device, size: Dict = FULL) -> Dict:
    """(w1)-(w3) in order, under the unfused f32 routing; raises on the
    first failed gate."""
    with smoke._env(**CLEAN_ENV):
        w1 = w1_phase(device, size["n"], size["steps"])
        hier = w1.pop("hierarchies")
        kernels = warped_kernel_phase(device, hier)
        del hier
        w2 = w2_phase(device, size["w2_iters"])
    w3 = w3_phase(device, size["bcc_res"], size["block"], size["block_res"])
    return {"w1": w1, "kernels": kernels, "w2": w2, "w3": w3}


def kernel_entries(rep: Dict) -> List[Dict]:
    """The ``kernels`` entries of B1w float32 (launches of (w1)), B1w
    float64 and the warped r^2-cotangent (launches of (w2)), each headed by
    its fine-grid case (float32 for the r^2-cotangent)."""
    cases = rep["kernels"]
    w1, w2 = rep["w1"]["kernel_launches"], rep["w2"]["kernel_launches"]

    def of(kernel, storage=None):
        return [c for c in cases if c["kernel"] == kernel
                and (storage is None or c["storage"] == storage)]

    src = StencilMatvec.source
    rw = StencilMatvec.replaces_w
    b32, b64, vjp = of("B1w", "f32"), of("B1w", "f64"), of("VJPw")
    return [
        smoke._entry(StencilMatvec.name_w, src, rw, sum(w1["B1w"]), b32,
                     b32[0], w1["B1w"]),
        smoke._entry(StencilMatvec.name_w_f64, src, rw, sum(w2["B1wf64"]),
                     b64, b64[0], w2["B1wf64"]),
        smoke._entry(StencilMatvec.name_vjp_w, src, rw, sum(w2["VJPw"]),
                     vjp, vjp[0], w2["VJPw"])]


def log_warped(rep: Dict, card: str, log: Callable[[str], None]) -> None:
    w1, w2, w3 = rep["w1"], rep["w2"], rep["w3"]
    log(f"warped (w1) {w1['n']}^3 Octet, taper and twist ({w1['dofs']} DOF, "
        f"{w1['beams']} beams, levels {[c[0] for c in w1['levels']]}), f32 "
        f"MG unfused: build {w1['build_s']:.2f} s; cold "
        f"{w1['cold_iterations']} CG iterations in {w1['cold_s']:.3f} s; "
        f"warm s {[round(x, 4) for x in w1['warm_s']]}, iterations "
        f"{w1['warm_iterations']}: {w1['s_per_step']:.4f} s/step; "
        f"compliance {w1['compliance']:.9e} vs f64 "
        f"{w1['compliance_f64']:.9e} ({w1['reference_iterations']} "
        f"iterations at tol {REF_TOL:g}, {w1['reference_s']:.2f} s): c "
        f"{w1['c_rel_err']:.2e} (tol {C_TOL:g}), g {w1['g_rel_err']:.2e} "
        f"(tol {G_TOL:g}); bitwise {w1['bitwise']}; launches "
        f"{ {k: v for k, v in w1['kernel_launches'].items() if any(v)} }; "
        f"plain gather calls {w1['plain_gather_calls']}; fused V-cycle "
        f"refused: ...{w1['fused_refusal'][-150:]} [{card}]")
    for c in rep["kernels"]:
        log(f"{c['kernel']} {c['case']} {c['storage']}: rel err "
            f"{c['max_rel_err']:.2e} (tol {c['tol']:.0e}), same bits "
            f"{c['same_bits']} | kernel {smoke._ms(c['ms'])} (device, graph "
            f"replay {smoke._ms(c['device_ms'])}), plain "
            f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.5f} ms "
            f"({c['bound_by']}, {c['bytes'] / 1e6:.1f} MB) | "
            f"{smoke._plan_text(c['plan'])} [{card}]")
    ev = w2["evaluations"]
    log(f"warped (w2) {w2['cells']} Octet curved + cylinder form "
        f"({w2['maps']} maps, {w2['params']} radii, {w2['dofs']} DOF) "
        f"FEM_AUTO -> {w2['routed']}, f64, SLSQP {w2['iterations']} "
        f"iterations in {w2['drive_s']:.2f} s: objective "
        f"{w2['objective']:.9e} vs the feasible start's "
        f"{w2['feasible_start_objective']:.9e}, density "
        f"{w2['density']:.9f} ({w2['message']}); value-and-gradient s "
        f"{[round(e['seconds'], 4) for e in ev]}; vs unstructured: value "
        f"{w2['value_rel_err']:.2e} (tol {W2_V_TOL:g}), gradient "
        f"{w2['grad_rel_err']:.2e} (tol {W2_G_TOL:g}); structured "
        f"{w2['structured_vg_s']:.3f} s vs unstructured "
        f"{w2['unstructured_vg_s']:.3f} s a value-and-gradient; launches "
        f"{ {k: v for k, v in w2['kernel_launches'].items() if any(v)} } "
        f"[{card}]")
    log(f"warped (w3) BCC cell at resolution {w3['bcc_resolution']} "
        f"({w3['bcc_points']} points): SDF device vs CPU "
        f"{w3['sdf_abs_err']:.2e} (tol {SDF_TOL:g}), "
        f"{w3['sdf_s_device']:.3f} s vs {w3['sdf_s_cpu']:.3f} s; mesh "
        f"density {w3['rho_device']:.9f} vs CPU {w3['rho_cpu']:.9f} "
        f"({w3['rho_rel_err']:.2e}, tol {RHO_TOL:g}; sum of cylinders "
        f"{w3['rho_sum_of_cylinders']:.6f}); Octet {w3['block']} at "
        f"resolution {w3['block_resolution']} ({w3['block_points']} points,"
        f" {w3['block_beams']} beams): SDF {w3['block_sdf_s']:.3f} s in "
        f"chunks of {w3['chunk']} ({w3['chunk_bytes'] / 2 ** 20:.1f} MiB), "
        f"marching tetrahedra {w3['block_mesh_s']:.2f} s, "
        f"{w3['triangles']} triangles, volume {w3['volume']:.6f} "
        f"(density {w3['block_rho']:.6f}) [{card}]")
