"""The mesh phase of ``chip_smoke.py``: the sharded paths on a virtual mesh
of one card (``mesh_phase``), every case held against the one-device port
in the same process.

* (m1) ``bench.py``'s second mode at n^3 (the (s1) lattice: n = 50 gives
  515,151 nodes and 3,030,000 beams) on a 1 x 4 mesh: the edge-sharded f32
  step with block Jacobi, ``step.chunked`` in chunks of 256, one cold and
  ``m1_warm`` warm steps with the bench's update, each against the
  one-device step at the same radii; a warm step repeated, the same bits.
  Then ``step.batch`` of two candidates on a 2 x 4 mesh (one candidate a
  ``dp`` row) against the one-device ``step`` of each, at ``batch_n``^3
  (20: the batch's cold implicit steps, four solves, take ~25 s at 50^3
  on the virtual mesh).
* (m2) the main path at full width on a 1 x 4 mesh: the Octet of
  ``m2_cells`` cells (51 x 50 x 50: the fine grid of 52 points divides by
  4, JAX's "nx = k n_shard - 1"), f32 MG-PCG with the bench's options, tol
  1e-6, on the unfused f32 V-cycle and the fused V-cycle in bf16 storage:
  one cold step (the multigrid state built on the slabs: the sharded
  levels' power iteration reduced in rank order) and ``m2_warm`` warm
  steps (the one-device frozen state), each against the one-device
  implicit step (``step.value_and_grad``); a warm step repeated, the same
  bits.  The fine level runs on slabs (B1, B3, B4 per slab), the coarser
  ones gathered.
* (m3) ``multichip.dryrun_multichip`` on a 2 x 4 mesh (8 shards, as in
  ``MULTICHIP_r05.json``), ``tests/test_sharding.py``'s BCC N=7 MG case in
  f64 on a 2 x 4 mesh, and at ``small_cells`` the lo route (B2 per slab)
  and a warped lattice (B1w per slab) on a 1 x 4 mesh: a cold step each
  (and ``m3_warm`` warm ones).
* the per-slab kernels: B1 (f32, f64), B1w, B2, B3 and B4 on every slab of
  the sharded fine levels of (m2) and (m3), on their halo-exchanged
  inputs, against their plain versions on the same inputs (B1's limits;
  bf16 1e-2), the slabs' B1 gathered against one-device B1 (the same bits:
  each output point's sum is the same), timed.

Gates (each raises): f32 c within 1e-5 and g within 1e-3 (relative L2) of
the one-device step, f64 within 1e-10 / 1e-8; the same bits on a repeated
step; every kernel the drive takes launched on every slab of its sharded
levels; every per-slab launch within its kernel's limit; no NaN.
``FULL`` is the card's size, ``SMALL`` the CPU rehearsal's.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from . import multichip, smoke, smoke_statics, smoke_warped
from .design import build_lattice
from .fem.bc import apply_boundary_conditions
from .parallel.mesh import make_mesh
from .parallel.sharding import ShardedLattice, make_compliance_step
from .parallel.structured import (StructuredLattice,
                                  make_structured_compliance_step,
                                  shard_structured_step)

__all__ = ["mesh_phase", "m1_phase", "m2_phase", "m3_phase",
           "slab_kernel_phase", "annotate_kernels", "log_mesh", "FULL",
           "SMALL", "COUNTERS"]

FULL = {"m1_n": 50, "m1_warm": 2, "batch_n": 20, "m2_cells": (51, 50, 50),
        "m2_warm": 2, "m3_devices": 8, "m3_warm": 0,
        "small_cells": (15, 8, 8)}
SMALL = {"m1_n": 3, "m1_warm": 2, "batch_n": 3, "m2_cells": (7, 4, 4),
         "m2_warm": 1, "m3_devices": 8, "m3_warm": 0,
         "small_cells": (3, 2, 2)}

C_TOL, G_TOL = 1e-5, 1e-3            # f32 against the one-device step
C64_TOL, G64_TOL = 1e-10, 1e-8       # f64 (tests/test_sharding.py's)
TOL, MAXITER, LR = 1e-6, 6000, 1e-4
M2_ROUTES = ("f32", "fused")
# the (m2) route whose sharded and one-device steps are profiled: the
# bench's default (the f32 route's sharded step took 17 s under the
# profiler, and the script's budget is 540 s of 600)
PROFILED = "fused"
# per-slab launch counters, by kernel tag: the stencil wrapper's
# attributes, then the fused smoother's ``launches`` keys
COUNTERS = {**smoke._STENCIL_COUNTERS, **smoke_warped.WARPED_COUNTERS}
FUSED_COUNTERS = smoke.FUSED_TAGS


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-300))


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)


def _timed(fn, device):
    return smoke_statics._timed(fn, device)


# ------------------------------------------------------------- counters
def _wrappers(runner) -> List[List]:
    """Per slab k, the stencil wrappers of the sharded step: the CG
    operator's and every sharded level's slab k."""
    lv = [runner.op] + list(getattr(runner, "slab_levels", []))
    return [[sl.ops[k] for sl in lv] for k in range(runner.n)]


def _gathered(runner) -> List:
    h = runner.h
    return [] if h is None else \
        [lvl.matvec.apply for lvl in h["levels"][runner.n_sharded:]]


def _zero(runner) -> None:
    for w in [w for ws in _wrappers(runner) for w in ws] + _gathered(runner):
        for attr in COUNTERS.values():
            setattr(w, attr, 0)
        for k in w.fused.launches:
            w.fused.launches[k] = 0
        w.fused.b5_launches.clear()
        w.fused.b5_shapes.clear()


def _read(runner) -> Dict:
    """{"per_slab": {tag: [launches on slab k]}, "gathered": {tag: n}}."""
    per = {tag: [sum(getattr(w, a) for w in ws)
                 for ws in _wrappers(runner)] for tag, a in COUNTERS.items()}
    for tag, key in FUSED_COUNTERS.items():
        per[tag] = [sum(w.fused.launches[key] for w in ws)
                    for ws in _wrappers(runner)]
    gat = {tag: sum(getattr(w, a) for w in _gathered(runner))
           for tag, a in COUNTERS.items()}
    for tag, key in FUSED_COUNTERS.items():
        gat[tag] = sum(w.fused.launches[key] for w in _gathered(runner))
    return {"per_slab": {k: v for k, v in per.items() if any(v)},
            "gathered": {k: v for k, v in gat.items() if v}}


def _check_launches(label: str, counts: Dict, want, cuda: bool) -> None:
    """``want`` kernels launched on every slab (on the card)."""
    if not cuda:
        return
    for tag in want:
        got = counts["per_slab"].get(tag, [])
        if not got or min(got) == 0:
            raise AssertionError(f"{label}: {tag} not launched on every "
                                 f"slab: {counts}")


# ------------------------------------------------------------------ (m1)
def m1_phase(device: torch.device, n: int, warm: int, batch_n: int,
             lattice=None) -> Dict:
    """(m1): the edge-sharded step on 1 x 4 and its batch on 2 x 4."""
    if lattice is None:
        lat, build_s = _timed(lambda: build_lattice(
            smoke_statics.bench2_config(n)), device)
        bc = apply_boundary_conditions(lat)
    else:
        (lat, bc), build_s = lattice, 0.0
    one = make_mesh(devices=[device])
    m14 = make_mesh(n_shard=4, devices=[device] * 4)

    def built(mesh, lt, bcs):
        shl = ShardedLattice(mesh, lt.nodes, lt.edges, smoke_statics.E_MOD,
                             smoke_statics.NU, dtype=torch.float32)
        return shl, make_compliance_step(shl, ~bcs.fixed, bcs.f_applied,
                                         tol=TOL, maxiter=MAXITER)

    (shl1, step1), t1 = _timed(lambda: built(one, lat, bc), device)
    (shl4, step4), t4 = _timed(lambda: built(m14, lat, bc), device)
    r = shl1.radius_padded(lat.radius)
    chunk = smoke_statics.CHUNK
    (ref, ref_s) = _timed(lambda: step1.chunked(r, chunk=chunk), device)
    ref_it = step1.chunked.last_iterations
    (got, cold_s) = _timed(lambda: step4.chunked(r, chunk=chunk), device)
    cold_it = step4.chunked.last_iterations
    errs = [(_rel(got[0], ref[0]), _rel_l2(got[1], ref[1]))]
    rr, u1, u4 = r * 1.001, ref[2], got[2]
    warm_s, warm_it, warm_ref_s = [], [], []
    for _ in range(warm):
        prev = (rr, u4)
        ref, s = _timed(lambda: step1.chunked(rr, u1, chunk=chunk), device)
        warm_ref_s.append(s)
        got, s = _timed(lambda: step4.chunked(rr, u4, chunk=chunk), device)
        warm_s.append(s)
        warm_it.append(step4.chunked.last_iterations)
        errs.append((_rel(got[0], ref[0]), _rel_l2(got[1], ref[1])))
        u1, u4 = ref[2], got[2]
        rr = torch.clamp(rr - LR * ref[1], 0.01, 0.1) * (rr > 0)
    again = step4.chunked(*prev, chunk=chunk)
    bitwise = all(torch.equal(a, b) for a, b in zip(got[:3], again[:3]))
    state = {"r": rr, "u": u4}

    def drive(k):
        """One more warm sharded step of the bench's descent."""
        r_k = state["r"]
        _, g_k, state["u"], _ = step4.chunked(r_k, state["u"], chunk=chunk)
        state["r"] = torch.clamp(r_k - LR * g_k, 0.01, 0.1) * (r_k > 0)
        return step4.chunked.last_iterations

    del step1, shl1
    # the batch: two candidates, one a dp row
    if batch_n == n:
        blat, bbc = lat, bc
    else:
        blat = build_lattice(smoke_statics.bench2_config(batch_n))
        bbc = apply_boundary_conditions(blat)
    m24 = make_mesh(n_shard=4, n_dp=2, devices=[device] * 8)
    shl24, step24 = built(m24, blat, bbc)
    shlb, stepb = built(one, blat, bbc)
    rb = shl24.radius_padded(blat.radius)
    cand = torch.stack([rb, rb * 1.2])
    (cb, gb), batch_s = _timed(lambda: step24.batch(cand), device)
    refs = [stepb(rb), stepb(rb * 1.2)]
    batch_err = [(_rel(cb[k], refs[k][0]), _rel_l2(gb[k], refs[k][1]))
                 for k in range(2)]
    rep = {"n": n, "nodes": lat.num_nodes, "beams": lat.num_edges,
           "build_lattice_s": build_s, "setup_one_s": t1, "setup_mesh_s": t4,
           "width": shl4.width,
           "cold_s": cold_s, "cold_iterations": cold_it,
           "reference_cold_s": ref_s, "reference_cold_iterations": ref_it,
           "warm_s": warm_s, "warm_iterations": warm_it,
           "reference_warm_s": warm_ref_s,
           "s_per_step": float(np.mean(warm_s)) if warm_s else None,
           "reference_s_per_step": float(np.mean(warm_ref_s))
           if warm_ref_s else None,
           "errors": errs, "bitwise": bitwise, "batch_n": batch_n,
           "batch_s": batch_s, "batch_errors": batch_err,
           "batch_compliances": [float(x) for x in cb],
           "finite": bool(torch.isfinite(got[1]).all()
                          and torch.isfinite(gb).all()),
           "profile_drive": drive}
    _gate("(m1)", dict(rep, errors=errs + batch_err), C_TOL, G_TOL)
    return rep


# ------------------------------------------------------------------ (m2)
def _block_problem(cells, device, dtype, geom="Octet", warp=None):
    """An Octet block clamped at z = 0, -1 spread over its top face (both
    in unwarped coordinates)."""
    sl = StructuredLattice(geom, tuple(cells), (1.0, 1.0, 1.0), smoke.E_MOD,
                           smoke.NU, dtype=dtype, device=device,
                           node_transform=warp)
    pos = sl.class_pos_unwarped if warp is not None else sl.class_pos
    z0 = np.stack([pos[c][2] for c in range(sl.nc)])
    fixed = (z0 == 0.0) & sl.node_valid
    top = (z0 == float(cells[2])) & sl.node_valid
    free = sl.node_valid & ~fixed
    f = np.zeros((sl.nc, 6) + sl.grid)
    for c in range(sl.nc):
        f[c, 2][top[c]] = -1.0 / int(top.sum())
    return sl, free, f


def _add(acc: Dict, counts: Dict) -> Dict:
    """Launch counts of several windows added."""
    for k, v in counts["per_slab"].items():
        old = acc["per_slab"].get(k, [0] * len(v))
        acc["per_slab"][k] = [a + b for a, b in zip(old, v)]
    for k, v in counts["gathered"].items():
        acc["gathered"][k] = acc["gathered"].get(k, 0) + v
    return acc


def _sharded_drive(step, sstep, r0, warm: int, device) -> Dict:
    """One cold step (the multigrid state built on the slabs) and ``warm``
    warm steps (the one-device frozen state) of the sharded step, each
    against the one-device implicit step at the same radii; the sharded
    steps' launches counted (zeroed just before each, read just after); the
    last warm step repeated."""
    runner = sstep.runner
    zeros = torch.zeros_like(step.operands[1])
    acc = {"per_slab": {}, "gathered": {}}

    def sharded(*args):
        _zero(runner)
        out = sstep(*args)
        smoke._sync(device)
        _add(acc, _read(runner))
        return out

    ref, ref_s = _timed(lambda: step.value_and_grad(r0, zeros, None),
                        device)
    ref_it = [x["iterations"] for x in step.solves()]
    got, cold_s = _timed(lambda: sharded(r0, None, None), device)
    cold_it = [sstep.last_solve["iterations"],
               sstep.last_adjoint["iterations"]]
    errs = [(_rel(got[0], ref[0]), _rel_l2(got[1], ref[1]))]
    cold_u = (ref[2], got[2])
    pstate = step.precond_state(r0)
    rr, u1, us = r0 * 1.001, ref[2], got[2]
    warm_s, warm_it, warm_ref_s = [], [], []
    prev = None
    for _ in range(warm):
        prev = (rr, us)
        got, s = _timed(lambda: sharded(rr, us, pstate), device)
        warm_s.append(s)
        warm_it.append([sstep.last_solve["iterations"],
                        sstep.last_adjoint["iterations"]])
        ref, s = _timed(lambda: step.value_and_grad(rr, u1, pstate), device)
        warm_ref_s.append(s)
        errs.append((_rel(got[0], ref[0]), _rel_l2(got[1], ref[1])))
        u1, us = ref[2], got[2]
        rr = torch.clamp(rr - LR * ref[1], 0.01, 0.1)
    bitwise = None
    if prev is not None:
        again = sstep(prev[0], prev[1], pstate)
        bitwise = bool(torch.equal(again[0], got[0])
                       and torch.equal(again[1], got[1])
                       and torch.equal(again[2].gather(), got[2].gather()))

    def drive(k):
        """A sharded step warm-started from the cold solution at radii
        near the cold ones (frozen state), as ``smoke.profile_phase``
        drives a route; its CG iterations, forward and adjoint."""
        sstep(r0 * (1.0 + 1e-3 * (k + 1)), cold_u[1], pstate)
        return sstep.last_solve["iterations"] \
            + sstep.last_adjoint["iterations"]

    def drive_one(k):
        """The same step on one device."""
        step.value_and_grad(r0 * (1.0 + 1e-3 * (k + 1)), cold_u[0], pstate)
        return sum(x["iterations"] for x in step.solves())

    return {"cold_s": cold_s, "cold_iterations": cold_it,
            "reference_cold_s": ref_s, "reference_cold_iterations": ref_it,
            "warm_s": warm_s, "warm_iterations": warm_it,
            "reference_warm_s": warm_ref_s,
            "s_per_step": float(np.mean(warm_s)) if warm_s else None,
            "reference_s_per_step": float(np.mean(warm_ref_s))
            if warm_ref_s else None,
            "errors": errs, "bitwise": bitwise, "launches": acc,
            "sharded_levels": sstep.n_sharded_levels,
            "grid_axis": sstep.grid_axis,
            "slabs": [list(op.grid) for op in runner.op.ops],
            "finite": bool(torch.isfinite(got[1]).all()
                           and torch.isfinite(got[2].gather()).all()),
            "profile_drive": drive, "one_device": {"profile_drive": drive_one}}


def _gate(label: str, rep: Dict, c_tol: float, g_tol: float) -> None:
    if not rep["finite"]:
        raise AssertionError(f"{label}: non-finite result")
    if rep["bitwise"] is False:
        raise AssertionError(f"{label}: a repeated sharded step differs in "
                             f"its bits")
    for c_err, g_err in rep["errors"]:
        if not (c_err <= c_tol and g_err <= g_tol):
            raise AssertionError(
                f"{label}: sharded against one device: c {c_err:.3e} (tol "
                f"{c_tol}), g {g_err:.3e} (tol {g_tol}); all "
                f"{rep['errors']}")


def _route_kernels(route: str, sharded_levels: int, f64: bool = False,
                   warped: bool = False) -> List[str]:
    """The kernels a sharded drive must launch on every slab: the CG
    operator's B1 and the implicit gradient's r^2-cotangent, and on the
    sharded levels the route's smoother kernels."""
    b1 = ("B1w" if warped else "B1") + ("f64" if f64 else "")
    want = [b1, "VJPw" if warped else "VJP"]
    if sharded_levels:
        if route == "fused":
            want += ["B3", "B4"]
        elif route == "lo":
            want += ["B2"]
    return want


def m2_phase(device: torch.device, cells, warm: int) -> Dict:
    """(m2): the main path on a 1 x 4 mesh, unfused f32 and fused bf16."""
    mesh = make_mesh(n_shard=4, devices=[device] * 4)
    cuda = device.type == "cuda"
    (sl, free, f), build_s = _timed(
        lambda: _block_problem(cells, device, torch.float32), device)
    r0 = torch.full(tuple(cells), 0.05, dtype=torch.float32, device=device)
    out = {"cells": list(cells), "dofs": 6 * sl.n_nodes,
           "beams": sl.n_edges, "build_s": build_s, "routes": {}}
    for route in M2_ROUTES:
        with smoke._env(PLDSO_MG_FUSED_DTYPE=smoke.FUSED_STORAGE,
                        **smoke.ROUTE_ENV[route]):
            step = make_structured_compliance_step(
                sl, free, f, tol=TOL, maxiter=MAXITER, precond="mg",
                mg_opts=dict(smoke.MG_OPTS, **smoke.ROUTES[route]))
            sstep, setup_s = _timed(lambda: shard_structured_step(step, mesh),
                                    device)
            rep = _sharded_drive(step, sstep, r0, warm, device)
        rep["setup_s"] = setup_s
        rep["levels"] = [list(lvl.slat.grid)
                         for lvl in step.hierarchy["levels"]]
        rep["runner"] = sstep.runner
        _gate(f"(m2) [{route}]", rep, C_TOL, G_TOL)
        _check_launches(f"(m2) [{route}]", rep["launches"],
                        _route_kernels(route, rep["sharded_levels"]), cuda)
        out["routes"][route] = rep
    return out


# ------------------------------------------------------------------ (m3)
def m3_phase(device: torch.device, n_devices: int, small_cells,
             log: Callable[[str], None], warm: int = 1) -> Dict:
    """(m3): dryrun_multichip, the BCC N=7 MG case in f64, the lo route and
    a warped lattice at ``small_cells``; each case a cold step and
    ``warm`` warm ones."""
    cuda = device.type == "cuda"
    out = {}
    out["dryrun"], out["dryrun_s"] = _timed(lambda: multichip.dryrun_multichip(
        n_devices, devices=[device] * n_devices, log=log), device)
    # tests/test_sharding.py's MG parity case, f64, on 2 x 4
    N = 7
    sl = StructuredLattice("BCC", (N, 2, 2), (1.0, 1.0, 1.0), smoke.E_MOD,
                           smoke.NU, dtype=torch.float64, device=device)
    free = sl.select_nodes(lambda x, y, z: x > 1e-9)
    f = sl.node_field().astype(np.float64)
    tip = sl.select_nodes(lambda x, y, z: x > N - 1e-9)
    f[:, 2][tip] = -0.1
    step = make_structured_compliance_step(
        sl, free, f, tol=1e-10, maxiter=500, precond="mg",
        mg_opts={"nu": 2, "coarse_degree": 8, "smooth_frac": 0.25,
                 "power_iters": 5})
    sstep = shard_structured_step(step, make_mesh(
        n_shard=4, n_dp=2, devices=[device] * 8))
    r = torch.full((N, 2, 2), 0.05, dtype=torch.float64, device=device)
    rep = _sharded_drive(step, sstep, r, warm, device)
    rep.pop("profile_drive"), rep.pop("one_device")
    rep["runner"] = sstep.runner
    _gate("(m3) BCC N=7 MG f64", rep, C64_TOL, G64_TOL)
    _check_launches("(m3) BCC N=7 MG f64", rep["launches"],
                    _route_kernels("f32", 0, f64=True), cuda)
    out["bcc_f64"] = rep
    # the lo route (B2 per slab) and a warped lattice (B1w per slab)
    mesh = make_mesh(n_shard=4, devices=[device] * 4)
    r0 = torch.full(tuple(small_cells), 0.05, dtype=torch.float32,
                    device=device)
    for case in ("lo", "warped"):
        warp = smoke_warped.taper_twist(small_cells[2]) \
            if case == "warped" else None
        sl, free, f = _block_problem(small_cells, device, torch.float32,
                                     warp=warp)
        route = "lo" if case == "lo" else "f32"
        step = make_structured_compliance_step(
            sl, free, f, tol=TOL, maxiter=MAXITER, precond="mg",
            mg_opts=dict(smoke.MG_OPTS, **smoke.ROUTES[route]))
        sstep = shard_structured_step(step, mesh)
        rep = _sharded_drive(step, sstep, r0, warm, device)
        rep.pop("profile_drive"), rep.pop("one_device")
        rep["runner"] = sstep.runner
        _gate(f"(m3) {case}", rep, C_TOL, G_TOL)
        _check_launches(f"(m3) {case}", rep["launches"],
                        _route_kernels(route, rep["sharded_levels"],
                                       warped=case == "warped"), cuda)
        out[case] = rep
    return out


# ------------------------------------------------------- per-slab kernels
def slab_kernel_phase(device: torch.device, runners: Dict,
                      seed: int = 7) -> List[Dict]:
    """Every per-slab kernel of the sharded fine levels against its plain
    version on the same halo-exchanged slab inputs: B1 (f32 from (m2) f32,
    f64 from (m3)), B1w ((m3) warped), B2 ((m3) lo; bf16), B3 and B4
    ((m2) fused, bf16 storage: a step and a final step); the slabs' B1
    (B1w) gathered against the one-device kernel on the whole field (the
    same bits); a second launch the same bits; times and bounds."""
    cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    bf = torch.bfloat16
    for label, (runner, kinds) in runners.items():
        sl = runner.op
        mv = runner.matvec
        lat = runner.step._parts["lattice"]
        dt = lat.dtype
        shape = (lat.nc, 6) + lat.grid
        r = 0.04 + 0.05 * torch.rand(lat.num_cells, generator=gen,
                                     device=device, dtype=dt)
        r2p = mv.prepare(r)
        u = torch.randn(shape, generator=gen, device=device, dtype=dt)
        us = sl.scatter(u)
        whole = mv.apply(u, r2p)
        for kind in kinds:
            io = bf if kind in ("B2", "B3", "B4") else dt
            aux = sl.padded_r2(r2p.to(io))
            up = sl.exchange(us.to(io))
            per = []
            for k, op in enumerate(sl.ops):
                a, p = aux.parts[k], up.parts[k]
                if kind in ("B1", "B1f64", "B1w", "B2"):
                    kern = lambda: op.apply_padded(p, a)
                    plain = lambda: op.plain_padded(
                        p.to(dt), a.to(dt)).to(io)
                    work = op.work(itemsize=torch.finfo(io).bits // 8)
                    tol = smoke.STORAGE_TOL["bf16"]["B2"] if kind == "B2" \
                        else (smoke.KERNEL_F64_TOL if dt == torch.float64
                              else smoke.KERNEL_REL_TOL)
                else:
                    fz = op.fused
                    fm = torch.ones_like(p)
                    fd = (0.5 + torch.rand(p.shape, generator=gen,
                                           device=device)).to(io)
                    sc = fz.sc(torch.tensor(4.0, device=device), 0.35)
                    if kind == "B3":
                        kern = lambda: fz.residual(p, p, fm, a)
                        plain = lambda: fz.plain_residual(p, p, fm, a)
                        work = fz.work("residual", 2)
                    else:
                        kern = lambda: fz.cheb_run(p, p, p, fd, sc, a, 0.3,
                                                   0.7, False)
                        plain = lambda: fz.plain_cheb_run(
                            p, p, p, fd, sc, a, 0.3, 0.7, False)
                        work = fz.work("cheb_run", 2)
                    tol = smoke.STORAGE_TOL["bf16"][kind]
                got = kern()
                same = smoke._bits_differ(got, kern()) == 0
                abs_err, rel_err = smoke._err(got, plain())
                rec = {"kernel": kind, "case": f"{label} slab {k}",
                       "slab": k, "grid": list(op.grid),
                       "storage": "bf16" if io == bf else str(dt)[6:],
                       "max_abs_err": abs_err, "max_rel_err": rel_err,
                       "tol": tol, "same_bits": same,
                       **smoke._bound_of(work, smoke.PEAK_F64_PER_S
                                         if dt == torch.float64
                                         else smoke.PEAK_F32_PER_S)}
                if cuda:
                    rec["ms"] = smoke._median_ms(kern, device, reps=5,
                                                 batch=10)
                    rec["plain_ms"] = smoke._median_ms(plain, device, reps=3)
                else:
                    rec["ms"] = None
                    rec["plain_ms"] = smoke._median_ms(plain, device, reps=1)
                out.append(rec)
                per.append(got)
                if not same:
                    raise AssertionError(f"{kind} on {rec['case']}: two "
                                         f"launches differ bitwise")
                if not rel_err <= tol:
                    raise AssertionError(f"{kind} on {rec['case']}: rel err "
                                         f"{rel_err:.3e} > {tol}")
            if kind in ("B1", "B1f64", "B1w"):
                gathered = torch.cat([p.to(device) for p in per], dim=sl.dim)
                differ = smoke._bits_differ(gathered, whole)
                out[-1]["gathered_bits_differ"] = differ
                if differ:
                    raise AssertionError(f"{kind} {label}: the slabs' "
                                         f"results gathered differ from the "
                                         f"one-device launch in {differ} "
                                         f"elements")
    return out


# ---------------------------------------------------------------- phase
def mesh_phase(device: torch.device, size: Dict = FULL,
               log: Callable[[str], None] = print,
               lattice=None) -> Dict:
    """(m1)-(m3) and the per-slab kernels, in order; raises on the first
    failed gate.  ``lattice`` may pass (m1)'s built lattice and BCs (the
    statics phase's)."""
    t = time.perf_counter()
    parts_s = {}
    with smoke._env(**smoke_warped.CLEAN_ENV):
        m1, parts_s["m1"] = _timed(lambda: m1_phase(
            device, size["m1_n"], size["m1_warm"], size["batch_n"],
            lattice=lattice), device)
        m2, parts_s["m2"] = _timed(lambda: m2_phase(
            device, size["m2_cells"], size["m2_warm"]), device)
        m3, parts_s["m3"] = _timed(lambda: m3_phase(
            device, size["m3_devices"], size["small_cells"], log,
            size["m3_warm"]), device)
        runners = {
            "(m2) f32 fine level": (m2["routes"]["f32"]["runner"], ["B1"]),
            "(m2) fused fine level": (m2["routes"]["fused"]["runner"],
                                      ["B3", "B4"]),
            "(m3) BCC N=7 f64": (m3["bcc_f64"]["runner"], ["B1f64"]),
            "(m3) lo": (m3["lo"]["runner"], ["B2"]),
            "(m3) warped": (m3["warped"]["runner"], ["B1w"])}
        with smoke._env(PLDSO_MG_FUSED_DTYPE=smoke.FUSED_STORAGE):
            kernels, parts_s["kernels"] = _timed(
                lambda: slab_kernel_phase(device, runners), device)
    for rep in (m2["routes"]["f32"], m2["routes"]["fused"], m3["bcc_f64"],
                m3["lo"], m3["warped"]):
        rep.pop("runner")
    return {"m1": m1, "m2": m2, "m3": m3, "kernels": kernels,
            "parts_s": parts_s, "s": time.perf_counter() - t}


# --------------------------------------------------------------- report
_TAGS = {"stencil_matvec_f32": "B1", "stencil_matvec_f64": "B1f64",
         "stencil_matvec_bf16": "B2", "stencil_vjp_r2": "VJP",
         "stencil_matvec_warped_f32": "B1w",
         "stencil_matvec_warped_f64": "B1wf64",
         "stencil_vjp_r2_warped": "VJPw",
         "mg_residual": "B3", "mg_cheb_run": "B4"}


def _drives(rep: Dict) -> Dict[str, Dict]:
    out = {f"(m2) {k}": v for k, v in rep["m2"]["routes"].items()}
    out.update({f"(m3) {k}": rep["m3"][k] for k in ("bcc_f64", "lo",
                                                     "warped")})
    return out


def annotate_kernels(entries: List[Dict], rep: Dict) -> List[Dict]:
    """The ``kernels`` entries with the mesh phase added: per kernel, its
    launches per slab summed over the sharded drives
    (``launches_per_slab``; by drive in ``launches_mesh``), added to
    ``launches``, and the per-slab checks among its cases (its errors
    folded into ``max_abs_err`` / ``max_rel_err``)."""
    for e in entries:
        tag = _TAGS.get(e["name"])
        if tag is None:
            continue
        by_drive, total = {}, None
        for label, d in _drives(rep).items():
            v = d["launches"]["per_slab"].get(tag)
            if v:
                by_drive[label] = v
                total = v if total is None else [a + b for a, b
                                                 in zip(total, v)]
        if total is None:
            continue
        e["launches_per_slab"] = total
        e["launches_mesh"] = by_drive
        e["launches"] = int(e["launches"]) + int(sum(total))
        cases = [c for c in rep["kernels"] if c["kernel"] == tag]
        if cases:
            e["max_abs_err"] = max([e["max_abs_err"]]
                                   + [c["max_abs_err"] for c in cases])
            e["max_rel_err"] = max([e["max_rel_err"]]
                                   + [c["max_rel_err"] for c in cases])
            e["cases"] = e["cases"] + [
                {k: c.get(k) for k in ("case", "storage", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "max_rel_err")} for c in cases]
    return entries


def log_mesh(rep: Dict, card: str, log: Callable[[str], None]) -> None:
    m1, m2, m3 = rep["m1"], rep["m2"], rep["m3"]
    log(f"mesh (m1) bench.py's second mode {m1['n']}^3 Octet "
        f"({m1['nodes']} nodes, {m1['beams']} beams) on 1 x 4: cold "
        f"{m1['cold_iterations']} CG iterations in {m1['cold_s']:.3f} s (one "
        f"device {m1['reference_cold_iterations']} in "
        f"{m1['reference_cold_s']:.3f} s); warm s "
        f"{[round(x, 4) for x in m1['warm_s']]} (one device "
        f"{[round(x, 4) for x in m1['reference_warm_s']]}), iterations "
        f"{m1['warm_iterations']}; c / g (rel L2) vs one device "
        f"{[(f'{a:.1e}', f'{b:.1e}') for a, b in m1['errors']]} (tol "
        f"{C_TOL:g} / {G_TOL:g}); repeat bitwise {m1['bitwise']}; batch of 2 "
        f"on 2 x 4 at {m1['batch_n']}^3 {m1['batch_s']:.2f} s, errors "
        f"{[(f'{a:.1e}', f'{b:.1e}') for a, b in m1['batch_errors']]}; "
        f"setup one device {m1['setup_one_s']:.2f} s, mesh "
        f"{m1['setup_mesh_s']:.2f} s [{card}]")
    for route, r in m2["routes"].items():
        log(f"mesh (m2) [{route}] {m2['cells']} Octet ({m2['dofs']} DOF) on "
            f"1 x 4, slabs {r['slabs'][0]} along axis {r['grid_axis']}, "
            f"sharded levels {r['sharded_levels']} of {len(r['levels'])}: "
            f"cold {r['cold_s']:.3f} s, CG forward/adjoint "
            f"{r['cold_iterations']} (one device {r['reference_cold_s']:.3f} "
            f"s, {r['reference_cold_iterations']}); warm s "
            f"{[round(x, 4) for x in r['warm_s']]} (one device "
            f"{[round(x, 4) for x in r['reference_warm_s']]}), iterations "
            f"{r['warm_iterations']}; c / g vs one device "
            f"{[(f'{a:.1e}', f'{b:.1e}') for a, b in r['errors']]}; repeat "
            f"bitwise {r['bitwise']}; launches per slab "
            f"{r['launches']['per_slab']}, gathered "
            f"{r['launches']['gathered']} [{card}]")
    for name, rec in m3["dryrun"].items():
        if name != "mesh":
            log(f"mesh (m3) dryrun {name}: rel {rec['rel']:.2e} "
                f"({rec['s']:.2f} s) [{card}]")
    for case in ("bcc_f64", "lo", "warped"):
        r = m3[case]
        log(f"mesh (m3) {case}: sharded levels {r['sharded_levels']}, c / g "
            f"{[(f'{a:.1e}', f'{b:.1e}') for a, b in r['errors']]}, "
            f"bitwise {r['bitwise']}, launches per slab "
            f"{r['launches']['per_slab']} [{card}]")
    for c in rep["kernels"]:
        extra = "" if "gathered_bits_differ" not in c else \
            f"; slabs gathered vs one device: {c['gathered_bits_differ']} " \
            f"elements differ"
        log(f"{c['kernel']} {c['case']} {c['grid']} {c['storage']}: rel err "
            f"{c['max_rel_err']:.2e} (tol {c['tol']:.0e}), same bits "
            f"{c['same_bits']} | kernel {smoke._ms(c['ms'])}, plain "
            f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.5f} ms "
            f"({c['bound_by']}){extra} [{card}]")
    log(f"mesh phase {rep['s']:.1f} s "
        f"({ {k: round(v, 1) for k, v in rep['parts_s'].items()} }) "
        f"[{card}]")
