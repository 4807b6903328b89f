"""Phases of ``chip_smoke.py``: build the kernels, hold each against its
plain version, and drive the main path once.

The main path is ``bench.py``'s protocol (``run_structured``) on the
port: an n^3 Octet ``StructuredLattice`` clamped at z = 0 with a unit load
spread over the top face, warm-started f32 CG to tol 1e-6 preconditioned by
the multigrid V-cycle (nu=(1, 2), coarse degree 24, smooth_frac 0.35, 5
power iterations, frozen state refreshed every 8 steps), then the analytic
compliance gradient for every cell radius.

``run(device, n)`` runs every phase and returns a report; it raises on the
first failure.  ``chip_smoke.py`` calls it with ``device="cuda"``, n = 50;
the CPU tests rehearse it at n = 4, where each wrapper runs its plain
version and nothing is timed as a device number.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .fem.solve import pcg
from .kernels import build
from .kernels.stencil import StencilMatvec
from .parallel.multigrid import _coarsen_cells, mg_apply
from .parallel.structured import (StructuredLattice,
                                  make_structured_compliance_step)

__all__ = ["run", "MG_OPTS"]

MG_OPTS = {"nu": (1, 2), "coarse_degree": 24, "smooth_frac": 0.35,
           "power_iters": 5}
E_MOD, NU = 1013.0, 0.3
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
KERNEL_REL_TOL = 1e-5        # summation order differs from the plain form
RESIDUAL_TOL = 1e-5
HYBRID = ["BCC", "Hybrid1", "Hybrid4"]


class Budget:
    """Wall-clock budget checked between phases; passing it fails loudly."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def check(self, phase: str) -> None:
        if self.elapsed() > self.seconds:
            raise RuntimeError(f"wall budget of {self.seconds:.0f} s passed "
                               f"after phase '{phase}' "
                               f"({self.elapsed():.1f} s)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_ms(fn: Callable, device: torch.device, reps: int,
               batch: int = 1, flush: Optional[torch.Tensor] = None) -> float:
    """Median over ``reps`` samples of the time per call.  On the card a
    sample is CUDA events around ``batch`` back-to-back calls (so the host's
    launch cost hides behind the device's work), with the 50 MB L2 flushed
    before it when ``flush`` is given; on the CPU (rehearsal only) the host
    clock."""
    fn()                                    # warm-up
    _sync(device)
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(batch):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / batch)
        else:
            t = time.perf_counter()
            for _ in range(batch):
                fn()
            times.append(1e3 * (time.perf_counter() - t) / batch)
    return float(np.median(times))


def device_phase(device: torch.device) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "nvidia_smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    idx = device.index or 0
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(idx),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi[idx] if idx < len(smi) else smi[0]}


def build_phase(device: torch.device) -> Dict:
    if device.type != "cuda":
        return {"seconds": None, "per_source": {}, "ptxas": {}}
    t = time.perf_counter()
    per = build.build_all()
    return {"seconds": time.perf_counter() - t, "per_source": per,
            "ptxas": dict(build.build_log)}


def _bound(wrapper) -> Dict:
    nbytes, ops = wrapper.work()
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return {"bytes": nbytes, "ops": ops, "bound_ms": 1e3 * max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def level_cells(n: int, min_cells: int = 3) -> List[int]:
    """Cells per side of every multigrid level of an n^3 lattice (the
    coarsening rule of ``build_mg_hierarchy``)."""
    out = [n]
    while out[-1] > min_cells:
        out.append(_coarsen_cells((out[-1],) * 3)[0])
    return out


def kernel_phase(device: torch.device, n: int, seed: int = 0) -> List[Dict]:
    """B1 against its plain version, in f32, at the fine grid and every
    multigrid level's grid of the main path, and on a small hybrid."""
    cases = [("Octet", c, 2.0 ** i, f"Octet {c}^3 (MG level {i})")
             for i, c in enumerate(level_cells(n))]
    cases.append((HYBRID, min(n, 6), 1.0,
                  f"{'+'.join(HYBRID)} {min(n, 6)}^3"))
    flush = (torch.empty(64 << 20, dtype=torch.uint8, device=device)
             if device.type == "cuda" else None)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for geom, cells, h, label in cases:
        sl = StructuredLattice(geom, (cells,) * 3, (h, h, h), E_MOD, NU,
                               dtype=torch.float32, device=device)
        mv, _ = sl.make_matvec()
        u = torch.randn((sl.nc, 6) + sl.grid, generator=gen, device=device)
        r = 0.04 + 0.05 * torch.rand((sl.n_geom,) + (cells,) * 3,
                                     generator=gen, device=device)
        r2p = mv.prepare(r)
        y_plain = mv.apply_gather(u, r2p)
        y_kern = mv.apply(u, r2p)
        _sync(device)
        abs_err = float((y_kern - y_plain).abs().max())
        rel_err = abs_err / float(y_plain.abs().max())
        if not rel_err <= KERNEL_REL_TOL:
            raise AssertionError(f"B1 disagrees with its plain version on "
                                 f"{label}: rel err {rel_err:.3e} > "
                                 f"{KERNEL_REL_TOL}")
        rec = {"case": label, "grid": list(sl.grid), "nc": sl.nc,
               "n_sides": mv.apply.n_sides, "max_abs_err": abs_err,
               "max_rel_err": rel_err, **_bound(mv.apply)}
        if device.type == "cuda":
            up = F.pad(u, (1, 1, 1, 1, 1, 1))
            launch = lambda: mv.apply.launch(up, r2p)
            # ms: back-to-back launches; ms_cold: one launch after an L2
            # flush (for small grids this includes the host's launch gap)
            rec["ms"] = _median_ms(launch, device, reps=7, batch=50)
            rec["ms_cold"] = _median_ms(launch, device, reps=21, flush=flush)
            rec["wrapper_ms"] = _median_ms(lambda: mv.apply(u, r2p), device,
                                           reps=7, batch=50)
            rec["plain_ms"] = _median_ms(lambda: mv.apply_gather(u, r2p),
                                         device, reps=5, batch=5)
        else:
            rec["ms"] = rec["ms_cold"] = rec["wrapper_ms"] = None
            rec["plain_ms"] = _median_ms(lambda: mv.apply_gather(u, r2p),
                                         device, reps=1)
        out.append(rec)
    return out


def _bench_problem(n: int, device, dtype):
    sl = StructuredLattice("Octet", (n, n, n), (1.0, 1.0, 1.0), E_MOD, NU,
                           dtype=dtype, device=device)
    fixed = sl.select_nodes(lambda x, y, z: z == 0.0)
    top = sl.select_nodes(lambda x, y, z: z == float(n))
    free = sl.node_valid & ~fixed
    f = np.zeros((sl.nc, 6) + sl.grid, dtype=np.float32)
    n_top = int(top.sum())
    for c in range(sl.nc):
        f[c, 2][top[c]] = -1.0 / n_top
    return sl, free, f


def main_path_phase(device: torch.device, n: int, steps: int = 8,
                    windows: int = 3, refresh: int = 8, tol: float = 1e-6,
                    maxiter: int = 6000) -> Dict:
    """``bench.py``'s protocol on the port's step; launch counts of every
    level's B1 wrapper are zeroed just before and read just after."""
    t_build = time.perf_counter()
    sl, free, f = _bench_problem(n, device, torch.float32)
    step = make_structured_compliance_step(sl, free, f, tol=tol,
                                           maxiter=maxiter, precond="mg",
                                           mg_opts=MG_OPTS)
    build_s = time.perf_counter() - t_build
    levels = step.hierarchy["levels"]
    # the outer CG matvec is the fine level's operator too
    wrappers = [[step.matvec.apply, levels[0].matvec.apply]] \
        + [[lvl.matvec.apply] for lvl in levels[1:]]
    for ws in wrappers:
        for w in ws:
            w.launches = 0

    r0 = torch.full((n, n, n), 0.05, dtype=torch.float32, device=device)
    t_cold = time.perf_counter()
    pstate = step.precond_state(r0)
    c, g, u = step(r0, None, pstate)
    _sync(device)
    cold_s = time.perf_counter() - t_cold
    cold_iters = step.last_solve["iterations"]
    # bitwise repeat, with a distinct call in between
    step(r0 * 1.0005, None, pstate)
    c_b, g_b, _ = step(r0, None, pstate)
    _sync(device)
    bitwise = (c.cpu().numpy().tobytes() == c_b.cpu().numpy().tobytes()
               and g.cpu().numpy().tobytes() == g_b.cpu().numpy().tobytes())

    lr = 1e-4
    window_s, iters = [], []
    for rep in range(windows):
        rr = r0 * (1.0 + 1e-3 * (rep + 1))
        cc, uu = c, u
        _sync(device)
        t1 = time.perf_counter()
        for k in range(steps):
            if refresh > 0 and k > 0 and k % refresh == 0:
                pstate = step.precond_state(rr)
            cc, gg, uu = step(rr, uu, pstate)
            iters.append(step.last_solve["iterations"])
            r_used = rr
            rr = torch.clamp(rr - lr * gg, 0.01, 0.1)
        _sync(device)
        window_s.append(time.perf_counter() - t1)
    launches = [sum(w.launches for w in ws) for ws in wrappers]

    # true residual of the last solve, with the plain operator in f64
    sl64 = StructuredLattice("Octet", (n, n, n), (1.0, 1.0, 1.0), E_MOD, NU,
                             dtype=torch.float64, device=device)
    mv64, _ = sl64.make_matvec()
    fr = torch.as_tensor(np.ascontiguousarray(
        np.broadcast_to(free[:, None], f.shape), np.float64), device=device)
    b = fr * torch.as_tensor(f, dtype=torch.float64, device=device)
    nb = torch.linalg.vector_norm(b)

    def A64(v, r):
        return fr * mv64.apply_gather(fr * v, mv64.prepare(
            r.to(torch.float64))) + (1.0 - fr) * v

    def rel_res(v, r):
        return float(torch.linalg.vector_norm(A64(v, r) - b) / nb)

    with torch.no_grad():
        u64 = uu.to(torch.float64)
        true_res = rel_res(u64, r_used)
        cold_res = rel_res(u.to(torch.float64), r0)
        # the f32 floor: a relative perturbation of 2^-24 per entry of u
        # (about the rounding of u to f32) moves the residual by this much
        gen = torch.Generator(device=device).manual_seed(1)
        eta = torch.randn(u64.shape, generator=gen, device=device,
                          dtype=torch.float64) * 2.0 ** -24
        floor_u = float(torch.linalg.vector_norm(A64(u64 * eta, r_used)) / nb)
        rec_res = float(step.last_solve["residual_norm"]) / float(nb)
        # f64 reference: mixed-precision refinement of the last solve
        # (f64 residual with the plain operator, f32 correction solve with
        # the step's own operator and preconditioner)
        fr32 = fr.float()
        aux = step.matvec.prepare(r_used)
        A32 = lambda v: fr32 * step.matvec.apply(fr32 * v, aux) \
            + (1.0 - fr32) * v
        M = mg_apply(step.hierarchy, pstate,
                     **{k: v for k, v in MG_OPTS.items()
                        if k != "power_iters"})
        u_ref = u64.clone()
        for _ in range(3):
            res = b - A64(u_ref, r_used)
            scale = torch.linalg.vector_norm(res)
            e = pcg(A32, (res / scale).float(), M=M, tol=tol,
                    maxiter=maxiter).x
            u_ref = u_ref + scale * fr * e.double()
        ref_res = rel_res(u_ref, r_used)
        c_ref = float(torch.sum(b * u_ref))
        c_err = abs(float(cc) - c_ref) / abs(c_ref)
        u_err = float(torch.linalg.vector_norm(u64 - u_ref)
                      / torch.linalg.vector_norm(u_ref))

    finite = bool(torch.isfinite(cc) and torch.isfinite(gg).all()
                  and torch.isfinite(uu).all())
    report = {
        "n": n, "dofs": 6 * sl.n_nodes, "beams": sl.n_edges,
        "levels": [list(lvl.slat.num_cells) for lvl in levels],
        "host_build_s": build_s, "cold_step_s": cold_s,
        "cold_iterations": cold_iters, "warm_iterations": iters,
        "window_s": window_s, "s_per_step": min(window_s) / steps,
        "compliance": float(cc), "compliance_cold": float(c),
        "true_rel_residual": true_res, "cold_true_rel_residual": cold_res,
        "recurrence_rel_residual": rec_res, "f32_floor_rel_residual": floor_u,
        "reference_rel_residual": ref_res, "compliance_reference": c_ref,
        "compliance_rel_err": c_err, "u_rel_err": u_err, "bitwise": bitwise,
        "finite": finite, "launches_per_level": launches,
        "grad_shape": list(gg.shape),
    }
    if not finite:
        raise AssertionError(f"non-finite main-path result: {report}")
    if tuple(gg.shape) != (n, n, n) or tuple(uu.shape) != f.shape:
        raise AssertionError(f"main-path shapes: g {tuple(gg.shape)}, "
                             f"u {tuple(uu.shape)}")
    if not rec_res <= tol:
        raise AssertionError(f"CG stopped at recurrence residual "
                             f"{rec_res:.3e} > tol {tol}")
    # an f32 solution cannot have a true residual below its own rounding
    # floor (which passes 1e-5 near 50^3); the bound is 1e-5 or twice the
    # measured floor, and the solution itself is held to 1e-5 against the
    # refined f64 reference
    res_bound = max(RESIDUAL_TOL, 2.0 * floor_u)
    if not true_res <= res_bound:
        raise AssertionError(f"true relative residual {true_res:.3e} > "
                             f"{res_bound:.3e}")
    if not ref_res <= 1e-10:
        raise AssertionError(f"f64 reference did not converge: residual "
                             f"{ref_res:.3e}")
    if not (c_err <= RESIDUAL_TOL and u_err <= RESIDUAL_TOL):
        raise AssertionError(f"f32 step vs f64 reference: compliance "
                             f"{c_err:.3e}, u {u_err:.3e} > {RESIDUAL_TOL}")
    if not bitwise:
        raise AssertionError("two identical steps differ bitwise in c or g")
    if device.type == "cuda" and not all(x > 0 for x in launches):
        raise AssertionError(f"B1 not launched on every MG level: "
                             f"{launches}")
    return report


def profile_phase(device: torch.device, n: int, steps: int = 2) -> Dict:
    """Device time by kernel over ``steps`` warm-started steps of the main
    path (frozen state), from ``torch.profiler``: the busy share of the
    window's wall clock and the kernels that take the most device time.
    The profiler's own host cost lengthens the wall clock."""
    from torch.profiler import ProfilerActivity, profile

    sl, free, f = _bench_problem(n, device, torch.float32)
    step = make_structured_compliance_step(sl, free, f, tol=1e-6,
                                           maxiter=6000, precond="mg",
                                           mg_opts=MG_OPTS)
    r = torch.full((n, n, n), 0.05, dtype=torch.float32, device=device)
    pstate = step.precond_state(r)
    _, _, u = step(r, None, pstate)
    _sync(device)
    iters = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t = time.perf_counter()
        for k in range(steps):
            step(r * (1.0 + 1e-3 * (k + 1)), u, pstate)
            iters.append(step.last_solve["iterations"])
        _sync(device)
        wall = time.perf_counter() - t
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies, fills): the host ops
        # that launched them carry the same device time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda x: -x[1])
    busy_ms = sum(x[1] for x in rows)
    return {"steps": steps, "iterations": iters, "wall_ms": 1e3 * wall,
            "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / (1e3 * wall),
            "top": [{"name": k, "ms": ms, "count": c}
                    for k, ms, c in rows[:20]]}


def kernels_line(cases: List[Dict], main: Dict) -> List[Dict]:
    """The ``kernels`` entries: the fine-grid case's numbers, the launches
    of the main path and the worst error over every case."""
    fine = cases[0]
    return [{
        "name": StencilMatvec.name,
        "route": "cuda",
        "source": StencilMatvec.source,
        "replaces": StencilMatvec.replaces,
        "launches": int(sum(main["launches_per_level"])),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_rel_err": max(c["max_rel_err"] for c in cases),
        "ms": fine["ms"], "plain_ms": fine["plain_ms"],
        "bound_ms": fine["bound_ms"], "bound_by": fine["bound_by"],
        "library_ms": None,
        "launches_per_level": main["launches_per_level"],
        "cases": [{k: c[k] for k in ("case", "ms", "ms_cold", "wrapper_ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "max_rel_err")}
                  for c in cases],
    }]


def run(device="cuda", n: int = 50, steps: int = 8, windows: int = 3,
        budget_s: float = 600.0, log: Callable[[str], None] = print) -> Dict:
    """Every phase in order; raises on the first failure."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the smoke run needs the card")
    budget = Budget(budget_s)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = device_phase(dev)
    log(f"device: {info['kind']} x{info['count']} | {info['nvidia_smi']}")
    budget.check("device")

    built = build_phase(dev)
    if built["seconds"] is not None:
        log(f"build: {built['seconds']:.1f} s "
            f"{ {k: round(v, 1) for k, v in built['per_source'].items()} }")
        for name, text in built["ptxas"].items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"ptxas {name}: {line.strip()}")
    budget.check("build")

    cases = kernel_phase(dev, n)
    for c in cases:
        log(f"B1 {c['case']}: rel err {c['max_rel_err']:.2e} | kernel "
            f"{c['ms']} ms (after L2 flush {c['ms_cold']} ms, wrapper "
            f"{c['wrapper_ms']} ms), plain {c['plain_ms']:.3f} ms, bound "
            f"{c['bound_ms']:.5f} ms ({c['bound_by']})")
    budget.check("kernels")

    main = main_path_phase(dev, n, steps=steps, windows=windows)
    log(f"main path {n}^3 Octet ({main['dofs']} DOF, {main['beams']} beams, "
        f"levels {[c[0] for c in main['levels']]}): cold "
        f"{main['cold_iterations']} CG iters in {main['cold_step_s']:.2f} s; "
        f"warm iters {main['warm_iterations']}; "
        f"{main['s_per_step']:.4f} s/step (windows "
        f"{[round(w, 3) for w in main['window_s']]}); compliance "
        f"{main['compliance']:.6e}; true rel residual "
        f"{main['true_rel_residual']:.2e} (f32 floor "
        f"{main['f32_floor_rel_residual']:.2e}, recurrence "
        f"{main['recurrence_rel_residual']:.2e}); vs f64 reference: "
        f"compliance {main['compliance_rel_err']:.2e}, u "
        f"{main['u_rel_err']:.2e}; bitwise {main['bitwise']}; "
        f"B1 launches per level {main['launches_per_level']}")
    budget.check("main path")
    return {"device": info, "build": built, "cases": cases, "main": main,
            "kernels": kernels_line(cases, main),
            "wall_s": budget.elapsed()}
