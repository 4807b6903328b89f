"""Phases of ``chip_smoke.py``: build the kernels, hold each against its
plain version, and drive the main path once on each of its routes.

The main path is ``bench.py``'s protocol (``run_structured``) on the
port: an n^3 Octet ``StructuredLattice`` clamped at z = 0 with a unit load
spread over the top face, warm-started f32 CG to tol 1e-6 preconditioned by
the multigrid V-cycle (nu=(1, 2), coarse degree 24, smooth_frac 0.35, 5
power iterations, frozen state refreshed every 8 steps), then the analytic
compliance gradient for every cell radius.  Its routes (``ROUTES``):

* ``fused``: the bench's default (``PLDSO_MG_FUSED=1``, bf16 smoother
  storage): B1 for every CG K.p and power iteration, B3 + B4 on the levels
  the routing leaves multi-program, B5 on the single ones;
* ``lo``: the bench's ``BENCH_MG_FUSED=0`` route (``PLDSO_MG_BF16=1``):
  the unfused V-cycle with every smoother matvec in B2;
* ``f32``: the library default, the unfused f32 V-cycle (B1 everywhere).

``run(device, n)`` runs every phase and returns a report; it raises on the
first failure.  ``chip_smoke.py`` calls it with ``device="cuda"``, n = 50;
the CPU tests rehearse it at n = 4, where each wrapper runs its plain
version and nothing is timed as a device number.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .fem.solve import pcg
from .kernels import build
from .kernels.fused import KERNELS as FUSED_KERNELS
from .kernels.fused import FusedSmoother, cheb_static
from .kernels.stencil import StencilMatvec
from .parallel.multigrid import _coarsen_cells, _estimate_lmax, mg_apply
from .parallel.structured import (StructuredLattice,
                                  make_structured_compliance_step)

__all__ = ["run", "MG_OPTS", "ROUTES"]

MG_OPTS = {"nu": (1, 2), "coarse_degree": 24, "smooth_frac": 0.35,
           "power_iters": 5}
# the V-cycle switches of each route, explicit so that the caller's
# environment cannot change the route
ROUTES = {"fused": {"fused": True, "lo_smoother": False},
          "lo": {"fused": False, "lo_smoother": True},
          "f32": {"fused": False, "lo_smoother": False}}
FUSED_STORAGE = "bf16"       # bench.py's default PLDSO_MG_FUSED_DTYPE
E_MOD, NU = 1013.0, 0.3
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
KERNEL_REL_TOL = 1e-5        # summation order differs from the plain form
# kernel vs plain, relative to the plain result's largest value: float32
# storage as tests/test_stencil_pallas.py (residual 1e-5, Chebyshev 2e-5),
# bf16 storage 1e-2 as the CPU parity tests (both sides take the same bf16
# inputs; a rounding point out of place moves a value by 2^-8 = 3.9e-3 of
# itself, and repeated ones add up past the limit)
STORAGE_TOL = {"f32": {"B3": 1e-5, "B4": 2e-5, "B5": 2e-5},
               "bf16": {"B2": 1e-2, "B3": 1e-2, "B4": 1e-2, "B5": 1e-2}}
STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}
RESIDUAL_TOL = 1e-5
ITERATION_RISE = 1.1         # a route's warm CG iterations vs the f32 route
HYBRID = ["BCC", "Hybrid1", "Hybrid4"]
PAD = (1, 1, 1, 1, 1, 1)


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


@contextlib.contextmanager
def _env(**values):
    """Set environment variables for the block, restoring them after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def _bound_of(work) -> Dict:
    nbytes, ops = work
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return {"bytes": nbytes, "ops": ops, "bound_ms": 1e3 * max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def _bound(wrapper) -> Dict:
    return _bound_of(wrapper.work())


def level_cells(n: int, min_cells: int = 3) -> List[int]:
    """Cells per side of every multigrid level of an n^3 lattice (the
    coarsening rule of ``build_mg_hierarchy``)."""
    out = [n]
    while out[-1] > min_cells:
        out.append(_coarsen_cells((out[-1],) * 3)[0])
    return out


def _grids(n: int):
    """(geometry, cells, cell size, label, MG level or None) of every grid
    the kernels are held at: each MG level of the main path, and the
    hybrid check case with its coarse level."""
    cases = [("Octet", c, 2.0 ** i, f"Octet {c}^3 (MG level {i})", i)
             for i, c in enumerate(level_cells(n))]
    hc = min(n, 6)
    cases.append((HYBRID, hc, 1.0, f"{'+'.join(HYBRID)} {hc}^3", None))
    hc2 = _coarsen_cells((hc,) * 3)[0]
    cases.append((HYBRID, hc2, 2.0, f"{'+'.join(HYBRID)} {hc2}^3", None))
    return cases


def kernel_phase(device: torch.device, n: int, seed: int = 0) -> List[Dict]:
    """B1 against its plain version, in f32, at the fine grid and every
    multigrid level's grid of the main path, and on a small hybrid."""
    flush = (torch.empty(64 << 20, dtype=torch.uint8, device=device)
             if device.type == "cuda" else None)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for geom, cells, h, label, _lvl in _grids(n)[:-1]:
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
            up = F.pad(u, PAD)
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


def _err(got, want):
    """(max abs err, max rel err) over one tensor or a tuple of them, each
    part relative to its own largest plain value."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    a = r = 0.0
    for g, w in zip(got, want):
        g, w = g.to(torch.float32), w.to(torch.float32)
        e = float((g - w).abs().max())
        a = max(a, e)
        r = max(r, e / max(float(w.abs().max()), 1e-30))
    return a, r


def fused_kernel_phase(device: torch.device, n: int,
                       seed: int = 1) -> List[Dict]:
    """B2-B5 against their plain versions at every grid of ``_grids``, in
    f32 and bf16 storage: B2 (bf16 only), B3, B4 (a first and a final
    step), and B5 on the levels the routing marks single (with and without
    x0 at the main path's degree; degree 24 on the coarsest Octet level)."""
    cuda = device.type == "cuda"
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device) \
        if cuda else None
    gen = torch.Generator(device=device).manual_seed(seed)
    nu = MG_OPTS["nu"]
    frac = MG_OPTS["smooth_frac"]
    octet_levels = level_cells(n)
    out = []

    def check(kernel, label, storage, variant, run, plain, work,
              timed=None):
        """``run`` (the wrapper) against ``plain``; on the card ``timed``
        (default ``run``) is what the times are taken of."""
        got, want = run(), plain()
        _sync(device)
        abs_err, rel_err = _err(got, want)
        tol = STORAGE_TOL[storage][kernel]
        if not rel_err <= tol:
            raise AssertionError(
                f"{kernel} disagrees with its plain version on {label} "
                f"({storage}, {variant}): rel err {rel_err:.3e} > {tol}")
        rec = {"kernel": kernel, "case": label, "storage": storage,
               "variant": variant, "max_abs_err": abs_err,
               "max_rel_err": rel_err, "tol": tol, **_bound_of(work)}
        if cuda:
            timed = timed or run
            rec["ms"] = _median_ms(timed, device, reps=7, batch=20)
            rec["ms_cold"] = _median_ms(timed, device, reps=11, flush=flush)
            rec["plain_ms"] = _median_ms(plain, device, reps=3, batch=3)
        else:
            rec["ms"] = rec["ms_cold"] = None
            rec["plain_ms"] = _median_ms(plain, device, reps=1)
        out.append(rec)

    for geom, cells, h, label, lvl in _grids(n):
        sl = StructuredLattice(geom, (cells,) * 3, (h, h, h), E_MOD, NU,
                               dtype=torch.float32, device=device)
        with _env(PLDSO_MG_FUSED_DTYPE=FUSED_STORAGE):
            mv, diag = sl.make_matvec()
        B, fz = mv.apply, mv.apply.fused
        shape = (sl.nc, 6) + sl.grid
        fixed = sl.select_nodes(lambda x, y, z: z == 0.0)
        fm = torch.as_tensor(np.ascontiguousarray(np.broadcast_to(
            (sl.node_valid & ~fixed)[:, None], shape), np.float32),
            device=device)
        u = torch.randn(shape, generator=gen, device=device)
        b = torch.randn(shape, generator=gen, device=device) * fm
        r = 0.04 + 0.05 * torch.rand((sl.n_geom,) + (cells,) * 3,
                                     generator=gen, device=device)
        r2 = mv.prepare(r)
        # the level's own Jacobi diagonal and lmax, as the V-cycle's state
        # has them: the smoother's polynomial then stays bounded
        D = fm * diag(r) + (1.0 - fm)
        D = torch.where(D == 0, torch.ones_like(D), D)
        lmax = _estimate_lmax(
            lambda v: fm * B(fm * v, r2) + (1.0 - fm) * v, D, shape,
            torch.float32, iters=MG_OPTS["power_iters"])
        sc = fz.sc(lmax, frac)
        deg = nu[min(lvl, len(nu) - 1)] if lvl is not None else nu[-1]

        u16, r16 = u.to(torch.bfloat16), r2.to(torch.bfloat16)
        u16p = F.pad(u16, PAD)
        check("B2", label, "bf16", "matvec", lambda: B.lo(u16, r16),
              lambda: B.plain_lo(u16, r16), B.work(itemsize=2),
              timed=(lambda: B.launch(u16p, r16)) if cuda else None)
        for storage, io in STORAGE.items():
            P = lambda a: F.pad(a, PAD).to(io)
            x, bp, fmp, fdp = P(u * fm), P(b), P(fm), P(fm / D)
            d, rr, r2s = P(u * fm / D), P(b - u * fm), r2.to(io)
            nbytes = torch.finfo(io).bits // 8
            check("B3", label, storage, "residual",
                  lambda: fz.residual(bp, x, fmp, r2s),
                  lambda: fz.plain_residual(bp, x, fmp, r2s),
                  fz.work("residual", nbytes))
            steps = cheb_static(frac, 2)
            for final, (c1, c2) in ((False, steps[0]), (True, steps[1])):
                check("B4", label, storage, "final" if final else "step",
                      lambda: fz.cheb_run(x, rr, d, fdp, sc, r2s, c1, c2,
                                          final),
                      lambda: fz.plain_cheb_run(x, rr, d, fdp, sc, r2s, c1,
                                                c2, final),
                      fz.work("cheb_run", nbytes, final=final))
            if not fz.single_ok:
                continue
            variants = [(deg, frac, None), (deg, frac, x)]
            if lvl == len(octet_levels) - 1:          # the coarsest sweep
                variants.append((MG_OPTS["coarse_degree"], 1.0 / 64.0, None))
            for dg, fr, x0 in variants:
                scv = fz.sc(lmax, fr)
                check("B5", label, storage,
                      f"degree {dg}{', x0' if x0 is not None else ''}",
                      lambda: fz.cheb_full(bp, x0, fdp, scv, r2s, fr, dg),
                      lambda: fz.plain_cheb_full(bp, x0, fdp, scv, r2s, fr,
                                                 dg),
                      fz.work("cheb_full", nbytes, degree=dg,
                              with_x0=x0 is not None))
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


def _route_step(n: int, device, route: str, tol: float, maxiter: int):
    """The bench's step on ``route`` (built under the route's storage
    setting, which the routing and the state read)."""
    sl, free, f = _bench_problem(n, device, torch.float32)
    step = make_structured_compliance_step(
        sl, free, f, tol=tol, maxiter=maxiter, precond="mg",
        mg_opts=dict(MG_OPTS, **ROUTES[route]))
    return step, free, f


def _counters(step) -> Dict[str, List]:
    """Per kernel, per MG level, the wrappers whose launches count there
    (the outer CG matvec is the fine level's operator too)."""
    levels = step.hierarchy["levels"]
    mvs = [[step.matvec.apply, levels[0].matvec.apply]] \
        + [[lvl.matvec.apply] for lvl in levels[1:]]
    return {"levels": levels, "mvs": mvs}


def _zero(ctr) -> None:
    for ws in ctr["mvs"]:
        for w in ws:
            w.launches = 0
            w.launches_lo = 0
            for k in w.fused.launches:
                w.fused.launches[k] = 0


def _read(ctr) -> Dict[str, List[int]]:
    out = {"B1": [sum(w.launches for w in ws) for ws in ctr["mvs"]],
           "B2": [sum(w.launches_lo for w in ws) for ws in ctr["mvs"]]}
    for tag, key in (("B3", "residual"), ("B4", "cheb_run"),
                     ("B5", "cheb_full")):
        out[tag] = [sum(w.fused.launches[key] for w in ws)
                    for ws in ctr["mvs"]]
    return out


def _check_launches(route: str, counts: Dict[str, List[int]],
                    single: List[bool]) -> None:
    """Every kernel the route runs was launched on every level it runs
    on, and no kernel of another route was launched."""
    nL = len(single)
    want = {"B1": [True] * nL}
    if route == "fused":
        # the mid-cycle residual runs on every level but the coarsest
        want["B3"] = [lvl < nL - 1 for lvl in range(nL)]
        want["B4"] = [not s for s in single]
        want["B5"] = list(single)
    elif route == "lo":
        want["B2"] = [True] * nL
    for k, per_level in counts.items():
        expect = want.get(k, [False] * nL)
        for lvl, (c, e) in enumerate(zip(per_level, expect)):
            if (c > 0) != e:
                raise AssertionError(
                    f"route {route}: {k} launched {c} times on MG level "
                    f"{lvl} (expected {'some' if e else 'none'}): {counts}")


def main_path_phase(device: torch.device, n: int, route: str = "f32",
                    steps: int = 8, windows: int = 3, refresh: int = 8,
                    tol: float = 1e-6, maxiter: int = 6000) -> Dict:
    """``bench.py``'s protocol on the port's step, on ``route``; the launch
    counts of every level's wrappers are zeroed just before the drive and
    read just after it."""
    with _env(PLDSO_MG_FUSED_DTYPE=FUSED_STORAGE):
        return _main_path(device, n, route, steps, windows, refresh, tol,
                          maxiter)


def _main_path(device, n, route, steps, windows, refresh, tol, maxiter):
    t_build = time.perf_counter()
    step, free, f = _route_step(n, device, route, tol, maxiter)
    sl = step.hierarchy["levels"][0].slat
    build_s = time.perf_counter() - t_build
    ctr = _counters(step)
    levels = ctr["levels"]
    single = [lvl.fused.single_ok for lvl in levels]
    _zero(ctr)

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
    counts = _read(ctr)

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
        # the step's own operator and the route's preconditioner)
        fr32 = fr.float()
        aux = step.matvec.prepare(r_used)
        A32 = lambda v: fr32 * step.matvec.apply(fr32 * v, aux) \
            + (1.0 - fr32) * v
        M = mg_apply(step.hierarchy, pstate,
                     **{k: v for k, v in MG_OPTS.items()
                        if k != "power_iters"}, **ROUTES[route])
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
        "route": route, "n": n, "dofs": 6 * sl.n_nodes, "beams": sl.n_edges,
        "levels": [list(lvl.slat.num_cells) for lvl in levels],
        "single_levels": single,
        "host_build_s": build_s, "cold_step_s": cold_s,
        "cold_iterations": cold_iters, "warm_iterations": iters,
        "window_s": window_s, "s_per_step": min(window_s) / steps,
        "compliance": float(cc), "compliance_cold": float(c),
        "true_rel_residual": true_res, "cold_true_rel_residual": cold_res,
        "recurrence_rel_residual": rec_res, "f32_floor_rel_residual": floor_u,
        "reference_rel_residual": ref_res, "compliance_reference": c_ref,
        "compliance_rel_err": c_err, "u_rel_err": u_err, "bitwise": bitwise,
        "finite": finite, "launches_per_level": counts["B1"],
        "kernel_launches": counts, "grad_shape": list(gg.shape),
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
    if device.type == "cuda":
        _check_launches(route, counts, single)
    return report


def profile_phase(device: torch.device, n: int, route: str = "f32",
                  steps: int = 2) -> Dict:
    """Device time by kernel over ``steps`` warm-started steps of the main
    path on ``route`` (frozen state), from ``torch.profiler``: the busy
    share of the window's wall clock, the device events (kernels, copies,
    fills) per CG iteration and the kernels that take the most device time.
    The profiler's own host cost lengthens the wall clock."""
    from torch.profiler import ProfilerActivity, profile

    with _env(PLDSO_MG_FUSED_DTYPE=FUSED_STORAGE):
        step, _, _ = _route_step(n, device, route, 1e-6, 6000)
        r = torch.full((n, n, n), 0.05, dtype=torch.float32, device=device)
        pstate = step.precond_state(r)
        _, _, u = step(r, None, pstate)
        _sync(device)
        iters = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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
    events = sum(x[2] for x in rows)
    return {"route": route, "steps": steps, "iterations": iters,
            "wall_ms": 1e3 * wall, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / (1e3 * wall),
            "device_events": events,
            "events_per_iteration": events / max(sum(iters), 1),
            "top": [{"name": k, "ms": ms, "count": c}
                    for k, ms, c in rows[:20]]}


def _entry(name, source, replaces, launches, recs, head, per_level):
    """One ``kernels`` entry: ``head``'s numbers (the main path's largest
    shape), the launches of the main path and the worst error over every
    case of the kernel."""
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": int(launches),
        "max_abs_err": max(c["max_abs_err"] for c in recs),
        "max_rel_err": max(c["max_rel_err"] for c in recs),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "launches_per_level": per_level,
        "cases": [{k: c.get(k) for k in (
            "case", "storage", "variant", "ms", "ms_cold", "wrapper_ms",
            "plain_ms", "bound_ms", "bound_by", "max_rel_err")}
            for c in recs],
    }


def kernels_line(cases: List[Dict], fused_cases: List[Dict],
                 mains: Dict[str, Dict]) -> List[Dict]:
    """The ``kernels`` entries of B1-B5.  ``launches`` sums each kernel's
    launches over the main-path routes (each read just after its route's
    drive); the timed shape is the largest the main path gives it, in the
    bench's bf16 storage."""
    def launches(tag):
        per = [mains[r]["kernel_launches"][tag] for r in mains]
        return [sum(x) for x in zip(*per)]

    def of(tag):
        return [c for c in fused_cases if c["kernel"] == tag]

    def head(tag, variant=None):
        for c in of(tag):
            if c["storage"] == FUSED_STORAGE \
                    and (variant is None or c["variant"] == variant):
                return c
        raise AssertionError(f"no {tag} case")

    src = StencilMatvec.source
    out = [_entry(StencilMatvec.name, src, StencilMatvec.replaces,
                  sum(launches("B1")), cases, cases[0], launches("B1")),
           _entry(StencilMatvec.name_lo, src, StencilMatvec.replaces_lo,
                  sum(launches("B2")), of("B2"), head("B2"),
                  launches("B2"))]
    nu = MG_OPTS["nu"][-1]
    for tag, key, variant in (("B3", "residual", None),
                              ("B4", "cheb_run", "step"),
                              ("B5", "cheb_full", f"degree {nu}, x0")):
        name, replaces = FUSED_KERNELS[key]
        out.append(_entry(name, FusedSmoother.source, replaces,
                          sum(launches(tag)), of(tag), head(tag, variant),
                          launches(tag)))
    return out


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


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
    card = info["nvidia_smi"] or "CPU rehearsal, host clock"
    log(f"device: {info['kind']} x{info['count']} | {info['nvidia_smi']}")
    budget.check("device")

    built = build_phase(dev)
    if built["seconds"] is not None:
        log(f"build: {built['seconds']:.1f} s "
            f"{ {k: round(v, 1) for k, v in built['per_source'].items()} } "
            f"[{card}]")
        for name, text in built["ptxas"].items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"ptxas {name}: {line.strip()}")
    budget.check("build")

    cases = kernel_phase(dev, n)
    for c in cases:
        log(f"B1 {c['case']}: rel err {c['max_rel_err']:.2e} | kernel "
            f"{_ms(c['ms'])} (after L2 flush {_ms(c['ms_cold'])}, wrapper "
            f"{_ms(c['wrapper_ms'])}), plain {c['plain_ms']:.3f} ms, bound "
            f"{c['bound_ms']:.5f} ms ({c['bound_by']}) [{card}]")
    budget.check("kernels B1")

    fused_cases = fused_kernel_phase(dev, n)
    for c in fused_cases:
        log(f"{c['kernel']} {c['case']} {c['storage']} {c['variant']}: rel "
            f"err {c['max_rel_err']:.2e} (tol {c['tol']:.0e}) | kernel "
            f"{_ms(c['ms'])} (after L2 flush {_ms(c['ms_cold'])}), plain "
            f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.5f} ms "
            f"({c['bound_by']}) [{card}]")
    budget.check("kernels B2-B5")

    mains = {}
    for route in ROUTES:
        m = main_path_phase(dev, n, route=route, steps=steps,
                            windows=windows)
        mains[route] = m
        log(f"main path [{route}] {n}^3 Octet ({m['dofs']} DOF, "
            f"{m['beams']} beams, levels {[c[0] for c in m['levels']]}, "
            f"single {m['single_levels']}): cold {m['cold_iterations']} CG "
            f"iters in {m['cold_step_s']:.2f} s; warm iters "
            f"{m['warm_iterations']}; {m['s_per_step']:.4f} s/step (windows "
            f"{[round(w, 3) for w in m['window_s']]}); compliance "
            f"{m['compliance']:.6e}; true rel residual "
            f"{m['true_rel_residual']:.2e} (f32 floor "
            f"{m['f32_floor_rel_residual']:.2e}, recurrence "
            f"{m['recurrence_rel_residual']:.2e}); vs f64 reference: "
            f"compliance {m['compliance_rel_err']:.2e}, u "
            f"{m['u_rel_err']:.2e}; bitwise {m['bitwise']}; launches per "
            f"level {m['kernel_launches']} [{card}]")
        budget.check(f"main path {route}")
    # the timed (warm-started) steps must converge like the f32 route's;
    # the cold solve's count is printed beside the f32 route's: with bf16
    # smoother storage (the fused and lo routes alike) it rises with the
    # grid, as the reference's bf16 V-cycle does
    # (tests/test_torch_bf16_iterations.py)
    base = mains["f32"]
    warm0 = sum(base["warm_iterations"])
    for route, m in mains.items():
        warm = sum(m["warm_iterations"])
        log(f"CG iterations [{route}]: cold {m['cold_iterations']} vs "
            f"[f32] {base['cold_iterations']}; warm (all timed steps) "
            f"{warm} vs [f32] {warm0}")
        if warm > ITERATION_RISE * warm0 + 1:
            raise AssertionError(
                f"route {route} needs {warm} CG iterations over the timed "
                f"steps against {warm0} on the f32 route")
    return {"device": info, "build": built, "cases": cases,
            "fused_cases": fused_cases, "mains": mains,
            "kernels": kernels_line(cases, fused_cases, mains),
            "wall_s": budget.elapsed()}
