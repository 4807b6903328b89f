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
* ``f32``: the library default, the unfused f32 V-cycle (B1 everywhere);
* ``fused-bf16c``: ``fused`` under ``PLDSO_MG_FUSED_COMPUTE=bf16``, the
  bf16-compute instances B3c, B4c and B5c in place of B3, B4 and B5.

Beside them, the design-gradient step (the implicit adjoint through B1's
VJP) runs its three paths (``design_phase``): (a) float64 implicit against
analytic compliance gradients, (b) float64 displacement objective with an
imposed displacement against a central finite difference, (c) the same
problem in float32 on the fused bf16 route under bench.py's protocol.  The
design optimizer runs through ``opti.optimize_lattice`` (``optimizer_phase``:
(o1) the n^3 Octet with one radius per cell under a relative-density
bound, float64 on the multigrid route, projected gradient;
(o2) FEM_AUTO's routing, SLSQP and the unstructured problem on an 8^3
grid).  The probes P1 and P2 run through their own entry (``probes.main``).
The full-lattice statics run through ``smoke_statics.statics_phase``:
(s1) bench.py's second mode, the edge-sharded float32 step on the n^3
Octet lattice; (s2) its other forms at 8^3 in float64; (s3) the statics
and the simulation layer on the device against the CPU.  This path has
no kernel of its own (plain torch, as the JAX package's is XLA).  The
domain-decomposition route runs through ``smoke_ddm.ddm_phase``: (d1)
the three-point-bending surrogate chain at full width (the reduced basis
trained on the card, refined and plain float64 evaluations), (d2) the
penalized L-beam through ``optimize_lattice``'s DDM route, (d3) the exact
DDM solver against the FEM, the CPU and FE2; no kernel of its own either
(JAX computes it outside Pallas).

B5 is also run under every cluster size and layout of d the card can hold,
and B5c under every cluster size, layout and group size (``_b5_sweep``:
the same bits as its plan's, each timed by CUDA events and by CUDA-graph
replay).  Last, each route's step, path (c)'s, (s1)'s and (d1)'s take
two more warm steps under ``torch.profiler``, the unfused routes lo and
f32 one (``PROFILE_STEPS``; ``profile_phase``, ``profile_drive``: device
busy time and idle share).  ``run(device, n)`` runs every phase and returns a report;
it raises on the first failure.  ``chip_smoke.py`` calls it with
``device="cuda"``, n = 50; the CPU tests rehearse it at n = 4, where each
wrapper runs its plain version and nothing is timed as a device number.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import probes, smoke_ddm, smoke_statics
from .fem.solve import pcg
from .kernels import build
from .kernels.fused import KERNELS as FUSED_KERNELS
from .kernels.fused import (B5_CLUSTERS, B5_LAYOUTS, B5C_GROUPS,
                            FusedSmoother, cheb_static)
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
          "f32": {"fused": False, "lo_smoother": False},
          "fused-bf16c": {"fused": True, "lo_smoother": False}}
# and the fused kernels' arithmetic of each route (None: the variable
# unset), which the wrappers read as they are called
ROUTE_ENV = {route: {"PLDSO_MG_FUSED_COMPUTE":
                     "bf16" if route == "fused-bf16c" else None}
             for route in ROUTES}
# the fused wrappers' launch counters, by the kernel tag they count
FUSED_TAGS = {"B3": "residual", "B4": "cheb_run", "B5": "cheb_full",
              "B3c": "residual_bf16c", "B4c": "cheb_run_bf16c",
              "B5c": "cheb_full_bf16c"}
FUSED_STORAGE = "bf16"       # bench.py's default PLDSO_MG_FUSED_DTYPE
E_MOD, NU = 1013.0, 0.3
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12       # float64 outside the tensor cores
PEAK_BF16_PER_S = 2 * PEAK_F32_PER_S   # bf16 pairs outside the tensor cores
KERNEL_REL_TOL = 1e-5        # summation order differs from the plain form
KERNEL_F64_TOL = 1e-12       # B1<double> against the float64 gather form
# B1's VJP against autograd of the plain gather form, per cotangent
VJP_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# design-gradient gates: (a) implicit vs analytic g, (b) directional
# derivative vs central difference, (c) float32 fused g vs (b)'s float64 g
IMPLICIT_VS_ANALYTIC_TOL = 1e-6
FD_TOL = 1e-5
FUSED_VS_F64_TOL = 1e-3
DESIGN_TOL64 = 1e-10         # CG tol of path (a)
# CG tol of path (b): its gradient and both difference solves.  The
# difference quotient divides the solves' error by 2 h, so they are held
# two orders tighter than (a)'s
FD_SOLVE_TOL = 1e-12
IMPOSED_X = 1e-3             # prescribed X displacement of the clamped face
# kernel vs plain, relative to the plain result's largest value: float32
# storage as tests/test_stencil_pallas.py (residual 1e-5, Chebyshev 2e-5),
# bf16 storage 1e-2 as the CPU parity tests (both sides take the same bf16
# inputs; a rounding point out of place moves a value by 2^-8 = 3.9e-3 of
# itself, and repeated ones add up past the limit); the bf16-compute
# instances B3c-B5c 1e-2 in either storage (bf16 arithmetic on both
# sides, in the same order), and B3c, B4c and B5c the same bits as their
# plain versions (SAME_BITS: 0 elements differ)
STORAGE_TOL = {"f32": {"B3": 1e-5, "B4": 2e-5, "B5": 2e-5, "B3c": 1e-2,
                       "B4c": 1e-2, "B5c": 1e-2},
               "bf16": {"B2": 1e-2, "B3": 1e-2, "B4": 1e-2, "B5": 1e-2,
                        "B3c": 1e-2, "B4c": 1e-2, "B5c": 1e-2}}
SAME_BITS = ("B3c", "B4c", "B5c")
STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}
RESIDUAL_TOL = 1e-5
LONG_REPS = 20               # P1's long launch: REPS x LONG_REPS repeats
ITERATION_RISE = 1.1         # a route's warm CG iterations vs the f32 route
HYBRID = ["BCC", "Hybrid1", "Hybrid4"]
# the optimizer phase: its density bound and slack, iterations, the
# central difference's step in theta and limit, and the density fit of the
# Octet radius grid 0.01-0.1 (10 points): a copy, in the port's tree, of
# the fit the JAX package caches in data/outputs/density_datasets/
OPT_DENSITY = 0.10
OPT_DENSITY_SLACK = 1e-6
OPT_ITERS = 3
OPT_SMALL = 8                # (o2)'s cells per side
OPT_FD_EPS = 1e-4
OPT_FD_TOL = 1e-5
OCTET_DENSITY_FIT = (Path(__file__).resolve().parent / "fits"
                     / "Octet_0.01_0.1_10.gpr.npz")
PAD = (1, 1, 1, 1, 1, 1)
# warm steps profiled per route: the unfused routes (~1,300 device events
# per CG iteration) take one, so the run stays in its budget with the
# statics phase (the profiler's post-processing grows with the events)
PROFILE_STEPS = {"lo": 1, "f32": 1, "mesh-m1": 1, "mesh-m2-fused": 1,
                 "mesh-m2-fused-one": 1}


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
    """Set environment variables for the block (a None value unsets one),
    restoring them after."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
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


def _graph_ms(fn: Callable, device: torch.device, calls: int = 20,
              reps: int = 5) -> Optional[float]:
    """Device time per call of ``fn`` without the host's cost per call:
    ``calls`` calls captured once in a CUDA graph, the graph replayed
    between CUDA events (median of ``reps``).  ``fn`` runs once first (its
    launch state is cached then); None off the card."""
    if device.type != "cuda":
        return None
    fn()
    _sync(device)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    _sync(device)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def _paired_ms(fa: Callable, fb: Callable, device: torch.device, reps: int,
               batch: int) -> tuple:
    """(median ms of ``fa``, of ``fb``) per call, their samples taken in
    turns (a, b, b, a, ...) as ``_median_ms`` takes one."""
    a, b = [], []
    for k in range(reps):
        first, second = (fa, fb) if k % 2 == 0 else (fb, fa)
        t1 = _median_ms(first, device, reps=1, batch=batch)
        t2 = _median_ms(second, device, reps=1, batch=batch)
        a.append(t1 if k % 2 == 0 else t2)
        b.append(t2 if k % 2 == 0 else t1)
    return float(np.median(a)), float(np.median(b))


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


def _bound_of(work, peak_ops: float = PEAK_F32_PER_S) -> Dict:
    nbytes, ops = work
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return {"bytes": nbytes, "ops": ops, "bound_ms": 1e3 * max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def _bound(wrapper) -> Dict:
    return _bound_of(wrapper.work())


def _index(device: torch.device) -> Optional[int]:
    """The card's index for a plan's occupancy query; None off the card."""
    return (device.index or 0) if device.type == "cuda" else None


def _plan_rec(plan: Dict) -> Dict:
    """A slab or beam plan as the report keeps it: run, threads per block
    (one per class and point, or a warp per edge), edges a block (beam
    plans), blocks one SM holds (asked of the card; None off it), halo and
    dynamic shared memory (none: the kernels read through L1)."""
    rec = {"run": plan["run"], "threads": plan["threads"],
           "blocks_per_sm": plan.get("blocks_per_sm"),
           "halo": list(plan["halo"]), "smem_bytes": 0}
    if "edges" in plan:
        rec["edges"] = plan["edges"]
    return rec


def _plan_text(plan: Dict) -> str:
    bps = plan["blocks_per_sm"]
    if "edges" in plan:
        head = (f"beam plan: runs of {plan['run']} points, a warp per "
                f"edge, {plan['edges']} edges = {plan['threads']} threads "
                f"a block")
    else:
        head = (f"slab plan: runs of {plan['run']} points, one thread per "
                f"class and point = {plan['threads']} threads a block")
    return (f"{head}, {'not asked' if bps is None else bps} blocks per SM, "
            f"halo {plan['halo']}, {plan['smem_bytes']} bytes of shared "
            f"memory")


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
               "max_rel_err": rel_err, **_bound(mv.apply),
               "plan": _plan_rec(mv.apply.slab_plan(
                   torch.float32, device=_index(device)))}
        if device.type == "cuda":
            up = F.pad(u, PAD)
            launch = lambda: mv.apply.launch(up, r2p)
            # ms: back-to-back launches; ms_cold: one launch after an L2
            # flush (for small grids this includes the host's launch gap)
            rec["ms"] = _median_ms(launch, device, reps=7, batch=50)
            rec["device_ms"] = _graph_ms(launch, device)
            rec["ms_cold"] = _median_ms(launch, device, reps=21, flush=flush)
            rec["wrapper_ms"] = _median_ms(lambda: mv.apply(u, r2p), device,
                                           reps=7, batch=50)
            rec["plain_ms"] = _median_ms(lambda: mv.apply_gather(u, r2p),
                                         device, reps=5, batch=5)
        else:
            rec["ms"] = rec["ms_cold"] = rec["wrapper_ms"] = None
            rec["device_ms"] = None
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
        g, w = g.to(torch.float64), w.to(torch.float64)
        e = float((g - w).abs().max())
        a = max(a, e)
        r = max(r, e / max(float(w.abs().max()), 1e-30))
    return a, r


def _bits_differ(got, want) -> int:
    """Elements whose bits differ between two tensors (or tuples of them)
    of one dtype."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    out = 0
    for g, w in zip(got, want):
        view = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
        out += int((g.contiguous().view(view)
                    != w.contiguous().view(view)).sum())
    return out


def fused_kernel_phase(device: torch.device, n: int,
                       seed: int = 1) -> List[Dict]:
    """B2-B5 against their plain versions at every grid of ``_grids``, in
    f32 and bf16 storage: B2 (bf16 only), B3, B4 (a first and a final
    step), and B5 on the levels the routing marks single (with and without
    x0 at the main path's degree; degree 24 on the coarsest Octet level);
    then, on the same inputs, their bf16-compute instances B3c, B4c and
    B5c on every level that has them (the dense ones).  Each record counts
    the elements whose bits differ from the plain version's."""
    cuda = device.type == "cuda"
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device) \
        if cuda else None
    gen = torch.Generator(device=device).manual_seed(seed)
    nu = MG_OPTS["nu"]
    frac = MG_OPTS["smooth_frac"]
    octet_levels = level_cells(n)
    out = []

    def check(kernel, label, storage, variant, run, plain, work,
              timed=None, peak=PEAK_F32_PER_S):
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
        differ = _bits_differ(got, want)
        if kernel in SAME_BITS and differ:
            raise AssertionError(
                f"{kernel} on {label} ({storage}, {variant}): {differ} "
                f"elements differ bitwise from its plain version")
        rec = {"kernel": kernel, "case": label, "storage": storage,
               "variant": variant, "max_abs_err": abs_err,
               "max_rel_err": rel_err, "tol": tol, "bits_differ": differ,
               **_bound_of(work, peak)}
        if cuda:
            timed = timed or run
            rec["ms"] = _median_ms(timed, device, reps=7, batch=20)
            if kernel in ("B2", "B3", "B4", "B3c", "B4c"):
                rec["device_ms"] = _graph_ms(timed, device)
            rec["ms_cold"] = _median_ms(timed, device, reps=11, flush=flush)
            rec["plain_ms"] = _median_ms(plain, device, reps=3, batch=3)
        else:
            rec["ms"] = rec["ms_cold"] = rec["device_ms"] = None
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
        out[-1]["plan"] = _plan_rec(B.slab_plan(torch.bfloat16,
                                                device=_index(device)))
        for storage, io in STORAGE.items():
            P = lambda a: F.pad(a, PAD).to(io)
            x, bp, fmp, fdp = P(u * fm), P(b), P(fm), P(fm / D)
            d, rr, r2s = P(u * fm / D), P(b - u * fm), r2.to(io)
            nbytes = torch.finfo(io).bits // 8
            check("B3", label, storage, "residual",
                  lambda: fz.residual(bp, x, fmp, r2s),
                  lambda: fz.plain_residual(bp, x, fmp, r2s),
                  fz.work("residual", nbytes))
            out[-1]["plan"] = _plan_rec(fz.b3_plan(io, device=_index(device)))
            steps = cheb_static(frac, 2)
            for final, (c1, c2) in ((False, steps[0]), (True, steps[1])):
                check("B4", label, storage, "final" if final else "step",
                      lambda: fz.cheb_run(x, rr, d, fdp, sc, r2s, c1, c2,
                                          final),
                      lambda: fz.plain_cheb_run(x, rr, d, fdp, sc, r2s, c1,
                                                c2, final),
                      fz.work("cheb_run", nbytes, final=final))
                out[-1]["plan"] = _plan_rec(fz.b4_plan(
                    io, final, device=_index(device)))
            if fz.dense:
                check("B3c", label, storage, "residual",
                      lambda: fz.residual(bp, x, fmp, r2s, "bf16"),
                      lambda: fz.plain_residual(bp, x, fmp, r2s, "bf16"),
                      fz.work("residual", nbytes, compute="bf16"),
                      peak=PEAK_BF16_PER_S)
                out[-1]["plan"] = _plan_rec(fz.b3_plan(
                    io, device=_index(device), compute="bf16"))
                for final, (c1, c2) in ((False, steps[0]), (True, steps[1])):
                    check("B4c", label, storage, "final" if final else "step",
                          lambda: fz.cheb_run(x, rr, d, fdp, sc, r2s, c1, c2,
                                              final, "bf16"),
                          lambda: fz.plain_cheb_run(x, rr, d, fdp, sc, r2s,
                                                    c1, c2, final, "bf16"),
                          fz.work("cheb_run", nbytes, final=final,
                                  compute="bf16"), peak=PEAK_BF16_PER_S)
                    out[-1]["plan"] = _plan_rec(fz.b4_plan(
                        io, final, device=_index(device), compute="bf16"))
            if not fz.single_ok:
                continue
            variants = [(deg, frac, None), (deg, frac, x)]
            if lvl == len(octet_levels) - 1:          # the coarsest sweep
                variants.append((MG_OPTS["coarse_degree"], 1.0 / 64.0, None))
            computes = ("f32", "bf16") if fz.dense else ("f32",)
            for (dg, fr, x0), ct in [(v, ct) for ct in computes
                                     for v in variants]:
                scv = fz.sc(lmax, fr)
                variant = f"degree {dg}{', x0' if x0 is not None else ''}"
                tag = "B5" if ct == "f32" else "B5c"
                run = lambda ct=ct, **kw: fz.cheb_full(
                    bp, x0, fdp, scv, r2s, fr, dg, compute=ct, **kw)
                check(tag, label, storage, variant, run,
                      lambda: fz.plain_cheb_full(bp, x0, fdp, scv, r2s, fr,
                                                 dg, ct),
                      fz.work("cheb_full", nbytes, degree=dg,
                              with_x0=x0 is not None, compute=ct),
                      peak=PEAK_F32_PER_S if ct == "f32" else PEAK_BF16_PER_S)
                out[-1].update(_b5_sweep(fz, run, io, x0 is not None, device,
                                         label, storage, variant, ct))
    return out


# B5 before its redesign for Hopper clusters: the one-block kernel's times
# (ms, CUDA-event medians of back-to-back launches) as chip_smoke.py of
# commit 9cba2c9 measured them on an NVIDIA H100 80GB HBM3, 700.00 W.  They
# are records, not measurements of this run: the smoke's log prints each
# case's time beside its entry here, and no report field carries them
B5_BEFORE_MS = {
    ("Octet 7^3 (MG level 3)", "f32", "degree 2"): 0.1208,
    ("Octet 7^3 (MG level 3)", "f32", "degree 2, x0"): 0.1565,
    ("Octet 7^3 (MG level 3)", "bf16", "degree 2"): 0.1168,
    ("Octet 7^3 (MG level 3)", "bf16", "degree 2, x0"): 0.1528,
    ("Octet 4^3 (MG level 4)", "f32", "degree 2"): 0.0422,
    ("Octet 4^3 (MG level 4)", "f32", "degree 2, x0"): 0.0557,
    ("Octet 4^3 (MG level 4)", "bf16", "degree 2"): 0.0507,
    ("Octet 4^3 (MG level 4)", "bf16", "degree 2, x0"): 0.0561,
    ("Octet 2^3 (MG level 5)", "f32", "degree 2"): 0.0481,
    ("Octet 2^3 (MG level 5)", "f32", "degree 2, x0"): 0.0507,
    ("Octet 2^3 (MG level 5)", "f32", "degree 24"): 0.1945,
    ("Octet 2^3 (MG level 5)", "bf16", "degree 2"): 0.0487,
    ("Octet 2^3 (MG level 5)", "bf16", "degree 2, x0"): 0.0495,
    ("Octet 2^3 (MG level 5)", "bf16", "degree 24"): 0.1890,
}


# The kernels before their redesign, keyed (kernel, case, storage,
# variant): B1, B1<double>, B2 and B4 one thread per point, as
# chip_smoke.py of commit c27ec5f measured them, and B3 (one thread per
# flat item) and the r^2-cotangent ("r2", one thread per side pair), as
# chip_smoke.py of commit 203cb5d measured them (SLAB_BEFORE_FROM); ms,
# CUDA-event medians of back-to-back launches on an NVIDIA H100 80GB
# HBM3, 700.00 W.  They are records, not measurements of this run: the
# smoke's log prints each case's time beside its entry here, and no
# report field carries them
SLAB_BEFORE_FROM = {"B3": "203cb5d", "r2": "203cb5d"}
SLAB_BEFORE_MS = {
    ("B1", "Octet 50^3 (MG level 0)", "f32", "matvec"): 0.0512,
    ("B1", "Octet 25^3 (MG level 1)", "f32", "matvec"): 0.0121,
    ("B1", "Octet 13^3 (MG level 2)", "f32", "matvec"): 0.0151,
    ("B1", "Octet 7^3 (MG level 3)", "f32", "matvec"): 0.0109,
    ("B1", "Octet 4^3 (MG level 4)", "f32", "matvec"): 0.0106,
    ("B1", "Octet 2^3 (MG level 5)", "f32", "matvec"): 0.0113,
    ("B1<double>", "Octet 50^3 (MG level 0)", "f64", "matvec"): 0.1050,
    ("B1<double>", "Octet 25^3 (MG level 1)", "f64", "matvec"): 0.0208,
    ("B1<double>", "Octet 13^3 (MG level 2)", "f64", "matvec"): 0.0150,
    ("B1<double>", "Octet 7^3 (MG level 3)", "f64", "matvec"): 0.0189,
    ("B1<double>", "Octet 4^3 (MG level 4)", "f64", "matvec"): 0.0192,
    ("B1<double>", "Octet 2^3 (MG level 5)", "f64", "matvec"): 0.0193,
    ("B2", "Octet 50^3 (MG level 0)", "bf16", "matvec"): 0.0492,
    ("B4", "Octet 50^3 (MG level 0)", "f32", "step"): 0.1021,
    ("B4", "Octet 50^3 (MG level 0)", "f32", "final"): 0.0689,
    ("B4", "Octet 50^3 (MG level 0)", "bf16", "step"): 0.0663,
    ("B4", "Octet 50^3 (MG level 0)", "bf16", "final"): 0.0616,
    ("B2", "Octet 25^3 (MG level 1)", "bf16", "matvec"): 0.0127,
    ("B4", "Octet 25^3 (MG level 1)", "f32", "step"): 0.0182,
    ("B4", "Octet 25^3 (MG level 1)", "f32", "final"): 0.0133,
    ("B4", "Octet 25^3 (MG level 1)", "bf16", "step"): 0.0172,
    ("B4", "Octet 25^3 (MG level 1)", "bf16", "final"): 0.0135,
    ("B2", "Octet 13^3 (MG level 2)", "bf16", "matvec"): 0.0105,
    ("B4", "Octet 13^3 (MG level 2)", "f32", "step"): 0.0251,
    ("B4", "Octet 13^3 (MG level 2)", "f32", "final"): 0.0201,
    ("B4", "Octet 13^3 (MG level 2)", "bf16", "step"): 0.0169,
    ("B4", "Octet 13^3 (MG level 2)", "bf16", "final"): 0.0204,
    ("B2", "Octet 7^3 (MG level 3)", "bf16", "matvec"): 0.0170,
    ("B4", "Octet 7^3 (MG level 3)", "f32", "step"): 0.0168,
    ("B4", "Octet 7^3 (MG level 3)", "f32", "final"): 0.0126,
    ("B4", "Octet 7^3 (MG level 3)", "bf16", "step"): 0.0267,
    ("B4", "Octet 7^3 (MG level 3)", "bf16", "final"): 0.0135,
    ("B2", "Octet 4^3 (MG level 4)", "bf16", "matvec"): 0.0129,
    ("B4", "Octet 4^3 (MG level 4)", "f32", "step"): 0.0218,
    ("B4", "Octet 4^3 (MG level 4)", "f32", "final"): 0.0130,
    ("B4", "Octet 4^3 (MG level 4)", "bf16", "step"): 0.0299,
    ("B4", "Octet 4^3 (MG level 4)", "bf16", "final"): 0.0217,
    ("B2", "Octet 2^3 (MG level 5)", "bf16", "matvec"): 0.0120,
    ("B4", "Octet 2^3 (MG level 5)", "f32", "step"): 0.0184,
    ("B4", "Octet 2^3 (MG level 5)", "f32", "final"): 0.0133,
    ("B4", "Octet 2^3 (MG level 5)", "bf16", "step"): 0.0289,
    ("B4", "Octet 2^3 (MG level 5)", "bf16", "final"): 0.0214,
    ("B3", "Octet 50^3 (MG level 0)", "f32", "residual"): 0.0622,
    ("B3", "Octet 50^3 (MG level 0)", "bf16", "residual"): 0.0537,
    ("B3", "Octet 25^3 (MG level 1)", "f32", "residual"): 0.0168,
    ("B3", "Octet 25^3 (MG level 1)", "bf16", "residual"): 0.0127,
    ("B3", "Octet 13^3 (MG level 2)", "f32", "residual"): 0.0166,
    ("B3", "Octet 13^3 (MG level 2)", "bf16", "residual"): 0.0154,
    ("B3", "Octet 7^3 (MG level 3)", "f32", "residual"): 0.0151,
    ("B3", "Octet 7^3 (MG level 3)", "bf16", "residual"): 0.0184,
    ("B3", "Octet 4^3 (MG level 4)", "f32", "residual"): 0.0174,
    ("B3", "Octet 4^3 (MG level 4)", "bf16", "residual"): 0.0162,
    ("B3", "Octet 2^3 (MG level 5)", "f32", "residual"): 0.0191,
    ("B3", "Octet 2^3 (MG level 5)", "bf16", "residual"): 0.0143,
    ("B3", "BCC+Hybrid1+Hybrid4 6^3", "f32", "residual"): 0.0216,
    ("B3", "BCC+Hybrid1+Hybrid4 6^3", "bf16", "residual"): 0.0149,
    ("B3", "BCC+Hybrid1+Hybrid4 3^3", "f32", "residual"): 0.0188,
    ("B3", "BCC+Hybrid1+Hybrid4 3^3", "bf16", "residual"): 0.0132,
    ("r2", "Octet 50^3 f32", "f32", "vjp"): 0.0907,
    ("r2", "Octet 50^3 f64", "f64", "vjp"): 0.1572,
}


def _was(kernel: str, case: str, storage: str, variant: str) -> str:
    was = SLAB_BEFORE_MS.get((kernel, case, storage, variant))
    return "not recorded" if was is None \
        else (f"{was:.4f} ms (recorded from commit "
              f"{SLAB_BEFORE_FROM.get(kernel, 'c27ec5f')})")


def _b5_sweep(fz, run, io, with_x0, device, label, storage,
              variant, compute: str = "f32") -> Dict:
    """B5 under every cluster size and layout of d the card can run on
    this level, and B5c (bf16 ``compute``) under every cluster size,
    layout and group size: each gives the plan's bits (and so does a
    repeat), and each is timed on the card."""
    cuda = device.type == "cuda"
    index = (device.index or 0) if cuda else None
    tag = "B5" if compute == "f32" else "B5c"
    plan = fz.b5_plan(io, with_x0, device=index, compute=compute)
    want = run()
    same = lambda got: torch.equal(got, want)
    if not same(run()):
        raise AssertionError(f"{tag} on {label} ({storage}, {variant}): two "
                             f"identical launches differ bitwise")
    groups = B5C_GROUPS if compute == "bf16" else (None,)
    sweep = []
    for layout in B5_LAYOUTS:
        for cluster in B5_CLUSTERS:
            for group in groups:
                try:
                    fz.b5_plan(io, with_x0, cluster, layout, index, compute,
                               group)
                except ValueError:
                    continue          # too few items, too many, or no room
                kw = {"cluster": cluster, "layout": layout}
                if compute == "bf16":
                    kw["group"] = group
                got = run(**kw)
                _sync(device)
                if not same(got):
                    raise AssertionError(
                        f"{tag} on {label} ({storage}, {variant}): {kw} "
                        f"differs bitwise from the plan's (cluster "
                        f"{plan['cluster']}, {plan['layout']}, group "
                        f"{plan['group']})")
                ms = _median_ms(lambda: run(**kw), device, reps=5,
                                batch=20) if cuda else None
                sweep.append({**kw, "group": group, "ms": ms,
                              "device_ms": _graph_ms(lambda: run(**kw),
                                                     device)})
    if not any(c["layout"] == "global" for c in sweep):
        raise AssertionError(f"{tag} on {label}: the global-d layout never "
                             f"ran")
    return {"plan": {k: plan[k] for k in ("cluster", "layout", "threads",
                                          "ipt", "group", "r2_smem",
                                          "smem_bytes")},
            "sweep": sweep, "device_ms": _graph_ms(run, device)}


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
    (the outer CG matvec is the fine level's operator too), and the
    operators whose plain gather-form calls are counted."""
    levels = step.hierarchy["levels"]
    mvs = [[step.matvec.apply, levels[0].matvec.apply]] \
        + [[lvl.matvec.apply] for lvl in levels[1:]]
    ops = [step.matvec] + [lvl.matvec for lvl in levels]
    return {"levels": levels, "mvs": mvs, "ops": ops}


# launch counters of the stencil wrapper, by the kernel tag they count
_STENCIL_COUNTERS = {"B1": "launches", "B1f64": "launches_f64",
                     "VJP": "launches_vjp", "B2": "launches_lo"}


def _zero(ctr) -> None:
    for ws in ctr["mvs"]:
        for w in ws:
            for attr in _STENCIL_COUNTERS.values():
                setattr(w, attr, 0)
            for k in w.fused.launches:
                w.fused.launches[k] = 0
            w.fused.b5_launches.clear()
            w.fused.b5_shapes.clear()
    for op in ctr["ops"]:
        op.plain_calls = 0


def _read(ctr) -> Dict[str, List[int]]:
    out = {tag: [sum(getattr(w, attr) for w in ws) for ws in ctr["mvs"]]
           for tag, attr in _STENCIL_COUNTERS.items()}
    for tag, key in FUSED_TAGS.items():
        out[tag] = [sum(w.fused.launches[key] for w in ws)
                    for ws in ctr["mvs"]]
    return out


def _b5_clusters(ctr) -> List[Dict[int, int]]:
    """Per MG level, B5's launches by the cluster size it ran with."""
    out = []
    for ws in ctr["mvs"]:
        per: Dict[int, int] = {}
        for w in ws:
            for cl, k in w.fused.b5_launches.items():
                per[cl] = per.get(cl, 0) + k
        out.append(dict(sorted(per.items())))
    return out


def _b5_shapes(ctr) -> List[Dict]:
    """B5's and B5c's launches by shape: per MG level, compute, degree and
    x0, as the wrappers counted them."""
    out: Dict[tuple, int] = {}
    for lvl, ws in enumerate(ctr["mvs"]):
        for w in ws:
            for (ct, degree, x0), k in w.fused.b5_shapes.items():
                key = (lvl, ct, degree, x0)
                out[key] = out.get(key, 0) + k
    return [{"level": lvl, "kernel": "B5" if ct == "f32" else "B5c",
             "degree": degree, "x0": x0, "launches": k}
            for (lvl, ct, degree, x0), k in sorted(out.items())]


def _plain_calls(ctr) -> int:
    return sum(op.plain_calls for op in ctr["ops"])


def _check_launches(route: str, counts: Dict[str, List[int]],
                    single: List[bool], implicit: bool = False,
                    f64: bool = False) -> None:
    """Every kernel the route runs was launched on every level it runs
    on, and no kernel of another route was launched.  ``implicit``: the
    r^2-cotangent kernel of B1's VJP runs on the fine level;  ``f64``: B1
    is its float64 instance."""
    nL = len(single)
    want = {"B1f64" if f64 else "B1": [True] * nL}
    if route in ("fused", "fused-bf16c"):
        # the mid-cycle residual runs on every level but the coarsest;
        # the bf16-compute route runs B3c-B5c there instead, and no B3-B5
        c = "c" if route == "fused-bf16c" else ""
        want["B3" + c] = [lvl < nL - 1 for lvl in range(nL)]
        want["B4" + c] = [not s for s in single]
        want["B5" + c] = list(single)
    elif route == "lo":
        want["B2"] = [True] * nL
    if implicit:
        want["VJP"] = [lvl == 0 for lvl in range(nL)]
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
    read just after it.  ``profile_inputs`` holds the built step, the
    radii, the cold solution and the frozen state, for ``profile_phase``
    once every phase has run (``run`` pops it)."""
    with _env(PLDSO_MG_FUSED_DTYPE=FUSED_STORAGE, **ROUTE_ENV[route]):
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
    pstate0 = pstate = step.precond_state(r0)
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
    b5_clusters = _b5_clusters(ctr)
    b5_shapes = _b5_shapes(ctr)

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
        "kernel_launches": counts, "b5_clusters": b5_clusters,
        "b5_shapes": b5_shapes, "grad_shape": list(gg.shape),
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
    report["profile_inputs"] = (step, r0, u, pstate0)
    return report


def kernel64_phase(device: torch.device, n: int, seed: int = 2) -> List[Dict]:
    """B1's float64 instance against the float64 gather form at every
    multigrid level's grid of the main path (limit KERNEL_F64_TOL,
    relative to the plain result's largest value)."""
    cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for geom, cells, h, label, lvl in _grids(n):
        if lvl is None:
            continue
        sl = StructuredLattice(geom, (cells,) * 3, (h, h, h), E_MOD, NU,
                               dtype=torch.float64, device=device)
        mv, _ = sl.make_matvec()
        u = torch.randn((sl.nc, 6) + sl.grid, generator=gen, device=device,
                        dtype=torch.float64)
        r = 0.04 + 0.05 * torch.rand((cells,) * 3, generator=gen,
                                     device=device, dtype=torch.float64)
        r2p = mv.prepare(r)
        y_plain = mv.apply_gather(u, r2p)
        y = mv.apply(u, r2p)
        _sync(device)
        abs_err, rel_err = _err(y, y_plain)
        if not rel_err <= KERNEL_F64_TOL:
            raise AssertionError(f"B1<double> disagrees with its plain "
                                 f"version on {label}: rel err "
                                 f"{rel_err:.3e} > {KERNEL_F64_TOL}")
        rec = {"case": label, "grid": list(sl.grid), "max_abs_err": abs_err,
               "max_rel_err": rel_err,
               **_bound_of(mv.apply.work(itemsize=8), PEAK_F64_PER_S),
               "plan": _plan_rec(mv.apply.slab_plan(
                   torch.float64, device=_index(device)))}
        if cuda:
            up = F.pad(u, PAD)
            rec["ms"] = _median_ms(lambda: mv.apply.launch(up, r2p), device,
                                   reps=7, batch=20)
            rec["device_ms"] = _graph_ms(lambda: mv.apply.launch(up, r2p),
                                         device)
            rec["plain_ms"] = _median_ms(lambda: mv.apply_gather(u, r2p),
                                         device, reps=3, batch=2)
        else:
            rec["ms"] = rec["device_ms"] = None
            rec["plain_ms"] = _median_ms(lambda: mv.apply_gather(u, r2p),
                                         device, reps=1)
        out.append(rec)
    return out


def vjp_phase(device: torch.device, n: int, seed: int = 3) -> List[Dict]:
    """B1's VJP at the fine grid, float32 and float64: the u- and
    r^2-cotangents of ``backward()`` through ``apply`` against torch
    autograd of the plain gather form (limits VJP_TOL, each relative to its
    largest value), with B1 and the r^2-cotangent kernel launched during
    the backward.  Times: the r^2-cotangent kernel, its plain closed form,
    and the autograd of the gather form it replaces."""
    cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for dt in (torch.float32, torch.float64):
        sl = StructuredLattice("Octet", (n,) * 3, (1.0,) * 3, E_MOD, NU,
                               dtype=dt, device=device)
        mv, _ = sl.make_matvec()
        B = mv.apply
        shape = (sl.nc, 6) + sl.grid
        u = torch.randn(shape, generator=gen, device=device, dtype=dt)
        g = torch.randn(shape, generator=gen, device=device, dtype=dt)
        r = 0.04 + 0.05 * torch.rand((n,) * 3, generator=gen, device=device,
                                     dtype=dt)
        r2p = mv.prepare(r)

        def reference():
            uq = u.clone().requires_grad_(True)
            rq = r2p.clone().requires_grad_(True)
            with torch.enable_grad():
                return torch.autograd.grad(mv.apply_gather(uq, rq), (uq, rq),
                                           g)

        want = reference()
        uq = u.clone().requires_grad_(True)
        rq = r2p.clone().requires_grad_(True)
        with torch.enable_grad():
            y = B(uq, rq)
        attr = "launches_f64" if dt == torch.float64 else "launches"
        before = (getattr(B, attr), B.launches_vjp)
        y.backward(g)
        _sync(device)
        rose = (getattr(B, attr) - before[0], B.launches_vjp - before[1])
        if cuda and rose != (1, 1):
            raise AssertionError(f"B1's backward launched (B1, r^2-cotangent)"
                                 f" {rose} times, expected (1, 1)")
        errs = [_err(a, b) for a, b in zip((uq.grad, rq.grad), want)]
        tol = VJP_TOL[dt]
        label = f"Octet {n}^3 {'f64' if dt == torch.float64 else 'f32'}"
        for what, (_a, rel) in zip(("u", "r^2"), errs):
            if not rel <= tol:
                raise AssertionError(f"B1's VJP {what}-cotangent on {label}:"
                                     f" rel err {rel:.3e} > {tol}")
        item = torch.finfo(dt).bits // 8
        peak = PEAK_F64_PER_S if dt == torch.float64 else PEAK_F32_PER_S
        rec = {"case": label, "launches_in_backward": list(rose),
               "max_abs_err": max(a for a, _ in errs),
               "max_rel_err": max(r_ for _, r_ in errs),
               "u_rel_err": errs[0][1], "r2_rel_err": errs[1][1], "tol": tol,
               **_bound_of(B.vjp_work(itemsize=item), peak),
               "plan": _plan_rec(B.beam_plan(dt, _index(device)))}
        plain = lambda: B.plain_vjp_r2(g, u, r2p)
        if cuda:
            up, gp = F.pad(u, PAD), F.pad(g, PAD)
            kern = lambda: B.launch_vjp(up, gp, r2p)
            rec["ms"] = _median_ms(kern, device, reps=7, batch=20)
            rec["device_ms"] = _graph_ms(kern, device)
            rec["plain_ms"] = _median_ms(plain, device, reps=3, batch=2)
            rec["autograd_ms"] = _median_ms(reference, device, reps=3,
                                            batch=1)
        else:
            rec["ms"] = rec["autograd_ms"] = rec["device_ms"] = None
            rec["plain_ms"] = _median_ms(plain, device, reps=1)
        out.append(rec)
    return out


def vjp_grid_phase(device: torch.device, n: int, seed: int = 4) -> List[Dict]:
    """The r^2-cotangent kernel against its plain closed form
    (``plain_vjp_r2``, limits VJP_TOL) in float32 and float64 at every
    grid of ``_grids`` but the fine one (``vjp_phase`` holds that one
    through the backward), bitwise on repeat on the card, with its beam
    plan and its event and CUDA-graph times."""
    cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for geom, cells, h, label, lvl in _grids(n):
        if lvl == 0:
            continue
        for dt in (torch.float32, torch.float64):
            sl = StructuredLattice(geom, (cells,) * 3, (h, h, h), E_MOD, NU,
                                   dtype=dt, device=device)
            mv, _ = sl.make_matvec()
            B = mv.apply
            shape = (sl.nc, 6) + sl.grid
            u = torch.randn(shape, generator=gen, device=device, dtype=dt)
            g = torch.randn(shape, generator=gen, device=device, dtype=dt)
            r = 0.04 + 0.05 * torch.rand((sl.n_geom,) + (cells,) * 3,
                                         generator=gen, device=device,
                                         dtype=dt)
            r2p = mv.prepare(r)
            up, gp = F.pad(u, PAD), F.pad(g, PAD)
            kern = (lambda: B.launch_vjp(up, gp, r2p)) if cuda \
                else (lambda: B.vjp_r2(g, u, r2p))
            plain = lambda: B.plain_vjp_r2(g, u, r2p)
            got = kern()
            if cuda and not torch.equal(got, kern()):
                raise AssertionError(f"the r^2-cotangent kernel on {label}: "
                                     f"two identical launches differ "
                                     f"bitwise")
            abs_err, rel_err = _err(got, plain())
            storage = "f64" if dt == torch.float64 else "f32"
            tol = VJP_TOL[dt]
            if not rel_err <= tol:
                raise AssertionError(f"the r^2-cotangent kernel on {label} "
                                     f"({storage}): rel err {rel_err:.3e} "
                                     f"> {tol}")
            item = torch.finfo(dt).bits // 8
            peak = PEAK_F64_PER_S if dt == torch.float64 else PEAK_F32_PER_S
            rec = {"case": label, "storage": storage, "variant": "vjp",
                   "max_abs_err": abs_err, "max_rel_err": rel_err,
                   "tol": tol, **_bound_of(B.vjp_work(itemsize=item), peak),
                   "plan": _plan_rec(B.beam_plan(dt, _index(device)))}
            if cuda:
                rec["ms"] = _median_ms(kern, device, reps=7, batch=20)
                rec["device_ms"] = _graph_ms(kern, device)
                rec["plain_ms"] = _median_ms(plain, device, reps=3, batch=2)
            else:
                rec["ms"] = rec["device_ms"] = None
                rec["plain_ms"] = _median_ms(plain, device, reps=1)
            out.append(rec)
    return out


def probe_phase(device: torch.device) -> Dict:
    """P1 (both kinds) and P2 bitwise against their plain versions, timed
    (P2 beside ``torch.mul``, the one PyTorch call that computes it), then
    the probes' own entry driven with the counts zeroed just before it and
    read just after."""
    cuda = device.type == "cuda"
    xs = probes.inputs(device)
    cases = []
    for kind in ("1d", "2d"):
        x = xs["chain"]
        got, want = probes.chain(x, kind), probes.plain_chain(x, kind)
        _sync(device)
        if not torch.equal(got, want):
            raise AssertionError(f"P1 ({kind}) is not bitwise equal to its "
                                 f"plain version")
        nbytes = 2 * x.numel() * 4
        # the bound in FP32 instructions: each step v * 1.0001 + 0.5 is a
        # multiply and an add rounded on their own (the script's and the
        # plain version's arithmetic, __fmul_rn/__fadd_rn in the kernel),
        # and Hopper has no f32 instruction that does both with two
        # roundings, so 2 instructions a step (probes.flops counts them)
        # at the FMA-counted peak / 2 = 33.5e12 lane-instructions/s
        rec = {"kernel": "P1", "case": kind, "max_abs_err": 0.0,
               "max_rel_err": 0.0, "flops": probes.flops(kind),
               **_bound_of((nbytes, probes.flops(kind)),
                           PEAK_F32_PER_S / 2)}
        if cuda:
            rec["ms"] = _median_ms(lambda: probes.chain(x, kind), device,
                                   reps=7, batch=10)
            rec["device_ms"] = _graph_ms(lambda: probes.chain(x, kind),
                                         device)
            # one launch of REPS x LONG_REPS repeats (graph replay): the
            # kernel's own time per REPS, with the gap between launches
            # spread over LONG_REPS times the work
            long = lambda: probes.chain(x, kind, reps=probes.REPS * LONG_REPS)
            if not torch.equal(long(), want):
                raise AssertionError(f"P1 ({kind}) x {LONG_REPS} is not "
                                     f"bitwise equal to its plain version")
            rec["long_ms"] = _graph_ms(long, device, calls=5) / LONG_REPS
            rec["plain_ms"] = _median_ms(lambda: probes.plain_chain(x, kind),
                                         device, reps=3, batch=2)
            rec["gflops"] = probes.flops(kind) / rec["ms"] / 1e6
        else:
            rec["ms"] = rec["gflops"] = rec["device_ms"] = None
            rec["long_ms"] = None
            rec["plain_ms"] = _median_ms(lambda: probes.plain_chain(x, kind),
                                         device, reps=1)
        rec["library_ms"] = None
        cases.append(rec)
    x = xs["scale"]
    got = probes.scale(x)
    _sync(device)
    if not torch.equal(got, probes.plain_scale(x)):
        raise AssertionError("P2 is not bitwise equal to x * 2")
    rec = {"kernel": "P2", "case": "8x128", "max_abs_err": 0.0,
           "max_rel_err": 0.0, **_bound_of((2 * x.numel() * 4, x.numel()))}
    if cuda:
        # P2 and torch.mul in turns, one sample of each per round, so that
        # the host's load moves both alike
        rec["ms"], rec["library_ms"] = _paired_ms(
            lambda: probes.scale(x), lambda: torch.mul(x, 2.0), device,
            reps=15, batch=50)
        rec["plain_ms"] = _median_ms(lambda: probes.plain_scale(x), device,
                                     reps=7, batch=50)
    else:
        rec["ms"] = rec["library_ms"] = None
        rec["plain_ms"] = _median_ms(lambda: probes.plain_scale(x), device,
                                     reps=1)
    cases.append(rec)
    # the probes' main path: their entry point, as a user runs it
    for k in probes.launches:
        probes.launches[k] = 0
    if cuda:
        with contextlib.redirect_stdout(None):
            rc = probes.main(["--device", str(device)])
        if rc != 0:
            raise AssertionError(f"the probes' entry exited {rc}")
    entry = dict(probes.launches)
    if cuda and not all(v > 0 for v in entry.values()):
        raise AssertionError(f"the probes' entry launched {entry}")
    return {"cases": cases, "launches": entry}


# ------------------------------------------------------ design gradient
def _design_problem(n: int, device, dtype):
    """The bench's lattice and load with a prescribed X displacement of
    IMPOSED_X on the clamped face, and the objective "max" of the top
    face's mean Z displacement (the JAX optimizer's displacement objective
    s * sum(sel * u) with s = -1, ``opti/structured_optimizer.py:100-107``)."""
    sl, free, f = _bench_problem(n, device, dtype)
    fixed = sl.select_nodes(lambda x, y, z: z == 0.0)
    top = sl.select_nodes(lambda x, y, z: z == float(n))
    u_imp = np.zeros_like(f)
    sel = np.zeros_like(f)
    n_top = int(top.sum())
    for c in range(sl.nc):
        u_imp[c, 0][fixed[c]] = IMPOSED_X
        sel[c, 2][top[c]] = 1.0 / n_top
    sel_t = torch.as_tensor(sel, dtype=dtype, device=device)
    objective = lambda u, f_: -torch.sum(sel_t * u)
    return sl, free, f, u_imp, objective


def _design_step(n, device, dtype, route, tol, maxiter, grad=None,
                 displacement=True):
    """(step, lattice) of the design problem on ``route`` (the f32 V-cycle
    at float64, where the hierarchy has no bf16 operands)."""
    sl, free, f, u_imp, obj = _design_problem(n, device, dtype)
    kw = dict(u_imposed=u_imp, objective=obj) if displacement else {}
    env = {} if grad is None else {"PLDSO_GRAD": grad}
    with _env(**env):
        step = make_structured_compliance_step(
            sl, free, f, tol=tol, maxiter=maxiter, precond="mg",
            mg_opts=dict(MG_OPTS, **ROUTES[route]), **kw)
    return step, sl


def _solves(step) -> Dict:
    """CG iterations of the last call's forward and adjoint solves."""
    adj = step.last_adjoint
    return {"forward": step.last_solve["iterations"],
            "adjoint": None if adj is None else adj["iterations"]}


def _directional(step, r, g, u, pstate, v, h):
    """(g . v, the central difference (J(r + h v) - J(r - h v)) / 2h),
    the two solves warm-started from ``u`` on the frozen ``pstate``."""
    free, f = step.operands
    with torch.no_grad():
        j_p, _ = step.raw(r + h * v, free, f, u, pstate)
        j_m, _ = step.raw(r - h * v, free, f, u, pstate)
    return float(torch.sum(g * v)), float(j_p - j_m) / (2.0 * h)


def design_phase(device: torch.device, n: int, steps: int = 8,
                 windows: int = 3, maxiter: int = 6000,
                 fd_h: float = 1e-4, seed: int = 4) -> Dict:
    """The design-gradient step at n^3 Octet on its three paths; each path's
    launch counts are zeroed just before its drive and read just after.
    Path (c)'s report holds its ``profile_inputs`` as ``main_path_phase``'s
    does."""
    cuda = device.type == "cuda"
    f64 = torch.float64
    r64 = torch.full((n, n, n), 0.05, dtype=f64, device=device)
    out = {}

    # (a) float64: implicit against analytic compliance gradients
    st_i, _ = _design_step(n, device, f64, "f32", DESIGN_TOL64, maxiter,
                           grad="implicit", displacement=False)
    st_a, _ = _design_step(n, device, f64, "f32", DESIGN_TOL64, maxiter,
                           grad="analytic", displacement=False)
    if (st_i.grad_form, st_a.grad_form) != ("implicit", "analytic"):
        raise AssertionError(f"gradient forms {st_i.grad_form}, "
                             f"{st_a.grad_form}")
    ctr = _counters(st_i)
    ps = st_i.precond_state(r64)
    _zero(ctr)
    t = time.perf_counter()
    c_i, g_i, u_i = st_i(r64, None, ps)
    _sync(device)
    secs_i = time.perf_counter() - t
    counts_a = _read(ctr)
    it_i = _solves(st_i)
    c_a, g_a, u_a = st_a(r64, None, ps)
    it_an = _solves(st_a)
    _abs, err_a = _err(g_i, g_a)
    out["a"] = {"objective": float(c_i), "objective_analytic": float(c_a),
                "grad_rel_err": err_a, "iterations": it_i,
                "iterations_analytic": it_an, "step_s": secs_i,
                "kernel_launches": counts_a}
    if not err_a <= IMPLICIT_VS_ANALYTIC_TOL:
        raise AssertionError(f"(a) implicit vs analytic g: rel err "
                             f"{err_a:.3e} > {IMPLICIT_VS_ANALYTIC_TOL}")

    # (b) float64 displacement objective with an imposed displacement,
    # against a central difference along one seeded direction
    st_b, _ = _design_step(n, device, f64, "f32", FD_SOLVE_TOL, maxiter)
    ctr = _counters(st_b)
    ps_b = st_b.precond_state(r64)
    _zero(ctr)
    t = time.perf_counter()
    c_b, g_b, u_b = st_b(r64, None, ps_b)
    _sync(device)
    secs_b = time.perf_counter() - t
    counts_b = _read(ctr)
    it_b = _solves(st_b)
    # a seeded random direction of positive entries, a relative change of
    # 0.5-1.5 of each radius: a direction of random signs makes g.v a sum
    # that cancels to ~1/sqrt(cells) of its terms, and the check then
    # measures that cancellation instead of the gradient (shown, not
    # gated, by ``signed_direction`` below)
    gen = torch.Generator(device=device).manual_seed(seed)
    v = r64 * (0.5 + torch.rand((n,) * 3, generator=gen, device=device,
                                dtype=f64))
    dd, fd = _directional(st_b, r64, g_b, u_b, ps_b, v, fd_h)
    err_b = abs(fd - dd) / abs(dd)
    out["b"] = {"objective": float(c_b), "directional": dd,
                "finite_difference": fd, "fd_h": fd_h, "fd_rel_err": err_b,
                "iterations": it_b, "step_s": secs_b,
                "kernel_launches": counts_b}
    if not err_b <= FD_TOL:
        raise AssertionError(f"(b) g.v {dd:.9e} vs central difference "
                             f"{fd:.9e}: rel err {err_b:.3e} > {FD_TOL}")
    # the same check along a seeded direction of random signs, at (a)'s
    # and (b)'s CG tol
    w = r64 * torch.randn((n,) * 3, generator=gen, device=device, dtype=f64)
    st_w, _ = _design_step(n, device, f64, "f32", DESIGN_TOL64, maxiter)
    ps_w = st_w.precond_state(r64)
    _c, g_w, u_w = st_w(r64, None, ps_w)
    signed = []
    for tol, st_, g_, u_, ps_ in ((DESIGN_TOL64, st_w, g_w, u_w, ps_w),
                                  (FD_SOLVE_TOL, st_b, g_b, u_b, ps_b)):
        d_, f_ = _directional(st_, r64, g_, u_, ps_, w, fd_h)
        signed.append({"tol": tol, "directional": d_,
                       "finite_difference": f_,
                       "fd_rel_err": abs(f_ - d_) / abs(d_),
                       "sum_abs_terms": float(torch.sum(torch.abs(g_ * w)))})
    out["b"]["signed_direction"] = signed
    for path, counts in (("a", counts_a), ("b", counts_b)):
        if cuda:
            _check_launches("f32", counts,
                            [lvl.fused.single_ok for lvl in ctr["levels"]],
                            implicit=True, f64=True)

    # (c) float32, the bench's fused bf16 route, the same problem as (b)
    with _env(PLDSO_MG_FUSED_DTYPE=FUSED_STORAGE, **ROUTE_ENV["fused"]):
        out["c"] = _design_fused(device, n, steps, windows, maxiter, g_b)
    return out


def _design_fused(device, n, steps, windows, maxiter, g_ref) -> Dict:
    st, sl = _design_step(n, device, torch.float32, "fused", 1e-6, maxiter)
    ctr = _counters(st)
    levels = ctr["levels"]
    single = [lvl.fused.single_ok for lvl in levels]
    r0 = torch.full((n, n, n), 0.05, dtype=torch.float32, device=device)
    _zero(ctr)
    t = time.perf_counter()
    pstate = st.precond_state(r0)
    c, g, u = st(r0, None, pstate)
    _sync(device)
    cold_s = time.perf_counter() - t
    cold = _solves(st)
    st(r0 * 1.0005, None, pstate)
    c_b, g_b, u_b = st(r0, None, pstate)
    _sync(device)
    same = lambda a, b: a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
    bitwise = same(c, c_b) and same(g, g_b) and same(u, u_b)
    # descent steps of a relative size ~1e-3 at the largest gradient entry
    lr = 5e-5 / float(g.abs().max())
    window_s, iters = [], []
    for rep in range(windows):
        rr = r0 * (1.0 + 1e-3 * (rep + 1))
        uu = u
        _sync(device)
        t1 = time.perf_counter()
        for k in range(steps):
            cc, gg, uu = st(rr, uu, pstate)
            iters.append(_solves(st))
            rr = torch.clamp(rr - lr * gg, 0.01, 0.1)
        _sync(device)
        window_s.append(time.perf_counter() - t1)
    counts = _read(ctr)
    b5_clusters = _b5_clusters(ctr)
    b5_shapes = _b5_shapes(ctr)
    plain_calls = _plain_calls(ctr)
    _abs, g_err = _err(g.to(torch.float64), g_ref)
    finite = bool(torch.isfinite(cc) and torch.isfinite(gg).all()
                  and torch.isfinite(uu).all())
    rep = {"objective": float(c), "grad_rel_err_vs_f64": g_err,
           "bitwise": bitwise, "finite": finite, "cold_step_s": cold_s,
           "cold_iterations": cold, "warm_iterations": iters,
           "window_s": window_s, "s_per_step": min(window_s) / steps,
           "single_levels": single, "kernel_launches": counts,
           "b5_clusters": b5_clusters, "b5_shapes": b5_shapes,
           "plain_gather_calls": plain_calls}
    if not finite:
        raise AssertionError(f"(c) non-finite result: {rep}")
    if not bitwise:
        raise AssertionError("(c) two identical steps differ bitwise in "
                             "obj, g or u")
    if not g_err <= FUSED_VS_F64_TOL:
        raise AssertionError(f"(c) float32 fused g vs float64 g: rel err "
                             f"{g_err:.3e} > {FUSED_VS_F64_TOL}")
    if device.type == "cuda":
        _check_launches("fused", counts, single, implicit=True)
        if plain_calls:
            raise AssertionError(f"(c) the plain gather form ran "
                                 f"{plain_calls} times as an operator")
    rep["profile_inputs"] = (st, r0, u, pstate)
    return rep


# ------------------------------------------------------------ optimizer
def _opt_config(n: int, sim_type: str) -> Dict:
    """bench.py's lattice and load (``bench.py:173-181``: n^3 Octet, cell
    size 1, radius 0.05, Zmin clamped in all six DOF, a total Z force of
    -1 on Zmax) with the optimizer's block: compliance min, one radius per
    cell, relative density at most OPT_DENSITY."""
    return {
        "geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                     "number_of_cells": {"x": n, "y": n, "z": n},
                     "radii": [0.05], "geom_types": ["Octet"]},
        "boundary_conditions": {
            "Displacement": {"Fixed": {"Surface": ["Zmin"],
                                       "DOF": ["X", "Y", "Z", "RX", "RY",
                                               "RZ"],
                                       "Value": [0, 0, 0, 0, 0, 0]}},
            "Force": {"Load": {"Surface": ["Zmax"], "DOF": ["Z"],
                               "Value": [-1.0]}}},
        "optimization_informations": {
            "simulation_type": sim_type, "objective_type": "compliance",
            "objective_function": "min",
            "optimization_parameters": {"type": "unit_cell"},
            "constraints": {"relative_density": {"value": OPT_DENSITY,
                                                 "mode": "upper"}}}}


def _unit_direction(k: int, device, seed: int) -> torch.Tensor:
    """A seeded random unit vector of positive entries (0.5-1.5 before
    scaling): a direction of random signs makes g.v a sum that cancels to
    ~1/sqrt(k) of its terms (``design_phase``'s finding), and the check
    then measures that cancellation instead of the gradient."""
    gen = torch.Generator(device=device).manual_seed(seed)
    v = 0.5 + torch.rand(k, generator=gen, device=device,
                         dtype=torch.float64)
    return v / torch.linalg.norm(v)


def _fd_check(value, vg, theta, v, eps: float) -> Dict:
    """g.v at ``theta`` (``vg``) against the central difference of
    ``value`` along ``v`` with step ``eps`` in theta."""
    _val, g = vg(theta)
    dd = float(torch.sum(g * v))
    fd = (float(value(theta + eps * v)) - float(value(theta - eps * v))) \
        / (2.0 * eps)
    return {"directional": dd, "finite_difference": fd, "eps": eps,
            "fd_rel_err": abs(fd - dd) / abs(dd)}


def _same_bits(a, b) -> bool:
    return all(x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()
               for x, y in zip(a, b))


def optimizer_phase(device: torch.device, n: int, small: int = OPT_SMALL,
                    seed: int = 5) -> Dict:
    """The design optimizer through ``optimize_lattice``, as a user runs
    it, on the card.  (o1) n^3: the structured route (FEM_STRUCTURED),
    float64, the multigrid preconditioner with the bench's options, the
    projected gradient for OPT_ITERS iterations; its launch counts
    are read just after the drive (the wrappers are made inside it, at
    0), then the first iterate's gradient is held against a central
    difference of the objective.  (o2) small^3: FEM_AUTO must route to the
    structured problem; SLSQP for OPT_ITERS iterations must end feasible
    and no worse than the uniform feasible start; the unstructured
    problem's gradient against a central difference; and two evaluations
    of each problem the same bits."""
    from .design import build_lattice
    from .opti import optimize_lattice
    from .opti.density import KrigingDensity
    from .opti.optimizer import OptimizationProblem
    from .opti.structured_optimizer import StructuredOptimizationProblem

    cuda = device.type == "cuda"
    model = KrigingDensity.load(OCTET_DENSITY_FIT)
    out = {}

    # (o1) full width
    t = time.perf_counter()
    lat = build_lattice(_opt_config(n, "FEM_STRUCTURED"))
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    problem, res = optimize_lattice(
        lat, driver="projected", max_iterations=OPT_ITERS, precond="mg",
        mg_opts=dict(MG_OPTS, **ROUTES["f32"]), density_model=model,
        device=device)
    _sync(device)
    drive_s = time.perf_counter() - t
    ctr = _counters(problem._step)
    counts = _read(ctr)
    plain = _plain_calls(ctr)
    single = [lvl.fused.single_ok for lvl in ctr["levels"]]
    hist = problem.history
    # optimize_projected accepts a trial that does not raise the objective
    # above the last accepted one, starting from the first evaluation's
    first = problem.evaluations[0]["objective"]
    accepted, best = 0, first
    for h in hist:
        if h["objective"] <= best:
            accepted, best = accepted + 1, h["objective"]
    evaluations = list(problem.evaluations)       # the drive's
    theta1 = problem._theta(hist[0]["parameters"])
    v = _unit_direction(problem.param.n_params, device, seed)
    with torch.no_grad():
        fd = _fd_check(problem._objective_theta_structured,
                       problem._value_and_grad, theta1, v, OPT_FD_EPS)
    o1 = {"cells": n, "dofs": int(6 * lat.num_nodes),
          "beams": lat.num_edges, "params": problem.param.n_params,
          "build_lattice_s": build_s, "setup_s": dict(problem.setup_s),
          "drive_s": drive_s, "evaluations": evaluations,
          "history_objective": [h["objective"] for h in hist],
          "history_density": [h["relative_density"] for h in hist],
          "first_objective": first, "accepted": accepted,
          "objective": res.objective,
          "density": res.density, "iterations": res.iterations,
          "kernel_launches": counts, "plain_gather_calls": plain, **fd}
    out["o1"] = o1
    if accepted < 1:
        raise AssertionError(f"(o1) no accepted iterate in {len(hist)}")
    if not res.objective <= first:
        raise AssertionError(f"(o1) final objective {res.objective:.9e} "
                             f"above the first {first:.9e}")
    if not res.density <= OPT_DENSITY + OPT_DENSITY_SLACK:
        raise AssertionError(f"(o1) density {res.density:.9f} > "
                             f"{OPT_DENSITY} + {OPT_DENSITY_SLACK}")
    if not fd["fd_rel_err"] <= OPT_FD_TOL:
        raise AssertionError(f"(o1) g.v {fd['directional']:.9e} vs central "
                             f"difference {fd['finite_difference']:.9e}: "
                             f"rel err {fd['fd_rel_err']:.3e} > {OPT_FD_TOL}")
    if cuda:
        _check_launches("f32", counts, single, implicit=True, f64=True)
        if plain:
            raise AssertionError(f"(o1) the plain gather form ran {plain} "
                                 f"times as an operator")

    # (o2) a small grid: routing, SLSQP, the unstructured problem
    lat_s = build_lattice(_opt_config(small, "FEM_AUTO"))
    sp, res_s = optimize_lattice(lat_s, driver="slsqp",
                                 max_iterations=OPT_ITERS,
                                 density_model=model, device=device)
    if not isinstance(sp, StructuredOptimizationProblem):
        raise AssertionError(f"(o2) FEM_AUTO routed to {type(sp).__name__}")
    apply = sp._step.matvec.apply
    counts_s = {"B1f64": apply.launches_f64, "VJP": apply.launches_vjp,
                "B1": apply.launches, "plain_gather_calls":
                sp._step.matvec.plain_calls}
    x_feas = sp.feasible_x0()
    start = sp.objective(x_feas)
    sp._u_warm = None
    a = sp._value_and_grad(x_feas)
    sp._u_warm = None
    b = sp._value_and_grad(x_feas)
    up = OptimizationProblem(lat_s, opt_params={"type": "unit_cell"},
                             constraints=lat_s.config.optimization[
                                 "constraints"],
                             density_model=model, device=device)
    th = up._theta(x_feas)
    fd_s = _fd_check(lambda x: up._value_and_grad(x)[0], up._value_and_grad,
                     th, _unit_direction(up.param.n_params, device, seed + 1),
                     OPT_FD_EPS)
    c1, c2 = up._value_and_grad(th), up._value_and_grad(th)
    o2 = {"cells": small, "routed": type(sp).__name__,
          "objective": res_s.objective, "density": res_s.density,
          "iterations": res_s.iterations, "feasible_start_objective": start,
          "message": res_s.message, "kernel_launches": counts_s,
          "same_bits_structured": _same_bits(a, b),
          "same_bits_unstructured": _same_bits(c1, c2),
          "unstructured": fd_s}
    out["o2"] = o2
    if not res_s.density <= OPT_DENSITY + OPT_DENSITY_SLACK:
        raise AssertionError(f"(o2) SLSQP ended infeasible: density "
                             f"{res_s.density:.9f}")
    if not res_s.objective <= start:
        raise AssertionError(f"(o2) SLSQP's objective {res_s.objective:.9e} "
                             f"is above the feasible start's {start:.9e}")
    if not fd_s["fd_rel_err"] <= OPT_FD_TOL:
        raise AssertionError(f"(o2) unstructured g.v vs central difference: "
                             f"rel err {fd_s['fd_rel_err']:.3e} > "
                             f"{OPT_FD_TOL}")
    if not (o2["same_bits_structured"] and o2["same_bits_unstructured"]):
        raise AssertionError(f"(o2) two evaluations differ in their bits: "
                             f"{o2}")
    if cuda and not (counts_s["B1f64"] > 0 and counts_s["VJP"] > 0
                     and counts_s["B1"] == 0
                     and counts_s["plain_gather_calls"] == 0):
        raise AssertionError(f"(o2) launches {counts_s}")
    return out


def profile_phase(step, r: torch.Tensor, u: torch.Tensor, pstate,
                  device: torch.device, route: str, steps: int = 2) -> Dict:
    """``profile_drive`` over ``steps`` warm-started steps of a built
    main-path ``step`` (frozen ``pstate``, warm start ``u``, radii near
    ``r``).  ``route="design"`` names path (c) of ``design_phase``, whose
    iterations count the forward and adjoint solves."""

    def drive(k):
        step(r * (1.0 + 1e-3 * (k + 1)), u, pstate)
        return sum(v or 0 for v in _solves(step).values())

    return profile_drive(drive, device, route, steps)


def profile_drive(drive: Callable[[int], int], device: torch.device,
                  route: str, steps: int = 2) -> Dict:
    """Device time by kernel over ``steps`` calls ``drive(k)`` (each one
    step, returning its CG iterations), from ``torch.profiler``: the busy
    share of the window's wall clock, the device events (kernels, copies,
    fills) per CG iteration and the kernels that take the most device
    time.  The profiler's own host cost lengthens the wall clock."""
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    _sync(device)
    iters = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for k in range(steps):
            iters.append(drive(k))
        _sync(device)
        wall = time.perf_counter() - t
    # device-side events only (kernels, copies, fills; the host ops that
    # launched them carry the same device time), summed by name straight
    # from the trace's records: the same sums and counts as key_averages,
    # whose Python event tree takes ~0.6 ms an event (91 s of the DDM
    # profile's ~150,000 device events, against 3.4 s here)
    by_name: Dict[str, List] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        row = by_name.setdefault(e.name(), [0.0, 0])
        row[0] += e.duration_ns() / 1e6
        row[1] += 1
    rows = sorted(((k, ms, c) for k, (ms, c) in by_name.items() if ms > 0),
                  key=lambda x: -x[1])
    busy_ms = sum(x[1] for x in rows)
    events = sum(x[2] for x in rows)
    b5 = [x for x in rows if "mg_cheb_full" in x[0]]
    return {"route": route, "steps": steps, "iterations": iters,
            "wall_ms": 1e3 * wall, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / (1e3 * wall),
            "device_events": events,
            "events_per_iteration": events / max(sum(iters), 1),
            "b5_ms": sum(x[1] for x in b5),
            "b5_launches": sum(x[2] for x in b5),
            "phase_s": time.perf_counter() - t_phase,
            "top": [{"name": k, "ms": ms, "count": c}
                    for k, ms, c in rows[:20]]}


def _entry(name, source, replaces, launches, recs, head, per_level,
           library_ms=None):
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
        "library_ms": library_ms, "device_ms": head.get("device_ms"),
        "launches_per_level": per_level,
        "cases": [{k: c.get(k) for k in (
            "case", "storage", "variant", "ms", "ms_cold", "wrapper_ms",
            "device_ms", "plain_ms", "autograd_ms", "long_ms",
            "library_ms", "bound_ms", "bound_by", "max_rel_err")}
            for c in recs],
    }


def kernels_line(cases: List[Dict], fused_cases: List[Dict],
                 mains: Dict[str, Dict], cases64: List[Dict],
                 vjp_cases: List[Dict], probe: Dict,
                 design: Dict, opt: Dict,
                 warped: Optional[Dict] = None) -> List[Dict]:
    """The ``kernels`` entries of B1 (float32, float64, VJP), B2-B5,
    B3c-B5c, P1 and P2, and of the warped phase's B1w (float32, float64)
    and warped r^2-cotangent when it ran (``smoke_warped.kernel_entries``:
    their launches from (w1) and (w2)).  ``launches`` sums each kernel's launches over the main paths
    (the four routes' compliance steps, the three design-gradient paths
    and the optimizer's full-width drive (o1), each read just after its
    drive; the probes' entry for P1 and P2); the timed shape is the
    largest the main path gives the kernel, in the bench's bf16 storage
    for B2-B5 and B3c-B5c."""
    runs = [mains[r]["kernel_launches"] for r in mains] \
        + [design[p]["kernel_launches"] for p in ("a", "b", "c")] \
        + [opt["o1"]["kernel_launches"]]

    def launches(tag):
        return [sum(x) for x in zip(*[run[tag] for run in runs])]

    def per_shape(tag):
        """B5's or B5c's launches over the main paths by (level, degree,
        x0)."""
        got: Dict[tuple, int] = {}
        for rep in list(mains.values()) + [design["c"]]:
            for x in rep["b5_shapes"]:
                if x["kernel"] == tag:
                    key = (x["level"], x["degree"], x["x0"])
                    got[key] = got.get(key, 0) + x["launches"]
        return [{"level": lvl, "degree": dg, "x0": x0, "launches": k}
                for (lvl, dg, x0), k in sorted(got.items())]

    def of(tag):
        return [c for c in fused_cases if c["kernel"] == tag]

    def head(tag, variant=None):
        for c in of(tag):
            if c["storage"] == FUSED_STORAGE \
                    and (variant is None or c["variant"] == variant):
                return c
        raise AssertionError(f"no {tag} case")

    src = StencilMatvec.source
    vjp32 = [c for c in vjp_cases if c["case"].endswith("f32")][0]
    out = [_entry(StencilMatvec.name, src, StencilMatvec.replaces,
                  sum(launches("B1")), cases, cases[0], launches("B1")),
           _entry(StencilMatvec.name_f64, src, StencilMatvec.replaces,
                  sum(launches("B1f64")), cases64, cases64[0],
                  launches("B1f64")),
           _entry(StencilMatvec.name_vjp, src, StencilMatvec.replaces_vjp,
                  sum(launches("VJP")), vjp_cases, vjp32, launches("VJP")),
           _entry(StencilMatvec.name_lo, src, StencilMatvec.replaces_lo,
                  sum(launches("B2")), of("B2"), head("B2"),
                  launches("B2"))]
    nu = MG_OPTS["nu"][-1]
    for tag, variant in (("B3", None), ("B4", "step"),
                         ("B5", f"degree {nu}, x0"), ("B3c", None),
                         ("B4c", "step"), ("B5c", f"degree {nu}, x0")):
        name, replaces = FUSED_KERNELS[FUSED_TAGS[tag]]
        out.append(_entry(name, FusedSmoother.source, replaces,
                          sum(launches(tag)), of(tag), head(tag, variant),
                          launches(tag)))
        if tag in ("B5", "B5c"):
            out[-1]["launches_per_shape"] = per_shape(tag)
    for tag, key in (("P1", "chain"), ("P2", "scale")):
        recs = [c for c in probe["cases"] if c["kernel"] == tag]
        name, replaces = probes.KERNELS[key]
        out.append(_entry(name, probes.SOURCE, replaces,
                          probe["launches"][key], recs, recs[-1],
                          [probe["launches"][key]],
                          library_ms=recs[-1]["library_ms"]))
    if warped is not None:
        from . import smoke_warped
        out.extend(smoke_warped.kernel_entries(warped))
    return out


def _evals(evals) -> str:
    """A DDM route's evaluations: cold s, warm s and CG iterations."""
    return (f"cold {evals[0]['s']:.3f} s, warm s "
            f"{[round(e['s'], 3) for e in evals[1:]]} (mean "
            f"{np.mean([e['s'] for e in evals[1:]]):.3f}); CG iterations "
            f"forward/adjoint {[(e['forward'], e['adjoint']) for e in evals]}")


def log_ddm(ddm: Dict, card: str, log: Callable[[str], None]) -> None:
    """The DDM phase's printed lines (``smoke_ddm``)."""
    d1, d2, d3 = ddm["d1"], ddm["d2"], ddm["d3"]
    cells = "x".join(str(c) for c in d1["cells"])
    log(f"ddm (d1) three-point bending {cells} BCC+Hybrid1+Hybrid4 "
        f"({d1['n_cells']} cells, {d1['params']} radii, {d1['nodes']} "
        f"nodes, {d1['beams']} beams): build_lattice "
        f"{d1['build_lattice_s']:.2f} s; offline {d1['samples']} samples: "
        f"train {d1['train_s']:.2f} s (chained condensation f64 on the "
        f"device {d1['condense_s']:.2f} s, greedy on the host "
        f"{d1['greedy_s']:.2f} s), m_rb {d1['m_rb']} (n_b "
        f"{d1['n_boundary']}); interface {d1['interface_dofs']} DOF (6N) on "
        f"{d1['interface_nodes']} interface nodes, {d1['free_dofs']} free; "
        f"problem {d1['problem_s']:.2f} s [{card}]")
    log(f"ddm (d1) refined route ({d1['route']}, f32 CG + f64 residuals, "
        f"cg_tol {smoke_ddm.CG_TOL:g}): {_evals(d1['refined_evals'])} "
        f"[{card}]")
    log(f"ddm (d1) plain f64 CG (refined=False): "
        f"{_evals(d1['plain_evals'])} [{card}]")
    g = d1["refined_vs_plain"]
    log(f"ddm (d1) gates: surrogate S at {d1['gate_samples']} "
        f"training samples vs direct chained condensation rel Frobenius "
        f"{d1['surrogate_rel_err']:.2e} (tol {smoke_ddm.SURROGATE_TOL:g}), "
        f"device vs CPU {d1['device_vs_cpu_rel_err']:.2e} (tol "
        f"{smoke_ddm.DEVICE_CPU_TOL:g}); refined vs plain at cg_tol "
        f"{d1['gate_tol']:g}: objective {g['objective']:.2e} (tol "
        f"{smoke_ddm.REFINED_OBJ_TOL:g}), gradient {g['gradient']:.2e} (tol "
        f"{smoke_ddm.REFINED_GRAD_TOL:g}), CG iterations "
        f"{d1['gate_solves']}; at cg_tol {smoke_ddm.CG_TOL:g} (not gated): "
        f"objective {d1['at_cg_tol']['objective']:.2e}, gradient "
        f"{d1['at_cg_tol']['gradient']:.2e}; g.v {d1['directional']:.9e} vs "
        f"central difference {d1['finite_difference']:.9e}: rel err "
        f"{d1['fd_rel_err']:.2e} (tol {smoke_ddm.FD_TOL:g}); repeated "
        f"evaluation bitwise {d1['bitwise']} [{card}]")
    log(f"ddm (d2) L-beam ({d2['cells']} cells, {d2['geometries']} "
        f"geometries, {d2['params']} radii, {d2['interface_dofs']} interface "
        f"DOF, dense refined {d2['dense'] and d2['refined']}) through "
        f"optimize_lattice DDM: penalized surrogate (numpy) step "
        f"{d2['step']:g}, {d2['samples']} samples, m_rb {d2['m_rb']}: train "
        f"{d2['train_s']:.2f} s (condensation {d2['condense_s']:.2f} s, "
        f"greedy {d2['greedy_s']:.2f} s); drive {d2['drive_s']:.2f} s, "
        f"{d2['iterations']} iterations, {d2['accepted']} accepted; "
        f"objective {d2['start_objective']:.9e} (feasible start) -> "
        f"{d2['objective']:.9e}, density {d2['density']:.9f} (bound "
        f"{smoke_ddm.DENSITY:g}); s per evaluation "
        f"{[round(x, 4) for x in d2['eval_s']]}, refinement passes "
        f"{d2['eval_solves']}; {d2['message']} [{card}]")
    c = d3["cantilever"]
    log(f"ddm (d3) cantilever_ddm {c['cells']} BCC f64: DDM vs "
        f"solve_fem(subdivide 0.05, penalized) interface u rel L2 "
        f"{c['u_rel_l2']:.2e}, compliance {c['compliance_rel_err']:.2e} (tol "
        f"{smoke_ddm.FEM_TOL:g}); {c['groups']} Schur groups; DDM "
        f"{c['ddm_iterations']} CG iterations in {c['ddm_s']:.3f} s, FEM "
        f"{c['fem_iterations']} in {c['fem_s']:.3f} s [{card}]")
    t = d3["tpb_penalized"]
    log(f"ddm (d3) three-point bending {t['cells']} penalized exact: "
        f"{t['groups']} Schur group(s), {t['interior_dofs']} interior DOF; "
        f"condensation f64 device {t['device_condense_s']:.2f} s, CPU "
        f"{t['cpu_condense_s']:.2f} s; solve f64 device "
        f"{t['device_iterations']} iterations in {t['device_solve_s']:.3f} "
        f"s, CPU {t['cpu_iterations']} in {t['cpu_solve_s']:.3f} s, f32 "
        f"operator refined {t['f32_iterations']} in {t['f32_solve_s']:.3f} "
        f"s; device vs CPU {t['cpu_rel_err']:.2e} (tol "
        f"{smoke_ddm.D3_CPU_TOL:g}), f32 refined vs f64 rel L2 "
        f"{t['f32_rel_l2']:.2e} (tol {smoke_ddm.F32_TOL:g}) [{card}]")
    f = d3["fe2"]
    log(f"ddm (d3) FE2 one BCC cell, target_h 0.3: {f['columns']} inner "
        f"solves in {f['s']:.2f} s; vs schur_complement rel err "
        f"{f['rel_err']:.2e} (tol {smoke_ddm.FE2_TOL:g}) [{card}]")


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def run(device="cuda", n: int = 50, steps: int = 8, windows: int = 3,
        budget_s: float = 600.0, log: Callable[[str], None] = print,
        ddm_size: Dict = smoke_ddm.FULL,
        warped_size: Optional[Dict] = None,
        mesh_size: Optional[Dict] = None) -> Dict:
    """Every phase in order; raises on the first failure.  ``ddm_size``
    sets the DDM phase's cells, grids and depth (``smoke_ddm.FULL`` on the
    card, ``smoke_ddm.SMALL`` in the CPU rehearsal); ``warped_size`` the
    warped phase's (``smoke_warped.FULL``, as ``chip_smoke.py`` passes it;
    None leaves the phase out, as the CPU rehearsal of the other phases
    does: ``tests/test_torch_smoke_warped.py`` rehearses it on its own),
    which runs after the DDM route and before the profiles, and adds the
    warped kernels to the ``kernels`` line; ``mesh_size`` the mesh phase's
    (``smoke_mesh.FULL``; None leaves it out, ``tests/test_torch_smoke_
    mesh.py`` rehearses it), which runs after the warped phase, reuses
    (s1)'s lattice, adds its profiled drives to the profiles and its
    per-slab launches to the ``kernels`` line."""
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
            func = None
            for line in text.splitlines():
                if "Compiling entry function" in line:
                    func = line.split("'")[1] if "'" in line else None
                elif "registers" in line or "spill" in line:
                    log(f"ptxas {name} {func}: {line.strip()}")
    budget.check("build")

    cases = kernel_phase(dev, n)
    for c in cases:
        log(f"B1 {c['case']}: rel err {c['max_rel_err']:.2e} | kernel "
            f"{_ms(c['ms'])} (after L2 flush {_ms(c['ms_cold'])}, wrapper "
            f"{_ms(c['wrapper_ms'])}, device, graph replay "
            f"{_ms(c['device_ms'])}), plain {c['plain_ms']:.3f} ms, bound "
            f"{c['bound_ms']:.5f} ms ({c['bound_by']}) | "
            f"{_plan_text(c['plan'])} | before the redesign "
            f"{_was('B1', c['case'], 'f32', 'matvec')} [{card}]")
    budget.check("kernels B1")

    with _env(PLDSO_MG_FUSED_COMPUTE=None):
        fused_cases = fused_kernel_phase(dev, n)
    by_key = {(c["kernel"], c["case"], c["storage"], c["variant"]): c
              for c in fused_cases}
    for c in fused_cases:
        log(f"{c['kernel']} {c['case']} {c['storage']} {c['variant']}: rel "
            f"err {c['max_rel_err']:.2e} (tol {c['tol']:.0e}), bits differ "
            f"{c['bits_differ']} | kernel "
            f"{_ms(c['ms'])} (after L2 flush {_ms(c['ms_cold'])}), plain "
            f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.5f} ms "
            f"({c['bound_by']}) [{card}]")
        if c["kernel"] in ("B3c", "B4c", "B5c"):
            f = by_key[(c["kernel"][:2], c["case"], c["storage"],
                        c["variant"])]
            log(f"{c['kernel']} vs {f['kernel']} {c['case']} {c['storage']} "
                f"{c['variant']}: {_ms(c['ms'])} (graph replay "
                f"{_ms(c.get('device_ms'))}) vs {_ms(f['ms'])} (graph replay "
                f"{_ms(f.get('device_ms'))}); bound {c['bound_ms']:.5f} vs "
                f"{f['bound_ms']:.5f} ms [{card}]")
        if c["kernel"] in ("B2", "B3", "B4", "B3c", "B4c"):
            key = (c["kernel"], c["case"], c["storage"], c["variant"])
            was = f" vs before the redesign {_was(*key)}" \
                if c["kernel"] in ("B2", "B3", "B4") else ""
            log(f"{' '.join(key)}: {_plan_text(c['plan'])} | "
                f"{_ms(c['ms'])} (device, graph replay "
                f"{_ms(c['device_ms'])}){was} [{card}]")
        if c["kernel"] in ("B5", "B5c"):
            p = c["plan"]
            was = B5_BEFORE_MS.get((c["case"], c["storage"], c["variant"])) \
                if c["kernel"] == "B5" else None
            was = "not recorded" if was is None \
                else f"{was:.4f} ms (recorded from commit 9cba2c9)"
            log(f"{c['kernel']} {c['case']} {c['storage']} {c['variant']}: "
                f"plan cluster "
                f"{p['cluster']} x {p['threads']} threads x {p['ipt']} "
                f"items (groups of {p['group']} lanes), d {p['layout']}, "
                f"r^2 in shared memory "
                f"{p['r2_smem']} ({p['smem_bytes']} bytes) | "
                f"{_ms(c['ms'])} (device, graph replay "
                f"{_ms(c['device_ms'])}) vs before the redesign {was} | "
                f"bitwise equal across, "
                f"cluster/layout[/group] event (graph) times: "
                + ", ".join(f"{x['cluster']}/{x['layout']}"
                            + ("" if x["group"] is None else
                               f"/{x['group']}")
                            + f" {_ms(x['ms'])} "
                            f"({_ms(x['device_ms'])})"
                            for x in c["sweep"]) + f" [{card}]")
    budget.check("kernels B2-B5, B3c-B5c")

    cases64 = kernel64_phase(dev, n)
    for c in cases64:
        log(f"B1<double> {c['case']}: rel err {c['max_rel_err']:.2e} (tol "
            f"{KERNEL_F64_TOL:.0e}) | kernel {_ms(c['ms'])} (device, graph "
            f"replay {_ms(c['device_ms'])}), plain "
            f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.5f} ms "
            f"({c['bound_by']}) | {_plan_text(c['plan'])} | before the "
            f"redesign {_was('B1<double>', c['case'], 'f64', 'matvec')} "
            f"[{card}]")
    budget.check("kernel B1 float64")

    vjp_cases = vjp_phase(dev, n)
    for c in vjp_cases:
        storage = c["case"].split()[-1]
        log(f"B1 VJP {c['case']}: u-cotangent rel err {c['u_rel_err']:.2e}, "
            f"r^2-cotangent {c['r2_rel_err']:.2e} (tol {c['tol']:.0e}); "
            f"launched in backward (B1, r^2-cotangent) "
            f"{c['launches_in_backward']} | r^2-cotangent kernel "
            f"{_ms(c['ms'])} (device, graph replay {_ms(c['device_ms'])}), "
            f"its plain closed form {c['plain_ms']:.3f} ms, "
            f"autograd of the gather form {_ms(c['autograd_ms'])}, bound "
            f"{c['bound_ms']:.5f} ms ({c['bound_by']}) | "
            f"{_plan_text(c['plan'])} | before the redesign "
            f"{_was('r2', c['case'], storage, 'vjp')} [{card}]")
    vjp_grids = vjp_grid_phase(dev, n)
    for c in vjp_grids:
        log(f"r^2-cotangent {c['case']} {c['storage']}: rel err "
            f"{c['max_rel_err']:.2e} (tol {c['tol']:.0e}) | kernel "
            f"{_ms(c['ms'])} (device, graph replay {_ms(c['device_ms'])}), "
            f"plain {c['plain_ms']:.3f} ms, bound {c['bound_ms']:.5f} ms "
            f"({c['bound_by']}) | {_plan_text(c['plan'])} | before the "
            f"redesign {_was('r2', c['case'], c['storage'], 'vjp')} "
            f"[{card}]")
    budget.check("B1 VJP")

    probe = probe_phase(dev)
    for c in probe["cases"]:
        rate = "" if c.get("gflops") is None \
            else f", {c['gflops']:.1f} GFLOP/s"
        lib = "" if c["library_ms"] is None \
            else (f", torch.mul {_ms(c['library_ms'])} (P2 / torch.mul "
                  f"{c['ms'] / c['library_ms']:.3f}, not gated)")
        graph = "" if c["kernel"] != "P1" \
            else (f" (device, graph replay {_ms(c['device_ms'])}) (one "
                  f"launch of {LONG_REPS} x REPS, per REPS "
                  f"{_ms(c['long_ms'])})")
        log(f"{c['kernel']} {c['case']}: bitwise equal to plain | kernel "
            f"{_ms(c['ms'])}{graph}{rate}, plain {c['plain_ms']:.4f} "
            f"ms{lib}, bound {c['bound_ms']:.6f} ms ({c['bound_by']}) "
            f"[{card}]")
    log(f"probes entry launches {probe['launches']}")
    budget.check("probes")

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
            f"level {m['kernel_launches']}; B5 launches per level by "
            f"cluster size {m['b5_clusters']} [{card}]")
        budget.check(f"main path {route}")
    # the timed (warm-started) steps must converge like the f32 route's;
    # the cold solve's count is printed beside the f32 route's: with bf16
    # smoother storage (the fused and lo routes alike) it rises with the
    # grid, as the reference's bf16 V-cycle does
    # (tests/test_torch_bf16_iterations.py)
    base, fused = mains["f32"], mains["fused"]
    warm0 = sum(base["warm_iterations"])
    for route, m in mains.items():
        warm = sum(m["warm_iterations"])
        log(f"CG iterations [{route}]: cold {m['cold_iterations']} vs "
            f"[f32] {base['cold_iterations']}, [fused] "
            f"{fused['cold_iterations']}; warm (all timed steps) {warm} vs "
            f"[f32] {warm0}, [fused] {sum(fused['warm_iterations'])}; "
            f"{m['s_per_step']:.4f} s/step vs [fused] "
            f"{fused['s_per_step']:.4f} [{card}]")
        if warm > ITERATION_RISE * warm0 + 1:
            raise AssertionError(
                f"route {route} needs {warm} CG iterations over the timed "
                f"steps against {warm0} on the f32 route")

    design = design_phase(dev, n, steps=steps, windows=windows)
    a, b, c = design["a"], design["b"], design["c"]
    log(f"design (a) f64 {n}^3 compliance, implicit vs analytic g: rel err "
        f"{a['grad_rel_err']:.2e} (tol {IMPLICIT_VS_ANALYTIC_TOL:.0e}); CG "
        f"iterations forward/adjoint {a['iterations']}, analytic "
        f"{a['iterations_analytic']}; implicit step {a['step_s']:.2f} s; "
        f"launches {a['kernel_launches']} [{card}]")
    log(f"design (b) f64 {n}^3 displacement objective, u_imposed X "
        f"{IMPOSED_X}: obj {b['objective']:.9e}; g.v {b['directional']:.9e}"
        f" vs central difference {b['finite_difference']:.9e} (h "
        f"{b['fd_h']}): rel err {b['fd_rel_err']:.2e} (tol {FD_TOL:.0e}); "
        f"CG iterations {b['iterations']}; step {b['step_s']:.2f} s; "
        f"launches {b['kernel_launches']} [{card}]")
    for sd in b["signed_direction"]:
        log(f"design (b), not gated: a direction of random signs at CG tol "
            f"{sd['tol']:.0e}: g.v {sd['directional']:.9e} vs central "
            f"difference {sd['finite_difference']:.9e}: rel err "
            f"{sd['fd_rel_err']:.2e} (sum |g_i v_i| "
            f"{sd['sum_abs_terms']:.6e}) [{card}]")
    log(f"design (c) f32 fused bf16 {n}^3, the same problem: "
        f"{c['s_per_step']:.4f} s/step (windows "
        f"{[round(w, 3) for w in c['window_s']]}) vs the analytic "
        f"compliance step [fused] {mains['fused']['s_per_step']:.4f} s/step;"
        f" g vs (b) rel err {c['grad_rel_err_vs_f64']:.2e} (tol "
        f"{FUSED_VS_F64_TOL:.0e}); bitwise {c['bitwise']}; cold CG "
        f"iterations {c['cold_iterations']}; warm {c['warm_iterations']}; "
        f"plain gather calls {c['plain_gather_calls']}; launches "
        f"{c['kernel_launches']}; B5 launches per level by cluster size "
        f"{c['b5_clusters']} [{card}]")
    budget.check("design gradient")

    opt = optimizer_phase(dev, n, small=min(OPT_SMALL, n))
    o1, o2 = opt["o1"], opt["o2"]
    ev = o1["evaluations"]
    log(f"optimizer (o1) {n}^3 Octet unit_cell ({o1['params']} radii, "
        f"{o1['dofs']} DOF), f64 MG, projected, {OPT_ITERS} iterations: "
        f"build_lattice {o1['build_lattice_s']:.2f} s; problem "
        f"{sum(o1['setup_s'].values()):.2f} s "
        f"{ {k: round(v, 2) for k, v in o1['setup_s'].items()} }; drive "
        f"{o1['drive_s']:.2f} s; value-and-gradient s "
        f"{[round(e['seconds'], 3) for e in ev]}; CG iterations "
        f"forward/adjoint {[(e['forward'], e['adjoint']) for e in ev]}; "
        f"objective {o1['first_objective']:.9e} -> "
        f"{o1['objective']:.9e} ({o1['accepted']} accepted of "
        f"{len(o1['history_objective'])}); density {o1['density']:.9f} "
        f"(bound {OPT_DENSITY}); g.v {o1['directional']:.9e} vs central "
        f"difference {o1['finite_difference']:.9e} (eps {OPT_FD_EPS}): rel "
        f"err {o1['fd_rel_err']:.2e} (tol {OPT_FD_TOL:.0e}); plain gather "
        f"calls {o1['plain_gather_calls']}; launches "
        f"{o1['kernel_launches']} [{card}]")
    u = o2["unstructured"]
    log(f"optimizer (o2) {o2['cells']}^3 Octet FEM_AUTO -> {o2['routed']}, "
        f"SLSQP {o2['iterations']} iterations: objective {o2['objective']:.9e}"
        f" vs the feasible start's {o2['feasible_start_objective']:.9e}, "
        f"density {o2['density']:.9f} ({o2['message']}); unstructured g.v "
        f"{u['directional']:.9e} vs central difference "
        f"{u['finite_difference']:.9e}: rel err {u['fd_rel_err']:.2e}; same "
        f"bits on repeat: structured {o2['same_bits_structured']}, "
        f"unstructured {o2['same_bits_unstructured']}; launches "
        f"{o2['kernel_launches']} [{card}]")
    budget.check("optimizer")

    stat = smoke_statics.statics_phase(
        dev, n, steps=steps, small=min(smoke_statics.SMALL, n),
        cells=tuple(min(c, max(1, n // 4))
                    for c in smoke_statics.FLEXION_CELLS))
    s1, s2, s3 = stat["s1"], stat["s2"], stat["s3"]
    su, ref = s1["setup_s"], s1["reference"]
    log(f"statics (s1) bench.py's second mode, {n}^3 Octet ({s1['dofs']} "
        f"DOF, {s1['beams']} beams), f32 block Jacobi, tol "
        f"{smoke_statics.TOL:g}, chunk {smoke_statics.CHUNK}: build_lattice "
        f"{s1['build_lattice_s']:.2f} s, BCs {s1['bc_s']:.2f} s; setup: "
        f"frames and ordered table (width {su['width']}) "
        f"{su['lattice_s']:.3f} s, step {su['step_s']:.3f} s, block factors "
        f"{su['factors_s']:.4f} s; cold {s1['cold']['iterations']} CG "
        f"iterations in {s1['cold']['s']:.3f} s "
        f"({s1['cold_ms_per_iteration']:.3f} ms/iteration); warm s "
        f"{[round(x, 4) for x in s1['warm_s']]}, iterations "
        f"{s1['warm_iterations']}: {s1['s_per_step']:.4f} s/step, "
        f"{s1['ms_per_iteration']:.3f} ms per CG iteration; compliance "
        f"{s1['compliance']:.9e} (cold {s1['compliance_cold']:.9e}); vs the "
        f"f64 reference (tol {smoke_statics.REF_TOL:g}, "
        f"{ref['iterations']} iterations, {ref['s']:.2f} s): c "
        f"{ref['c_rel_err']:.2e} (tol {smoke_statics.C_TOL:g}), g "
        f"{ref['g_rel_err']:.2e} (tol {smoke_statics.G_TOL:g}); repeated "
        f"step bitwise {s1['bitwise']} [{card}]")
    log(f"statics (s2) {s2['n']}^3 Octet f64 ({s2['dofs']} DOF): step vs "
        f"step.chunked c {s2['form_c_rel_err']:.2e} (tol "
        f"{smoke_statics.S2_C_TOL:g}), g {s2['form_g_rel_err']:.2e} (tol "
        f"{smoke_statics.S2_G_TOL:g}); g.v {s2['directional']:.9e} vs "
        f"central difference {s2['finite_difference']:.9e} (h "
        f"{s2['fd_h']:.1e}): rel err {s2['fd_rel_err']:.2e} (tol "
        f"{smoke_statics.S2_FD_TOL:g}); batch bits {s2['batch_bits']}, "
        f"descent_loop bits {s2['descent_bits']}, repeat bits "
        f"{s2['repeat_bits']}; CG iterations block Jacobi "
        f"{s2['block_iterations']} vs Jacobi {s2['jacobi_iterations']} "
        f"[{card}]")
    for name in ("solve_fem_lattice", "solve_fem_penalized"):
        x = s3[name]
        log(f"statics (s3) {name} {s3['cells']} BCC ({s3['dofs']} DOF "
            f"before subdivision) f64: compliance {x['compliance']:.9e}, "
            f"{x['iterations']} CG iterations, device {x['device_s']:.2f} s"
            f" vs CPU {x['cpu_s']:.2f} s; rel err vs CPU {x['rel_err']:.2e}"
            f" (tol {smoke_statics.S3_TOL:g}); same bits on repeat "
            f"{x['same_bits']} [{card}]")
    x = s3["homogenize_cell"]
    log(f"statics (s3) homogenize_cell Octet f64: C00 {x['C00']:.9e}, Ex "
        f"{x['Ex']:.9e}; device {x['device_s']:.2f} s vs CPU "
        f"{x['cpu_s']:.2f} s; C rel err vs CPU {x['rel_err']:.2e} (tol "
        f"{smoke_statics.S3_TOL:g}); same bits on repeat {x['same_bits']} "
        f"[{card}]")
    budget.check("statics")

    ddm = smoke_ddm.ddm_phase(dev, ddm_size)
    log_ddm(ddm, card, log)
    budget.check("ddm")

    warped = None
    if warped_size is not None:
        from . import smoke_warped
        warped = smoke_warped.warped_phase(dev, warped_size)
        smoke_warped.log_warped(warped, card, log)
        budget.check("warped")
    lattice = s1.pop("lattice")
    mesh = None
    if mesh_size is not None:
        from . import smoke_mesh
        mesh = smoke_mesh.mesh_phase(dev, mesh_size, log, lattice=lattice)
        smoke_mesh.log_mesh(mesh, card, log)
        budget.check("mesh")
    del lattice
    # the profiles come last: once torch.profiler has traced the card, the
    # process's later launches cost the host more (on an H100 the phases
    # run after the profiles read 30-50% more s/step)
    reps = dict(mains, design=c, statics=s1, ddm=ddm["d1"])
    if mesh is not None:
        reps["mesh-m1"] = mesh["m1"]
        for route, r in mesh["m2"]["routes"].items():
            if route == smoke_mesh.PROFILED:
                reps[f"mesh-m2-{route}"] = r
                reps[f"mesh-m2-{route}-one"] = r["one_device"]
            else:
                r.pop("profile_drive"), r.pop("one_device")
    for route, rep in reps.items():
        with _env(**ROUTE_ENV.get(route, ROUTE_ENV["fused"])):
            steps_p = PROFILE_STEPS.get(route, 2)
            if "profile_drive" in rep:
                prof = profile_drive(rep.pop("profile_drive"), dev, route,
                                     steps_p)
            else:
                prof = profile_phase(*rep.pop("profile_inputs"), dev, route,
                                     steps_p)
            rep["profile"] = prof
        log(f"profile [{route}]: {prof['wall_ms']:.1f} ms wall, device busy "
            f"{prof['device_busy_ms']:.1f} ms (idle share "
            f"{prof['idle_share']:.3f}), iterations {prof['iterations']}, "
            f"device events per CG iteration "
            f"{prof['events_per_iteration']:.0f}; B5 {prof['b5_ms']:.1f} ms "
            f"over {prof['b5_launches']} launches; phase "
            f"{prof['phase_s']:.1f} s [{card}]")
    return {"device": info, "build": built, "cases": cases,
            "fused_cases": fused_cases, "cases64": cases64,
            "vjp_cases": vjp_cases, "vjp_grids": vjp_grids, "probe": probe,
            "mains": mains, "design": design, "optimizer": opt,
            "statics": stat, "ddm": ddm, "warped": warped,
            "mesh": mesh,
            "kernels": _with_mesh(kernels_line(
                cases, fused_cases, mains, cases64, vjp_cases + vjp_grids,
                probe, design, opt, warped), mesh),
            "wall_s": budget.elapsed()}


def _with_mesh(entries: List[Dict], mesh: Optional[Dict]) -> List[Dict]:
    if mesh is None:
        return entries
    from . import smoke_mesh
    return smoke_mesh.annotate_kernels(entries, mesh)
