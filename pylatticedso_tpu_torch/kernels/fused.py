"""The fused multigrid smoother: routing, and the wrappers of kernels B3,
B4 and B5 (``csrc/mg_fused.cu``).

They replace the TPU kernels of ``pylatticedso_tpu/parallel/
stencil_pallas.py``'s ``apply.fused``: B3 ``_residual_call`` (fm (b - K x)),
B4 ``_cheb_run_call`` (one Chebyshev step, or its final x + d emit) and B5
``_cheb_full_call`` (a whole smoother in one launch).  Vectors live in the
stencil's ghost-padded layout [nc, 6, Xp, Yp, Zp] in the storage dtype
(``PLDSO_MG_FUSED_DTYPE``: bf16, the default, or f32) between launches,
with zero ghosts; r^2 is [n_e, Xp, Yp, Zp] in the same dtype.

**Routing.**  ``route(slat)`` decides per level whether the fused smoother
exists at all (``ok``) and whether the level's whole smoother runs in one
B5 launch (``single_ok``) or as B3 plus a chain of B4 launches.  The choice
changes the result — B5 keeps x, r and d in float32 across its steps, the
B4 chain rounds them to the storage dtype after every step — so the port
routes exactly as the JAX package does: ``route`` is a plain copy of its
rule (the TPU kernel's scoped-VMEM tile search ``_vmem_est`` /
``_best_tile``, then ``_fits`` and ``T_full``).  The CUDA kernels do NOT
use it for their layout: it only picks B5 or B3 + B4 per level.

On a CPU tensor every wrapper runs its plain torch version (the gather
form of ``parallel/structured.py`` for K, then the same pointwise update
with the same rounding points); on a CUDA tensor it launches its kernel or
raises.  ``launches`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from .stencil import FLOPS_PER_SIDE, StencilMatvec, edge_sides

__all__ = ["FusedSmoother", "route", "has_kernel_matvec", "cheb_static",
           "storage_dtype", "check_compute", "KERNELS"]

PAD = (1, 1, 1, 1, 1, 1)
SOURCE = "pylatticedso_tpu_torch/csrc/mg_fused.cu"
# (kernel name, what it replaces), by the wrapper method that launches it
KERNELS = {
    "residual": ("mg_residual",
                 "pylatticedso_tpu/parallel/stencil_pallas.py:723"),
    "cheb_run": ("mg_cheb_run",
                 "pylatticedso_tpu/parallel/stencil_pallas.py:757"),
    "cheb_full": ("mg_cheb_full",
                  "pylatticedso_tpu/parallel/stencil_pallas.py:809"),
}


def storage_dtype() -> torch.dtype:
    """The fused smoother's storage dtype, from ``PLDSO_MG_FUSED_DTYPE``
    (``bf16``, the default, or anything else for float32 — the JAX
    package's reading of the same variable)."""
    bf16 = os.environ.get("PLDSO_MG_FUSED_DTYPE", "bf16") == "bf16"
    return torch.bfloat16 if bf16 else torch.float32


def check_compute() -> None:
    """``PLDSO_MG_FUSED_COMPUTE=bf16`` (bf16 stencil arithmetic inside the
    fused kernels) is not ported: refuse it rather than run float32."""
    if os.environ.get("PLDSO_MG_FUSED_COMPUTE") == "bf16":
        raise NotImplementedError(
            "PLDSO_MG_FUSED_COMPUTE=bf16 (bf16 arithmetic in the fused "
            "smoother kernels) is not ported: ROADMAP.md queue A, deferred "
            "feature 'fused bf16 compute'")


# ------------------------------------------------------------------ routing
# The JAX rule's TPU tiling settings, fixed at the JAX package's defaults
# (``stencil_pallas.py``: align8 rows :184, the compute-once form :196, the
# hybrid tile cap :225, the scoped-VMEM budget :259).  They mean nothing to
# the CUDA kernels; fixing them keeps routing equal to JAX's at the bench's
# settings.
HYBRID_MAXTILE = 1280
VMEM_BUDGET = 14e6


def _tile_search(slat, tile: int):
    """The JAX rule's tile choice for the Pallas matvec: (T, once, Tmin,
    vmem_est), or None where no tile fits its scoped-VMEM model."""
    X, Y, Z = slat.grid
    Xp, Yp, Zp = X + 2, Y + 2, Z + 2
    F_ = Xp * Yp * Zp
    nc = slat.nc
    n_e = len(slat.edges)
    rows_in = nc * 8                 # align8 rows
    rows_u = nc * 6
    recs = edge_sides(slat, Yp, Zp)
    H = max(max(abs(r["du"]), abs(r["dr"])) for r in recs)
    T = min(int(tile), -(-F_ // 128) * 128)
    if nc > 8:
        T = min(T, HYBRID_MAXTILE)
    Tmin = -(-(H + 1) // 128) * 128
    T = max(T, Tmin)

    def vmem_est(Tc, once_flag):
        blocks = 4 * Tc * (3 * rows_in + 3 * n_e + rows_u) * 2
        w = 0
        for rr in recs:
            if rr["side"]:
                continue
            duw = abs(rr["du"])
            w += (Tc + duw) if (once_flag and duw <= Tc // 2) else 2 * Tc
        margin = 1.5 if nc > 8 else 1.0
        return margin * (blocks + 19.0 * 4.0 * w)

    def best_tile(once_flag):
        for Tc in range(T, Tmin - 1, -128):
            if vmem_est(Tc, once_flag) <= VMEM_BUDGET:
                return Tc
        return None

    t_two = best_tile(False)
    t_once = best_tile(True)
    if t_once is not None and (t_two is None or 2 * t_once >= t_two):
        return t_once, True, Tmin, vmem_est
    if t_two is not None:
        return t_two, False, Tmin, vmem_est
    return None


def has_kernel_matvec(slat, tile: int = 3072) -> bool:
    """True where the JAX package builds its Pallas matvec for a level
    (``structured.py:653-669``): a float32, unwarped lattice whose template
    fits the kernel's scoped-VMEM model.  Only such a level has the
    bf16-I/O matvec ``apply.lo`` (JAX ``prepare_lo`` gives None elsewhere,
    ``multigrid.py:183-189``) and a fused smoother, so the port runs B2 and
    B3-B5 exactly there; elsewhere JAX smooths with its full-precision
    gather form and the port with B1."""
    if slat.dtype != torch.float32 \
            or getattr(slat, "node_transform", None) is not None:
        return False
    return _tile_search(slat, tile) is not None


def route(slat, tile: int = 3072) -> Tuple[bool, bool]:
    """(ok, single_ok) of one level, by the JAX package's rule
    (``stencil_pallas.make_pallas_matvec`` at its default tile and default
    tiling settings).  ``ok`` is False where JAX builds no fused smoother
    (a float64 or warped level, or no tile fits its model, so the level
    has the gather-form matvec)."""
    if not has_kernel_matvec(slat, tile):
        return False, False          # JAX: gather-form matvec, no fused
    T, once, Tmin, vmem_est = _tile_search(slat, tile)
    X, Y, Z = slat.grid
    F_ = (X + 2) * (Y + 2) * (Z + 2)
    rows_in = slat.nc * 8
    io_bytes = 2 if storage_dtype() == torch.bfloat16 else 4

    def fits(Tc):
        return (vmem_est(Tc, once) + io_bytes * Tc * 6 * rows_in * 2
                <= VMEM_BUDGET)

    T_full = max(-(-F_ // 128) * 128, Tmin)
    tf = T_full if fits(T_full) else None
    if tf is None:
        for Tc in range(T, Tmin - 1, -128):
            if fits(Tc):
                tf = Tc
                break
    if tf is None:
        return False, False
    return True, -(-F_ // tf) == 1


def cheb_static(frac: float, degree: int) -> List[Tuple[float, float]]:
    """(c1, c2) of every Chebyshev step: the rho recurrence depends only on
    the spectrum fraction, so these are host floats."""
    sigma = (1.0 + frac) / (1.0 - frac)
    rho, out = 1.0 / sigma, []
    for _ in range(degree):
        rho_new = 1.0 / (2.0 * sigma - rho)
        out.append((rho_new * rho, 2.0 * rho_new))
        rho = rho_new
    return out


def _unpad(v: torch.Tensor) -> torch.Tensor:
    return v[..., 1:-1, 1:-1, 1:-1]


_SIGS = {
    "mg_residual": [ctypes.c_int] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [ctypes.c_void_p],
    "mg_cheb_run": [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9
    + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
    + [ctypes.c_float] * 3 + [ctypes.c_void_p],
    "mg_cheb_full": [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 11
    + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
    + [ctypes.c_float] * 3 + [ctypes.c_void_p],
    "mg_cheb_full_smem_bytes": [],
    "mg_cheb_full_max_degree": [],
}


def _fn(name: str):
    fn = getattr(build.load("mg_fused"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGS[name]
        fn.restype = ctypes.c_int
    return fn


class FusedSmoother:
    """B3, B4 and B5 for one lattice (one multigrid level).

    ``stencil`` is the level's B1 wrapper: its edge-side table, material
    constants and plain gather form serve these kernels too.
    """

    source = SOURCE

    def __init__(self, slat, stencil: StencilMatvec):
        self.ok, self.single_ok = route(slat)
        self.mv = stencil
        self.grid = tuple(slat.grid)
        self.nc = slat.nc
        self.n_e = len(slat.edges)
        self.launches: Dict[str, int] = {k: 0 for k in KERNELS}

    # ------------------------------------------------------------ helpers
    @property
    def padded(self) -> Tuple[int, int, int]:
        return tuple(g + 2 for g in self.grid)

    def sc(self, lmax: torch.Tensor, frac: float) -> torch.Tensor:
        """[inv_theta, inv_delta] of the spectrum [frac lmax, lmax], as a
        float32 device tensor (the kernels read it; no host sync)."""
        lmax = lmax.to(torch.float32)
        inv_theta = 2.0 / ((1.0 + frac) * lmax)
        inv_delta = 2.0 / ((1.0 - frac) * lmax)
        return torch.stack([inv_theta, inv_delta])

    def work(self, kernel: str, itemsize: int, final: bool = False,
             degree: int = 0, with_x0: bool = False) -> Tuple[int, int]:
        """(bytes, operations) of one launch: each input read once and each
        output written once (padded fields, ``itemsize`` bytes), and 110
        operations per edge side per interior point for each stencil
        application plus the pointwise update's operations per DOF."""
        X, Y, Z = self.grid
        Fp = (X + 2) * (Y + 2) * (Z + 2)
        N = X * Y * Z
        R = self.nc * 6
        stencil = FLOPS_PER_SIDE * self.mv.n_sides * N
        if kernel == "residual":       # x, b, fm, r^2 -> out
            return (itemsize * (4 * R * Fp + self.n_e * Fp),
                    stencil + 2 * R * N)
        if kernel == "cheb_run":       # x, r, d, fd, r^2 -> 1 or 3 outputs
            n_out = 1 if final else 3
            return (itemsize * ((4 + n_out) * R * Fp + self.n_e * Fp),
                    stencil + (6 + int(final)) * R * N)
        # cheb_full: b, [x0], fd, r^2 -> out; degree (+1) stencils
        n_in = 3 if with_x0 else 2
        return (itemsize * ((n_in + 1) * R * Fp + self.n_e * Fp),
                (degree + int(with_x0)) * stencil + (6 * degree + 3) * R * N)

    def _check(self, what: str, vecs, sc: Optional[torch.Tensor],
               r2: torch.Tensor) -> torch.dtype:
        io = vecs[0].dtype
        if io not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"{what} stores float32 or bfloat16 (got {io})")
        dev = vecs[0].device
        shape = (self.nc, 6) + self.padded
        for v in vecs:
            if v.dtype != io or v.device != dev or tuple(v.shape) != shape \
                    or not v.is_contiguous():
                raise ValueError(
                    f"{what}: vectors must be contiguous {shape} {io} on "
                    f"{dev}; got {tuple(v.shape)} {v.dtype} on {v.device}")
        if r2.dtype != io or r2.device != dev or not r2.is_contiguous() \
                or tuple(r2.shape) != (self.n_e,) + self.padded:
            raise ValueError(f"{what}: r^2 must be contiguous "
                             f"{(self.n_e,) + self.padded} {io} on {dev}")
        if sc is not None and (sc.dtype != torch.float32 or sc.device != dev
                               or tuple(sc.shape) != (2,)):
            raise ValueError(f"{what}: sc must be float32 (2,) on {dev}")
        return io

    def _args(self, device):
        sides, class_start = self.mv.tables(device)
        X, Y, Z = self.grid
        return ([sides.data_ptr(), class_start.data_ptr(), self.nc, X, Y, Z,
                 *self.mv.consts,
                 torch.cuda.current_stream(device).cuda_stream])

    @staticmethod
    def _raise(name: str, rc: int) -> None:
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")

    # ------------------------------------------------------- plain versions
    # K is the gather form (self.mv.plain) on interior fields, in its own
    # dtype; outputs are padded back with zero ghosts, as the kernels write
    def _w(self, v: torch.Tensor) -> torch.Tensor:
        return _unpad(v).to(self.mv.dtype)

    def plain_residual(self, b, x, fm, r2):
        io = b.dtype
        r2w = r2.to(self.mv.dtype)
        out = self._w(fm) * (self._w(b) - self.mv.plain(self._w(x), r2w))
        return F.pad(out, PAD).to(io)

    def plain_cheb_run(self, x, r, d, fd, sc, r2, c1, c2, final):
        io = x.dtype
        wd = self.mv.dtype
        dc = self._w(d)
        kd = self.mv.plain(dc, r2.to(wd))
        x1 = self._w(x) + dc
        r1 = self._w(r) - kd
        d1 = c1 * dc + ((c2 * sc[1].to(wd)) * r1) * self._w(fd)
        if final:
            return F.pad(x1 + d1, PAD).to(io)
        return tuple(F.pad(v, PAD).to(io) for v in (x1, r1, d1))

    def plain_cheb_full(self, b, x0, fd, sc, r2, frac, degree):
        io = b.dtype
        wd = self.mv.dtype
        r2w = r2.to(wd)
        bw, fdw = self._w(b), self._w(fd)
        inv_theta, inv_delta = sc[0].to(wd), sc[1].to(wd)
        if x0 is not None:
            x = self._w(x0)
            r = bw - self.mv.plain(x, r2w)
        else:
            x = torch.zeros_like(bw)
            r = bw
        d = (r * fdw) * inv_theta
        for c1, c2 in cheb_static(frac, degree):
            kd = self.mv.plain(d, r2w)
            x = x + d
            r = r - kd
            d = c1 * d + ((c2 * inv_delta) * r) * fdw
        return F.pad(x + d, PAD).to(io)

    # ------------------------------------------------------------ wrappers
    def residual(self, b, x, fm, r2):
        """B3: fm (b - K x), rounded to the storage dtype."""
        if b.device.type == "cpu":
            return self.plain_residual(b, x, fm, r2)
        io = self._check("B3", (b, x, fm), None, r2)
        out = torch.empty_like(b)
        rc = _fn("mg_residual")(
            int(io == torch.bfloat16), x.data_ptr(), b.data_ptr(),
            fm.data_ptr(), r2.data_ptr(), out.data_ptr(),
            *self._args(b.device))
        self._raise("mg_residual", rc)
        self.launches["residual"] += 1
        return out

    def cheb_run(self, x, r, d, fd, sc, r2, c1: float, c2: float,
                 final: bool):
        """B4: one Chebyshev step; (x1, r1, d1), or x1 + d1 when
        ``final``."""
        if x.device.type == "cpu":
            return self.plain_cheb_run(x, r, d, fd, sc, r2, c1, c2, final)
        io = self._check("B4", (x, r, d, fd), sc, r2)
        x1 = torch.empty_like(x)
        r1 = d1 = None
        if not final:
            r1, d1 = torch.empty_like(x), torch.empty_like(x)
        ptr = lambda t: None if t is None else t.data_ptr()
        rc = _fn("mg_cheb_run")(
            int(io == torch.bfloat16), int(final), x.data_ptr(),
            r.data_ptr(), d.data_ptr(), fd.data_ptr(), sc.data_ptr(),
            r2.data_ptr(), x1.data_ptr(), ptr(r1), ptr(d1), c1, c2,
            *self._args(x.device))
        self._raise("mg_cheb_run", rc)
        self.launches["cheb_run"] += 1
        return x1 if final else (x1, r1, d1)

    def cheb_full(self, b, x0, fd, sc, r2, frac: float, degree: int):
        """B5: the whole smoother (x0 residual when ``x0`` is given,
        ``degree`` steps, x + d) in one launch, on a single-program level
        only."""
        if not self.single_ok:
            raise ValueError(
                f"B5 runs only on levels the routing marks single (grid "
                f"{self.grid} is not): use B3 + B4")
        if b.device.type == "cpu":
            return self.plain_cheb_full(b, x0, fd, sc, r2, frac, degree)
        vecs = (b, fd) if x0 is None else (b, fd, x0)
        io = self._check("B5", vecs, sc, r2)
        if not 0 <= degree <= _fn("mg_cheb_full_max_degree")():
            raise ValueError(f"B5 degree {degree} out of range")
        cs = cheb_static(frac, degree)
        c1 = (ctypes.c_float * max(degree, 1))(*[a for a, _ in cs])
        c2 = (ctypes.c_float * max(degree, 1))(*[b_ for _, b_ in cs])
        n = b.numel()
        scratch = torch.empty(2 * n, dtype=torch.float32, device=b.device)
        dg = None
        if 4 * n > _fn("mg_cheb_full_smem_bytes")():
            dg = torch.empty(n, dtype=torch.float32, device=b.device)
        out = torch.empty_like(b)
        rc = _fn("mg_cheb_full")(
            int(io == torch.bfloat16), int(x0 is not None), b.data_ptr(),
            None if x0 is None else x0.data_ptr(), fd.data_ptr(),
            sc.data_ptr(), r2.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), scratch.data_ptr() + 4 * n,
            None if dg is None else dg.data_ptr(),
            ctypes.cast(c1, ctypes.c_void_p), ctypes.cast(c2, ctypes.c_void_p),
            degree, *self._args(b.device))
        self._raise("mg_cheb_full", rc)
        self.launches["cheb_full"] += 1
        return out
