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

**B5's launch.**  B5 runs the level on one thread-block cluster
(``b5_plan``): the cluster size follows a fixed rule from the level's
interior item count, each block owns a contiguous share of the interior
list (``b5_items``), and d sits in every block's shared memory where it
fits, in global scratch elsewhere.  The result is the same bits whatever
the cluster size or layout.

**B3's and B4's launch.**  B3 and B4 run on B1's slab plan (``b3_plan``,
``b4_plan``: runs of a padded plane's flat points, one thread per (class,
point)), over every padded plane, ghosts included.  Every kernel reads the
level's one side table, with the grid's offsets (``StencilMatvec.tables``).

On a CPU tensor every wrapper runs its plain torch version (the gather
form of ``parallel/structured.py`` for K, then the same pointwise update
with the same rounding points); on a CUDA tensor it launches its kernel
(through ``kernels/launch.py``) or raises.  ``launches`` counts each
kernel's launches, ``b5_launches`` B5's by cluster size.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import launch
from .stencil import FLOPS_PER_SIDE, SIDE_DTYPE, StencilMatvec, edge_sides

__all__ = ["FusedSmoother", "route", "has_kernel_matvec", "cheb_static",
           "storage_dtype", "check_compute", "KERNELS", "b5_plan",
           "b5_items", "b5_partition", "B5_CLUSTERS"]

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


# ------------------------------------------------------------ B5's plan
# B5 runs one thread-block cluster per launch (csrc/mg_fused.cu).  The
# plan is made here, on the host: the cluster size, the partition of the
# level's interior items over its blocks and threads, and where d and r^2
# live.  The kernel takes it as it is.  The layouts of d: a full copy in
# every block's shared memory, each block's updates broadcast into all of
# them, or float global scratch.
B5_LAYOUTS = {"bcast": 0, "global": 1}          # csrc's B5_BCAST, B5_GLOBAL
# the layout of d on a level whose d fits a block's shared memory
B5_SMEM_LAYOUT = "bcast"
B5_CLUSTERS = (1, 2, 4, 8, 16)  # 16 needs the non-portable cluster size
# the rule: the smallest cluster that leaves <= 256 items to a block (one
# item a thread); on an H100 it picks the fastest measured cluster at 7^3
# (8), 4^3 (2), 2^3 (1) and the hybrid check case (4)
B5_ITEMS_PER_BLOCK = 256
B5_MAX_THREADS = 256            # csrc's B5_MAX_THREADS
B5_MAX_IPT = 4                  # items per thread, csrc's B5_MAX_IPT
B5_Q_BITS = 22                  # csrc's B5_Q_BITS: (class << 22) | point
B5_SMEM_LIMIT = 227 * 1024      # csrc's MAX_SMEM: one block's dynamic, sm_90
B5_MAX_DEGREE = 64              # csrc's MAX_DEGREE (Chebyshev coefficients)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def b5_smem_bytes(layout: str, nc: int, Fp: int, n_sides: int, n_e: int,
                  r2_smem: bool, itemsize: int) -> int:
    """Dynamic shared memory of one B5 block, as the kernel carves it up
    (the one place its size is decided; the launch passes it): the sides
    table, class_start, d in float (layout ``bcast``) and r^2 in the
    storage type."""
    n = _align16(n_sides * SIDE_DTYPE.itemsize) + _align16(4 * (nc + 1))
    if layout == "bcast":
        n += _align16(4 * nc * 6 * Fp)
    if r2_smem:
        n += _align16(itemsize * n_e * Fp)
    return n


def b5_plan(nc: int, grid, n_e: int, n_sides: int, itemsize: int,
            cluster: Optional[int] = None,
            layout: Optional[str] = None) -> Dict:
    """B5's launch plan for a level: ``cluster`` blocks (by default the
    rule: the smallest power of two that leaves at most
    ``B5_ITEMS_PER_BLOCK`` interior items to a block), ``per_block``
    contiguous items per block, ``threads`` threads of ``ipt`` items each;
    d in shared memory (``B5_SMEM_LAYOUT``) where it fits one block, else
    in global scratch (``layout`` forces one); r^2 staged in shared memory
    where it fits after d.  Raises ValueError for a plan the kernel cannot
    run."""
    X, Y, Z = grid
    Fp = (X + 2) * (Y + 2) * (Z + 2)
    n_items = nc * X * Y * Z
    if Fp >= 1 << B5_Q_BITS:
        raise ValueError(f"B5: {Fp} padded points per class exceed the "
                         f"item encoding (2^{B5_Q_BITS})")
    if cluster is None:
        cluster = 1
        while cluster < B5_CLUSTERS[-1] \
                and -(-n_items // cluster) > B5_ITEMS_PER_BLOCK:
            cluster *= 2
    if cluster not in B5_CLUSTERS or cluster > n_items:
        raise ValueError(f"B5: cluster {cluster} for {n_items} items")
    per_block = -(-n_items // cluster)
    threads = min(B5_MAX_THREADS, -(-per_block // 32) * 32)
    ipt = -(-per_block // threads)
    if ipt > B5_MAX_IPT:
        raise ValueError(
            f"B5: {n_items} interior items do not fit a cluster of "
            f"{cluster} blocks of {B5_MAX_THREADS} threads x {B5_MAX_IPT}")
    size = lambda lay, r2s: b5_smem_bytes(lay, nc, Fp, n_sides, n_e, r2s,
                                          itemsize)
    if layout is None:
        layout = B5_SMEM_LAYOUT \
            if size(B5_SMEM_LAYOUT, False) <= B5_SMEM_LIMIT else "global"
    if layout not in B5_LAYOUTS:
        raise ValueError(f"B5: layout {layout!r}")
    r2_smem = size(layout, True) <= B5_SMEM_LIMIT
    smem = size(layout, r2_smem)
    if smem > B5_SMEM_LIMIT:
        raise ValueError(f"B5: layout {layout!r} needs {smem} bytes of "
                         f"shared memory (limit {B5_SMEM_LIMIT})")
    return {"layout": layout, "cluster": cluster, "threads": threads,
            "ipt": ipt, "per_block": per_block, "n_items": n_items,
            "n_sides": n_sides, "n_e": n_e, "r2_smem": r2_smem,
            "smem_bytes": smem}


def b5_items(nc: int, grid) -> np.ndarray:
    """The level's interior list, as the kernel reads it: (class << 22) |
    padded point of every interior (class, point), in ascending order."""
    X, Y, Z = grid
    Yp, Zp = Y + 2, Z + 2
    x, y, z = np.meshgrid(np.arange(1, X + 1), np.arange(1, Y + 1),
                          np.arange(1, Z + 1), indexing="ij")
    q = (x * (Yp * Zp) + y * Zp + z).reshape(-1)
    c = np.repeat(np.arange(nc), q.size)
    return ((c << B5_Q_BITS) | np.tile(q, nc)).astype(np.int32)


def b5_partition(plan: Dict) -> List[np.ndarray]:
    """Per block, the items (indices into ``b5_items``) its threads own, in
    the kernel's order (thread t, slot j: block start + t + j * threads)."""
    out = []
    for blk in range(plan["cluster"]):
        i0 = blk * plan["per_block"]
        i1 = min(i0 + plan["per_block"], plan["n_items"])
        t = np.arange(plan["threads"])
        idx = np.concatenate([i0 + t + j * plan["threads"]
                              for j in range(plan["ipt"])])
        out.append(idx[idx < i1])
    return out


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
        # B5's plan and launches by cluster size, for the reports
        self.b5_plans: Dict[tuple, Dict] = {}
        self.b5_launches: Dict[int, int] = {}
        self._dev: Dict[tuple, object] = {}     # per-device launch args
        self._coefs: Dict[tuple, tuple] = {}    # (frac, degree) -> c1, c2
        padded = tuple(g + 2 for g in self.grid)
        self._shapes = (torch.Size((self.nc, 6) + padded),
                        torch.Size((self.n_e,) + padded))

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
        """The storage dtype of ``vecs``; raises unless every vector, r^2
        and sc are contiguous, of the level's shapes, of one storage dtype
        (sc float32) and on one CUDA device."""
        io = vecs[0].dtype
        if io is not torch.float32 and io is not torch.bfloat16:
            raise NotImplementedError(
                f"{what} stores float32 or bfloat16 (got {io})")
        dev = vecs[0].get_device()
        shape, r2_shape = self._shapes
        for v in vecs:
            if v.dtype is not io or v.get_device() != dev \
                    or v.shape != shape or not v.is_contiguous():
                raise ValueError(
                    f"{what}: vectors must be contiguous {tuple(shape)} {io} "
                    f"on cuda:{dev}; got {tuple(v.shape)} {v.dtype} on "
                    f"{v.device}")
        if r2.dtype is not io or r2.get_device() != dev \
                or r2.shape != r2_shape or not r2.is_contiguous():
            raise ValueError(f"{what}: r^2 must be contiguous "
                             f"{tuple(r2_shape)} {io} on cuda:{dev}")
        if sc is not None and (sc.dtype is not torch.float32
                               or sc.get_device() != dev
                               or sc.shape != (2,)):
            raise ValueError(f"{what}: sc must be float32 (2,) on cuda:{dev}")
        return io

    def _static(self, index: int) -> tuple:
        """B5's launch arguments that never change on device ``index``:
        the side table, class_start, grid and material constants."""
        key = ("stencil", index)
        args = self._dev.get(key)
        if args is None:
            sides, class_start = self.mv.tables(torch.device("cuda", index))
            args = (sides.data_ptr(), class_start.data_ptr(), self.nc,
                    *self.grid, *self.mv.consts)
            self._dev[key] = args
        return args

    def _static_slab(self, index: int, io: torch.dtype,
                     final: Optional[bool] = None) -> tuple:
        """The launch arguments of B3 (``final`` None) or B4 that never
        change on device ``index``: B5's, with the slab plan's run after
        class_start."""
        key = ("B3" if final is None else "B4", index, io, final)
        args = self._dev.get(key)
        if args is None:
            plan = self.b3_plan(io, index) if final is None \
                else self.b4_plan(io, final, index)
            sides, class_start, *rest = self._static(index)
            args = self._dev[key] = (sides, class_start, plan["run"], *rest)
        return args

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
    @staticmethod
    def _cpu_only(t: torch.Tensor) -> None:
        """Off the card only a CPU tensor is taken (by the plain
        version)."""
        if t.device.type != "cpu":
            raise ValueError(f"the fused kernels run on CPU (plain) or CUDA "
                             f"tensors, got {t.device}")

    def residual(self, b, x, fm, r2):
        """B3: fm (b - K x), rounded to the storage dtype."""
        if not b.is_cuda:
            self._cpu_only(b)
            return self.plain_residual(b, x, fm, r2)
        io = self._check("B3", (b, x, fm), None, r2)
        out = torch.empty_like(b)
        dev = b.get_device()
        rc = launch.functions("mg_fused")["mg_residual"](
            int(io == torch.bfloat16), x.data_ptr(), b.data_ptr(),
            fm.data_ptr(), r2.data_ptr(), out.data_ptr(),
            *self._static_slab(dev, io), launch.stream(dev))
        launch.check("mg_residual", rc)
        self.launches["residual"] += 1
        return out

    def b3_plan(self, io: torch.dtype, device: Optional[int] = None) -> Dict:
        """B3's slab plan on this level (``StencilMatvec.slab_plan`` over
        the padded planes); on a card its blocks per SM come from B3's own
        query."""
        dtype = int(io == torch.bfloat16)
        occ = lambda p: launch.functions("mg_fused")["mg_residual_occupancy"](
            dtype, p["threads"])
        return self.mv.slab_plan(io, device, kernel="B3", occupancy=occ)

    def b4_plan(self, io: torch.dtype, final: bool,
                device: Optional[int] = None) -> Dict:
        """B4's slab plan on this level (``StencilMatvec.slab_plan`` over
        the padded planes); on a card its blocks per SM come from B4's own
        query (each variant's registers differ)."""
        dtype = int(io == torch.bfloat16)
        occ = lambda p: launch.functions("mg_fused")["mg_cheb_run_occupancy"](
            dtype, int(final), p["threads"])
        return self.mv.slab_plan(io, device,
                                 kernel=f"B4{' final' if final else ''}",
                                 occupancy=occ)

    def cheb_run(self, x, r, d, fd, sc, r2, c1: float, c2: float,
                 final: bool):
        """B4: one Chebyshev step; (x1, r1, d1), or x1 + d1 when
        ``final``."""
        if not x.is_cuda:
            self._cpu_only(x)
            return self.plain_cheb_run(x, r, d, fd, sc, r2, c1, c2, final)
        io = self._check("B4", (x, r, d, fd), sc, r2)
        x1 = torch.empty_like(x)
        r1 = d1 = None
        if not final:
            r1, d1 = torch.empty_like(x), torch.empty_like(x)
        dev = x.get_device()
        rc = launch.functions("mg_fused")["mg_cheb_run"](
            int(io == torch.bfloat16), int(final), x.data_ptr(),
            r.data_ptr(), d.data_ptr(), fd.data_ptr(), sc.data_ptr(),
            r2.data_ptr(), x1.data_ptr(), None if final else r1.data_ptr(),
            None if final else d1.data_ptr(), c1, c2,
            *self._static_slab(dev, io, final),
            launch.stream(dev))
        launch.check("mg_cheb_run", rc)
        self.launches["cheb_run"] += 1
        return x1 if final else (x1, r1, d1)

    def b5_plan(self, io: torch.dtype, with_x0: bool = False,
                cluster: Optional[int] = None, layout: Optional[str] = None,
                device: Optional[int] = None) -> Dict:
        """B5's plan on this level (``b5_plan``) for storage ``io``.  On a
        card (``device``) the plan is asked of the card once, before its
        first launch there (plans are cached), and raises if the card
        cannot hold one such cluster."""
        key = (io, with_x0, cluster, layout, device)
        plan = self.b5_plans.get(key)
        if plan is not None:
            return plan
        itemsize = torch.finfo(io).bits // 8
        plan = b5_plan(self.nc, self.grid, self.n_e, self.mv.n_sides,
                       itemsize, cluster, layout)
        if device is not None:
            fits = launch.functions("mg_fused")["mg_cheb_full_max_clusters"](
                int(io == torch.bfloat16), int(with_x0),
                B5_LAYOUTS[plan["layout"]], plan["cluster"], plan["threads"],
                plan["smem_bytes"])
            if fits < 0:
                raise RuntimeError(f"B5 cluster query failed: cudaError "
                                   f"{-fits}")
            if fits == 0:
                raise ValueError(f"B5: the card cannot hold a cluster of "
                                 f"{plan['cluster']} for grid {self.grid}")
        self.b5_plans[key] = plan
        return plan

    def _b5_items(self, index: int) -> int:
        """Device pointer of the interior list, uploaded once."""
        key = ("items", index)
        items = self._dev.get(key)
        if items is None:
            items = torch.from_numpy(b5_items(self.nc, self.grid)).to(
                torch.device("cuda", index))
            self._dev[key] = items
        return items.data_ptr()

    def _b5_coefs(self, frac: float, degree: int) -> Tuple[int, int]:
        """Host addresses of the (c1, c2) arrays of ``cheb_static``, made
        once per (frac, degree)."""
        key = (frac, degree)
        got = self._coefs.get(key)
        if got is None:
            cs = cheb_static(frac, degree)
            c1 = (ctypes.c_float * max(degree, 1))(*[a for a, _ in cs])
            c2 = (ctypes.c_float * max(degree, 1))(*[b for _, b in cs])
            got = (c1, c2, ctypes.addressof(c1), ctypes.addressof(c2))
            self._coefs[key] = got
        return got[2], got[3]

    def cheb_full(self, b, x0, fd, sc, r2, frac: float, degree: int,
                  cluster: Optional[int] = None,
                  layout: Optional[str] = None):
        """B5: the whole smoother (x0 residual when ``x0`` is given,
        ``degree`` steps, x + d) in one launch, on a single-program level
        only.  ``cluster`` and ``layout`` override the plan's (the card
        tests and ``chip_smoke.py`` run every one; the result is the same
        bits whatever they are)."""
        if not self.single_ok:
            raise ValueError(
                f"B5 runs only on levels the routing marks single (grid "
                f"{self.grid} is not): use B3 + B4")
        if not b.is_cuda:
            self._cpu_only(b)
            return self.plain_cheb_full(b, x0, fd, sc, r2, frac, degree)
        vecs = (b, fd) if x0 is None else (b, fd, x0)
        io = self._check("B5", vecs, sc, r2)
        if not 0 <= degree <= B5_MAX_DEGREE:
            raise ValueError(f"B5 degree {degree} out of range")
        dev = b.get_device()
        plan = self.b5_plan(io, x0 is not None, cluster, layout, dev)
        items = self._b5_items(dev)
        c1, c2 = self._b5_coefs(frac, degree)
        dg = None
        if plan["layout"] == "global":
            dg = torch.empty(b.numel(), dtype=torch.float32, device=b.device)
        out = torch.empty_like(b)
        rc = launch.functions("mg_fused")["mg_cheb_full"](
            int(io == torch.bfloat16), int(x0 is not None),
            B5_LAYOUTS[plan["layout"]], b.data_ptr(),
            None if x0 is None else x0.data_ptr(), fd.data_ptr(),
            sc.data_ptr(), r2.data_ptr(), out.data_ptr(),
            None if dg is None else dg.data_ptr(), items, c1, c2,
            degree, plan["cluster"], plan["threads"], plan["ipt"],
            plan["per_block"], plan["n_items"], plan["n_sides"], self.n_e,
            int(plan["r2_smem"]), plan["smem_bytes"], *self._static(dev),
            launch.stream(dev))
        launch.check("mg_cheb_full", rc)
        self.launches["cheb_full"] += 1
        self.b5_launches[plan["cluster"]] = \
            self.b5_launches.get(plan["cluster"], 0) + 1
        return out

