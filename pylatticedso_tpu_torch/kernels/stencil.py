"""Wrappers of the stencil matvec kernels B1 and B2
(``csrc/stencil_matvec.cu``).

B1 replaces the TPU kernel ``make_pallas_matvec -> make_call(jnp.float32)``
of ``pylatticedso_tpu/parallel/stencil_pallas.py``: the structured
Timoshenko stencil K.u over ghost-padded class fields, with a float32 and a
float64 instance (the JAX package runs float64 through its XLA gather
form).  B2 replaces ``make_call(jnp.bfloat16)`` (``apply.lo``): the same
K.u with bfloat16 loads and stores and float32 arithmetic, the matvec of
the multigrid's bf16-I/O smoother.

``StencilMatvec(slat, plain_padded, plain_vjp_padded)`` is the
``apply(u, r2p)`` of one lattice's operator, and ``apply.lo(u_lo, r2_lo)``
its bf16-I/O form; ``apply_padded(up, r2p)`` takes an already ghost-padded
u, whose ghosts may hold a neighbour slab's planes (``LatticeSlab``: the
operator on one slab of a mesh, ``parallel/slabs.py``).
On a CPU tensor each returns its plain version, the gather form of
``parallel/structured.py`` (for ``lo``: on the bf16 inputs widened, the
result rounded to bf16).  On a CUDA tensor each launches its kernel or
raises — there is no fallback.  ``launches`` counts B1's float32
launches, ``launches_f64`` its float64 launches (in either: those on a
cotangent too), ``launches_vjp`` the r^2-cotangent kernel's launches and
``launches_lo`` B2 launches.

On a warped lattice (``node_transform``) the wrapper is B1w, the warped
variant: the same K.u with each side's frame and length read from the
ghost-padded geometry field ``geo`` [n_e, 10, Xp, Yp, Zp] at its r^2
anchor, in float32 and float64 instances, and the warped r^2-cotangent.
The JAX package has no Pallas kernel there (``stencil_pallas.py:88-92``
declines warped lattices; its XLA gather form reads the same fields), so
these replace no TPU kernel; they exist because a CUDA tensor never takes
the plain form.  Their launches count in ``launches_warped``,
``launches_warped_f64`` and ``launches_vjp_warped``; a warped lattice has
no B2 (JAX builds no Pallas matvec for it, so no ``prepare_lo``).

B1 is differentiable, as the JAX kernel is a ``jax.custom_vjp``
(``stencil_pallas.py:575-588``): when a gradient would flow, ``apply`` runs
the ``torch.autograd.Function`` ``_B1``.  Its u-cotangent is B1 itself
launched on the cotangent (K is symmetric in u); its r^2-cotangent is
``vjp_r2``, the kernel ``stencil_vjp_r2`` (one thread per beam: its
strains and r^2-derivative row formed once, dotted with the cotangent at
both endpoints in a fixed order, no atomics), whose plain version
``plain_vjp_r2`` is the closed form of the gather form's r^2-derivative in
torch (JAX computes that part in XLA).  B2 and the fused kernels are never
differentiated.

Every kernel of the port reads the edge sides from one device table built
here from ``edge_sides`` (the counterpart of
``stencil_pallas._edge_sides``), sorted by self class so that each class's
sides keep the gather form's order, with the launch grid's offsets written
in (``tables``).  B1 and B2 run on the slab plan made here (``slab_plan``:
runs of one padded plane's flat points, one thread per (class, point));
the r^2-cotangent on the beam plan (``beam_plan``: runs of one padded
plane's flat points, a warp per edge, a thread per beam and point),
reading each edge's side A record and its row of the beam table
(``beam_table``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import launch

__all__ = ["StencilMatvec", "LatticeSlab", "edge_sides", "side_table",
           "beam_table", "stencil_reach", "slab_plan", "beam_plan",
           "SIDE_DTYPE", "SIDE_DTYPE_F64", "FLOPS_PER_SIDE"]

PAD = (1, 1, 1, 1, 1, 1)

# must match ``struct Side`` in csrc/stencil_body.cuh (64 bytes)
SIDE_DTYPE = np.dtype([
    ("co", "<i4"), ("du", "<i4"), ("dr", "<i4"), ("ei", "<i4"),
    ("side", "<i4"), ("t", "<f4", (3,)), ("a1", "<f4", (3,)),
    ("a2", "<f4", (3,)), ("invL", "<f4"), ("halfL", "<f4")])
assert SIDE_DTYPE.itemsize == 64
# must match ``struct SideD`` (112 bytes): the float64 instance's record
SIDE_DTYPE_F64 = np.dtype([
    ("co", "<i4"), ("du", "<i4"), ("dr", "<i4"), ("ei", "<i4"),
    ("side", "<i4"), ("pad", "<i4"), ("t", "<f8", (3,)),
    ("a1", "<f8", (3,)), ("a2", "<f8", (3,)), ("invL", "<f8"),
    ("halfL", "<f8")])
assert SIDE_DTYPE_F64.itemsize == 112

# operations per edge side per output point (strains, forces, accumulate);
# the JAX cost estimate uses the same figure (stencil_pallas.py:540)
FLOPS_PER_SIDE = 110


def edge_sides(slat, Yp: int, Zp: int) -> List[dict]:
    """Static per-edge-side records: self/other class, flat shifts in the
    padded grid, frame — the same records, in the same order, as
    ``stencil_pallas._edge_sides`` — and the shifts as (x, y, z) vectors
    (``du3``, ``dr3``), from which the slab plan reads the reach."""
    recs = []
    flat = lambda v: int(v[0]) * (Yp * Zp) + int(v[1]) * Zp + int(v[2])
    for ei, e in enumerate(slat.edges):
        d = (e["ob"][0] - e["oa"][0], e["ob"][1] - e["oa"][1],
             e["ob"][2] - e["oa"][2])
        # side A: output class ca at p; other endpoint at p + d; r^2 at p - oa
        du3, dr3 = tuple(int(v) for v in d), tuple(-int(o) for o in e["oa"])
        recs.append(dict(ei=ei, side=0, cs=e["ca"], co=e["cb"],
                         du=flat(du3), dr=flat(dr3), du3=du3, dr3=dr3,
                         t=e["t"], a1=e["a1"], a2=e["a2"], L=e["L"]))
        # side B: output class cb at p; other endpoint at p - d; r^2 at p - ob
        du3, dr3 = tuple(-v for v in du3), tuple(-int(o) for o in e["ob"])
        recs.append(dict(ei=ei, side=1, cs=e["cb"], co=e["ca"],
                         du=flat(du3), dr=flat(dr3), du3=du3, dr3=dr3,
                         t=e["t"], a1=e["a1"], a2=e["a2"], L=e["L"]))
    return recs


def side_table(slat, dtype=SIDE_DTYPE) -> Tuple[np.ndarray, np.ndarray]:
    """(sides [n_sides] ``dtype`` (SIDE_DTYPE or SIDE_DTYPE_F64),
    class_start [nc + 1] int32): the records of ``edge_sides`` stably
    sorted by self class."""
    Yp, Zp = slat.grid[1] + 2, slat.grid[2] + 2
    recs = edge_sides(slat, Yp, Zp)
    order = sorted(range(len(recs)), key=lambda i: recs[i]["cs"])
    table = np.zeros(len(recs), dtype)
    for j, i in enumerate(order):
        r = recs[i]
        for k in ("co", "du", "dr", "ei", "side", "t", "a1", "a2"):
            table[k][j] = r[k]
        table["invL"][j] = 1.0 / r["L"]
        table["halfL"][j] = 0.5 * r["L"]
    counts = np.bincount([r["cs"] for r in recs], minlength=slat.nc)
    class_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return table, class_start


def _pack_offset(o) -> int:
    """A 3-D offset in {-1, 0, 1}^3 as the r^2-cotangent kernel unpacks
    it: bytes ox + 1, oy + 1, oz + 1."""
    return sum((int(v) + 1) << (8 * a) for a, v in enumerate(o))


def beam_table(slat) -> np.ndarray:
    """[n_e, 4] int32, per template edge: the row of its side A in
    ``side_table``, class A, and the 3-D offsets of endpoints A and B from
    the beam's anchor (its r^2 position), packed (``_pack_offset``).  Side
    A reads r^2 at its point minus oa, side B at its point minus ob
    (``edge_sides``' dr3)."""
    recs = edge_sides(slat, slat.grid[1] + 2, slat.grid[2] + 2)
    order = sorted(range(len(recs)), key=lambda i: recs[i]["cs"])
    row = {i: j for j, i in enumerate(order)}
    out = np.zeros((len(slat.edges), 4), np.int32)
    for e in range(len(slat.edges)):
        a, b = recs[2 * e], recs[2 * e + 1]
        out[e] = (row[2 * e], a["cs"],
                  _pack_offset([-v for v in a["dr3"]]),
                  _pack_offset([-v for v in b["dr3"]]))
    return out


# ------------------------------------------------------------ slab plan
# B1, B3 and B4 run one block per slab: a run of consecutive points of
# one padded x-plane in its flat (y, z) order, every class, one thread per
# (class, point) (csrc/stencil_body.cuh, "slabs").  The plan is made
# here, on the host; the kernels take it as it is and refuse a plan
# outside their limits.
SLAB_HALO = 1                   # csrc's SLAB_HALO: the ghost padding
# csrc's SLAB_THREADS: the most threads of a block, and the rule's block
# (Octet: runs of 32 points, the fastest or within 5% of it for every
# kernel at 50^3 on an H100, PERF.md)
SLAB_THREADS = 128


def stencil_reach(slat) -> Tuple[int, int, int]:
    """The stencil's reach per axis (x, y, z): the largest |shift| of any
    edge side's other endpoint (``du3``) or r^2 anchor (``dr3``)."""
    recs = edge_sides(slat, slat.grid[1] + 2, slat.grid[2] + 2)
    return tuple(max(max(abs(r["du3"][a]), abs(r["dr3"][a])) for r in recs)
                 for a in range(3))


def slab_plan(nc: int, reach) -> Dict:
    """The slab kernels' plan for a template of ``nc`` classes whose sides
    reach ``reach`` points per axis: runs of the largest power of two of
    points with nc * run <= SLAB_THREADS, one thread per (class, point).
    A side reads at most SLAB_HALO points away, the ghost padding.  Raises
    ValueError for a template that reaches farther or has more classes
    than a block holds threads."""
    reach = tuple(int(r) for r in reach)
    if any(r > SLAB_HALO for r in reach):
        raise ValueError(f"slab plan: the stencil reaches {reach} points "
                         f"per axis, beyond the ghost padding of "
                         f"{SLAB_HALO} the kernels read within")
    if not 1 <= nc <= SLAB_THREADS:
        raise ValueError(f"slab plan: {nc} classes; a slab block holds one "
                         f"thread per class and point, at most "
                         f"{SLAB_THREADS}")
    run = 1
    while nc * 2 * run <= SLAB_THREADS:
        run *= 2
    return {"run": run, "threads": nc * run, "halo": (SLAB_HALO,) * 3,
            "reach": reach}


# The r^2-cotangent runs one thread per beam (csrc/stencil_matvec.cu): a
# block takes a run of BEAM_RUN consecutive points of one padded plane
# for SLAB_THREADS // BEAM_RUN template edges, one warp per edge: the
# edge's record is one address per warp and every load of a warp is
# contiguous.  The class rule of the slabs would give Octet's 24 edges
# runs of 4 points.
BEAM_RUN = 32                   # csrc's BEAM_RUN: compiled in


def beam_plan(n_e: int, reach) -> Dict:
    """The r^2-cotangent kernel's plan for a template of ``n_e`` edges
    whose sides reach ``reach`` points per axis: runs of BEAM_RUN points,
    ``edges`` edges a block, ``groups`` blocks over the edges of each run.
    The kernel skips a beam with no interior endpoint without reading it,
    which keeps every read inside the padded grid only while a side reads
    at most SLAB_HALO points away: raises ValueError for a template that
    reaches farther, or has no edge."""
    if any(int(r) > SLAB_HALO for r in reach):
        raise ValueError(f"beam plan: the stencil reaches {tuple(reach)} "
                         f"points per axis, beyond the ghost padding of "
                         f"{SLAB_HALO}")
    if n_e < 1:
        raise ValueError(f"beam plan: {n_e} edges")
    edges = SLAB_THREADS // BEAM_RUN
    return {"run": BEAM_RUN, "edges": edges, "threads": SLAB_THREADS,
            "groups": -(-n_e // edges), "halo": (SLAB_HALO,) * 3}


class LatticeSlab:
    """A lattice's template on a slab of its grid: every attribute of the
    lattice but ``grid``, which is the slab's.  A ``StencilMatvec``,
    ``DenseForm`` or ``FusedSmoother`` built on it indexes the slab's own
    ghost-padded planes (its side table's offsets follow the slab's padded
    grid), so a kernel runs on the slab unchanged."""

    def __init__(self, slat, grid):
        self.lattice = slat
        self.grid = tuple(int(g) for g in grid)

    def __getattr__(self, name):
        return getattr(self.lattice, name)


class _B1(torch.autograd.Function):
    """B1 with its VJP (the JAX kernel's ``custom_vjp``): u-cotangent
    K g by the same kernel (plain version on the CPU), r^2-cotangent by
    the closed form ``plain_vjp_r2``."""

    @staticmethod
    def forward(ctx, u, r2p, mv):
        ctx.mv = mv
        ctx.save_for_backward(u, r2p)
        return mv.apply_nograd(u, r2p)

    @staticmethod
    def backward(ctx, g):
        u, r2p = ctx.saved_tensors
        mv = ctx.mv
        g = g.contiguous()
        gu = mv.apply_nograd(g, r2p) if ctx.needs_input_grad[0] else None
        gr = mv.vjp_r2(g, u, r2p) if ctx.needs_input_grad[1] else None
        return gu, gr, None


class StencilMatvec:
    """apply(u [nc, 6, X, Y, Z], r2p [n_e, Xp, Yp, Zp]) -> K.u."""

    name = "stencil_matvec_f32"
    name_f64 = "stencil_matvec_f64"
    name_vjp = "stencil_vjp_r2"
    source = "pylatticedso_tpu_torch/csrc/stencil_matvec.cu"
    replaces = "pylatticedso_tpu/parallel/stencil_pallas.py:530"
    replaces_vjp = "pylatticedso_tpu/parallel/stencil_pallas.py:575"
    name_lo = "stencil_matvec_bf16"
    replaces_lo = "pylatticedso_tpu/parallel/stencil_pallas.py:546"
    name_w = "stencil_matvec_warped_f32"
    name_w_f64 = "stencil_matvec_warped_f64"
    name_vjp_w = "stencil_vjp_r2_warped"
    # no Pallas counterpart: where JAX declines its Pallas matvec for a
    # warped lattice and runs the XLA gather form
    replaces_w = "pylatticedso_tpu/parallel/stencil_pallas.py:88"

    def __init__(self, slat, plain_padded: Callable,
                 plain_vjp_padded: Callable,
                 geo: Optional[torch.Tensor] = None,
                 plain: Optional[Callable] = None):
        # the plain versions read a ghost-padded u, as the kernels do:
        # zero ghosts on one device, the neighbours' planes on a slab
        self.plain_padded = plain_padded
        self.plain_vjp_padded = plain_vjp_padded
        self.plain = plain if plain is not None \
            else (lambda u, r2p: plain_padded(F.pad(u, PAD), r2p))
        self.dtype = slat.dtype
        # the warped lattice's geometry field [n_e, 10, Xp, Yp, Zp], or None
        self.geo = geo
        self.warped = geo is not None
        self._geo_as: Dict[tuple, torch.Tensor] = {}
        self.launches = 0
        self.launches_f64 = 0
        self.launches_vjp = 0
        self.launches_lo = 0
        self.launches_warped = 0
        self.launches_warped_f64 = 0
        self.launches_vjp_warped = 0
        self.grid = tuple(slat.grid)
        self.nc = slat.nc
        self.n_e = len(slat.edges)
        G_mod = slat.E_mod / (2.0 * (1.0 + slat.nu))
        self.consts = (float(slat.E_mod), float(slat.kappa * G_mod),
                       float(2.0 * G_mod))
        self._tables = {torch.float32: side_table(slat, SIDE_DTYPE),
                        torch.float64: side_table(slat, SIDE_DTYPE_F64)}
        self._beams = beam_table(slat)
        self.reach = stencil_reach(slat)
        # the slab plans (per kernel, storage dtype and device where the
        # card was asked), for launches and reports
        self.slab_plans: Dict[tuple, Dict] = {}
        self._dev: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._static_args: Dict[tuple, tuple] = {}
        padded = tuple(g + 2 for g in self.grid)
        self._ushape = torch.Size((self.nc, 6) + padded)
        self._r2shape = torch.Size((self.n_e,) + padded)
        self._names = {torch.float32: self.name_w,
                       torch.float64: self.name_w_f64} if self.warped \
            else {torch.float32: self.name, torch.float64: self.name_f64,
                  torch.bfloat16: self.name_lo}

    @property
    def n_sides(self) -> int:
        return len(self._tables[torch.float32][0])

    def _geo_rows(self) -> int:
        """Padded per-edge rows of geometry a launch reads: 10 (frame and
        length) on a warped lattice, none otherwise."""
        return 10 * self.n_e if self.warped else 0

    def work(self, itemsize: int = 4) -> Tuple[int, int]:
        """(bytes, operations) one application needs: padded u and r^2
        (and on a warped lattice the geometry field) read once, the output
        written once, ``itemsize`` bytes each (4 for B1 in float32, 8 in
        float64, 2 for B2)."""
        X, Y, Z = self.grid
        Fp = (X + 2) * (Y + 2) * (Z + 2)
        N = X * Y * Z
        nbytes = itemsize * ((self.nc * 6 + self.n_e + self._geo_rows()) * Fp
                             + self.nc * 6 * N)
        return nbytes, FLOPS_PER_SIDE * self.n_sides * N

    def __call__(self, u: torch.Tensor, r2p: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and (u.requires_grad or r2p.requires_grad):
            return _B1.apply(u, r2p, self)
        return self.apply_nograd(u, r2p)

    def apply_nograd(self, u: torch.Tensor, r2p: torch.Tensor):
        """K.u with no autograd graph: the plain version on a CPU tensor,
        B1 on a CUDA tensor."""
        if not u.is_cuda and u.device.type == "cpu":
            with torch.no_grad():
                return self.plain(u, r2p)
        return self.launch(F.pad(u, PAD).contiguous(), r2p)

    def vjp_work(self, itemsize: int = 4) -> Tuple[int, int]:
        """(bytes, operations) of one r^2-cotangent launch: padded u, g
        and r^2 (and on a warped lattice the geometry field) read once,
        the r^2-cotangent written once; the strains and the derivative row
        of every side (counted as one stencil pass)."""
        X, Y, Z = self.grid
        Fp = (X + 2) * (Y + 2) * (Z + 2)
        nbytes = itemsize * (2 * self.nc * 6 + 2 * self.n_e
                             + self._geo_rows()) * Fp
        return nbytes, FLOPS_PER_SIDE * self.n_sides * X * Y * Z

    def plain_vjp_r2(self, g: torch.Tensor, u: torch.Tensor,
                     r2p: torch.Tensor) -> torch.Tensor:
        """The r^2-cotangent's plain version on an unpadded u."""
        return self.plain_vjp_padded(g, F.pad(u, PAD), r2p)

    def apply_padded(self, up: torch.Tensor,
                     r2p: torch.Tensor) -> torch.Tensor:
        """K.u of an already ghost-padded u, whose ghost layers may hold a
        neighbour slab's planes (the halo): B1 (B1w on a warped lattice, B2
        on bfloat16 u and r^2) on a CUDA tensor, the plain version on a CPU
        tensor (for bfloat16 on the widened inputs, rounded back)."""
        if up.device.type == "cpu":
            with torch.no_grad():
                if up.dtype == torch.bfloat16:
                    return self.plain_padded(
                        up.to(self.dtype),
                        r2p.to(self.dtype)).to(torch.bfloat16)
                return self.plain_padded(up, r2p)
        return self.launch(up.contiguous(), r2p)

    def vjp_r2_padded(self, g: torch.Tensor, up: torch.Tensor,
                      r2p: torch.Tensor) -> torch.Tensor:
        """The r^2-cotangent of sum(g * K(r2p) u) for an already
        ghost-padded u (a slab with its halo) and an unpadded g: the
        kernel on a CUDA tensor, its plain version on a CPU tensor.  Each
        beam's terms come from its endpoints inside the slab, so over the
        slabs of a field each term is counted once."""
        if up.device.type == "cpu":
            with torch.no_grad():
                return self.plain_vjp_padded(g, up, r2p)
        return self.launch_vjp(up.contiguous(), F.pad(g, PAD).contiguous(),
                               r2p)

    def vjp_r2(self, g: torch.Tensor, u: torch.Tensor,
               r2p: torch.Tensor) -> torch.Tensor:
        """r^2-cotangent of sum(g * K(r2p) u): ``plain_vjp_r2`` on a CPU
        tensor, the kernel ``stencil_vjp_r2`` on a CUDA tensor."""
        if u.device.type == "cpu":
            with torch.no_grad():
                return self.plain_vjp_r2(g, u, r2p)
        return self.launch_vjp(F.pad(u, PAD).contiguous(),
                               F.pad(g, PAD).contiguous(), r2p)

    def geometry(self, io: torch.dtype, device: torch.device) -> tuple:
        """The warped kernels' geometry argument: the field in ``io`` on
        ``device``, converted once and kept (an empty tuple on an
        unwarped lattice, whose kernels take no geometry)."""
        if not self.warped:
            return ()
        key = (io, device)
        g = self._geo_as.get(key)
        if g is None:
            g = self.geo.to(device=device, dtype=io).contiguous()
            self._geo_as[key] = g
        return (g.data_ptr(),)

    def launch_vjp(self, up: torch.Tensor, gp: torch.Tensor,
                   r2p: torch.Tensor) -> torch.Tensor:
        """Run the r^2-cotangent kernel on ghost-padded u and g [nc, 6, Xp,
        Yp, Zp] (float32 or float64, like r^2)."""
        X, Y, Z = self.grid
        padded = (X + 2, Y + 2, Z + 2)
        io = up.dtype
        if up.device.type != "cuda" or {gp.device, r2p.device} != {up.device}:
            raise ValueError("the r^2-cotangent kernel needs u, g and r^2 "
                             "on one CUDA device")
        if io not in (torch.float32, torch.float64) \
                or gp.dtype != io or r2p.dtype != io:
            raise ValueError(f"the r^2-cotangent kernel takes float32 or "
                             f"float64 u, g and r^2 of one type (got "
                             f"{up.dtype}, {gp.dtype}, {r2p.dtype})")
        if tuple(up.shape) != (self.nc, 6) + padded \
                or tuple(gp.shape) != (self.nc, 6) + padded \
                or tuple(r2p.shape) != (self.n_e,) + padded:
            raise ValueError(f"r^2-cotangent shapes: u {tuple(up.shape)}, g "
                             f"{tuple(gp.shape)}, r^2 {tuple(r2p.shape)} "
                             f"for grid {self.grid}")
        if not (up.is_contiguous() and gp.is_contiguous()
                and r2p.is_contiguous()):
            raise ValueError("the r^2-cotangent kernel needs contiguous "
                             "inputs")
        f64 = io == torch.float64
        name = (self.name_vjp_w if self.warped else self.name_vjp) \
            + ("_f64" if f64 else "_f32")
        dev = up.get_device()
        out = torch.empty_like(r2p)
        rc = launch.functions("stencil_matvec")[name](
            up.data_ptr(), gp.data_ptr(), r2p.data_ptr(),
            *self.geometry(io, up.device), out.data_ptr(),
            *self._static(dev, io, True), launch.stream(dev))
        launch.check(name, rc)
        if self.warped:
            self.launches_vjp_warped += 1
        else:
            self.launches_vjp += 1
        return out

    def prepare_lo(self, r2p: torch.Tensor) -> torch.Tensor:
        """bf16 copy of the padded r^2 fields, B2's second operand."""
        return r2p.to(torch.bfloat16)

    def lo(self, u_lo: torch.Tensor, r2_lo: torch.Tensor) -> torch.Tensor:
        """bf16-I/O K.u: bf16 u [nc, 6, X, Y, Z] and r^2 in, bf16 out, with
        the arithmetic in float32."""
        if u_lo.dtype != torch.bfloat16 or r2_lo.dtype != torch.bfloat16:
            raise ValueError(f"B2 takes bfloat16 u and r^2 (got {u_lo.dtype},"
                             f" {r2_lo.dtype})")
        if not u_lo.is_cuda and u_lo.device.type == "cpu":
            return self.plain_lo(u_lo, r2_lo)
        return self.launch(F.pad(u_lo, PAD), r2_lo)

    def plain_lo(self, u_lo: torch.Tensor, r2_lo: torch.Tensor):
        """B2's plain version: the gather form on the widened bf16 inputs,
        the result rounded to bf16."""
        return self.plain(u_lo.to(self.dtype),
                          r2_lo.to(self.dtype)).to(torch.bfloat16)

    def tables(self, device, dtype=torch.float32):
        """(sides, class_start) on ``device`` for the float32 (B1, B2,
        B3-B5, the r^2-cotangent) or float64 (B1's double instance and
        its r^2-cotangent) kernels, uploaded once: each record's du is the
        offset of its other endpoint's first row from the output point
        (co * 6 * Fp + du) and dr the offset of its r^2 from the point's
        own r^2 position (ei * Fp + dr), as every kernel reads them."""
        key = (device, dtype)
        if key not in self._dev:
            table, class_start = self._tables[dtype]
            X, Y, Z = self.grid
            Fp = (X + 2) * (Y + 2) * (Z + 2)
            table = table.copy()
            table["du"] += table["co"] * 6 * Fp
            table["dr"] += table["ei"] * Fp
            sides = torch.from_numpy(table.view(np.uint8).copy())
            self._dev[key] = (sides.to(device),
                              torch.from_numpy(class_start).to(device))
        return self._dev[key]

    def beams(self, device) -> torch.Tensor:
        """The beam table (``beam_table``) on ``device``, uploaded once."""
        key = (device, "beams")
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(
                self._beams.reshape(-1)).to(device)
        return self._dev[key]

    def slab_plan(self, io: torch.dtype, device: Optional[int] = None,
                  kernel: str = "B1",
                  occupancy: Optional[Callable[[Dict], int]] = None) -> Dict:
        """The slab plan (``slab_plan``) of this template for storage
        ``io``.  On a card (``device``) the plan is asked of the card once
        (plans are cached): ``occupancy(plan)`` (B1's own query by default)
        gives the blocks one SM holds, kept as ``blocks_per_sm``, and a
        plan the card cannot run raises."""
        key = (kernel, io, device)
        plan = self.slab_plans.get(key)
        if plan is not None:
            return plan
        self._check_32bit()
        plan = slab_plan(self.nc, self.reach)
        if device is not None:
            if occupancy is None:
                codes = {torch.float32: 3, torch.float64: 4} \
                    if self.warped else {torch.float32: 0,
                                         torch.bfloat16: 1,
                                         torch.float64: 2}
                dtype = codes[io]
                occupancy = lambda p: launch.functions("stencil_matvec")[
                    "stencil_matvec_occupancy"](dtype, p["threads"])
            n = occupancy(plan)
            if n < 0:
                raise RuntimeError(f"{kernel} occupancy query failed: "
                                   f"cudaError {-n}")
            if n == 0:
                raise ValueError(f"{kernel}: the card cannot run a block of "
                                 f"plan {plan}")
            plan = dict(plan, blocks_per_sm=n)
        self.slab_plans[key] = plan
        return plan

    def _check_32bit(self) -> None:
        X, Y, Z = self.grid
        if max(self.nc * 6, self.n_e, self._geo_rows()) \
                * (X + 2) * (Y + 2) * (Z + 2) >= 1 << 31:
            raise ValueError(f"the stencil kernels index in 32 bits: grid "
                             f"{self.grid} x {self.nc * 6} rows is too "
                             f"large")


    def beam_plan(self, io: torch.dtype,
                  device: Optional[int] = None) -> Dict:
        """The r^2-cotangent kernel's plan (``beam_plan``) for storage
        ``io`` (float32 or float64); on a card (``device``) its blocks per
        SM come from the kernel's own query, and a plan the card cannot
        run raises.  Cached with the slab plans."""
        key = ("r2", io, device)
        plan = self.slab_plans.get(key)
        if plan is not None:
            return plan
        self._check_32bit()
        plan = beam_plan(self.n_e, self.reach)
        if device is not None:
            codes = {torch.float32: 3, torch.float64: 4} if self.warped \
                else {torch.float32: 0, torch.float64: 2}
            n = launch.functions("stencil_matvec")[
                "stencil_vjp_r2_occupancy"](codes[io])
            if n < 0:
                raise RuntimeError(f"r^2-cotangent occupancy query failed: "
                                   f"cudaError {-n}")
            if n == 0:
                raise ValueError(f"r^2-cotangent: the card cannot run a "
                                 f"block of plan {plan}")
            plan = dict(plan, blocks_per_sm=n)
        self.slab_plans[key] = plan
        return plan

    def _static(self, index: int, io: torch.dtype, vjp: bool) -> tuple:
        """The launch arguments that never change on device ``index`` for
        storage ``io``: the side table (``tables``) with class_start and
        the slab plan's run (B1), or with the beam table (the
        r^2-cotangent, its plan asked of the card), the count (classes, or
        edges), grid and constants."""
        key = (index, io, vjp)
        args = self._static_args.get(key)
        if args is None:
            dev = torch.device("cuda", index)
            dt = torch.float64 if io == torch.float64 else torch.float32
            table, class_start = self.tables(dev, dt)
            if vjp:
                p = self.beam_plan(io, index)
                args = (table.data_ptr(), self.beams(dev).data_ptr(),
                        self.n_e, *self.grid, *self.consts)
            else:
                p = self.slab_plan(io, index)
                args = (table.data_ptr(), class_start.data_ptr(), p["run"],
                        self.nc, *self.grid, *self.consts)
            self._static_args[key] = args
        return args

    def launch(self, up: torch.Tensor, r2p: torch.Tensor) -> torch.Tensor:
        """Run B1 (float32 or float64 u and r^2; B1w on a warped lattice)
        or B2 (bfloat16 u and r^2) on an already ghost-padded u [nc, 6,
        Xp, Yp, Zp]."""
        X, Y, Z = self.grid
        if not up.is_cuda or r2p.get_device() != up.get_device():
            raise ValueError(f"B1/B2 need u and r^2 on one CUDA device, got "
                             f"{up.device} and {r2p.device}")
        io = up.dtype
        name = self._names.get(io)
        if name is None or r2p.dtype is not io:
            raise ValueError(
                f"B1/B2 on CUDA take float32, float64 or bfloat16 (B1w on a "
                f"warped lattice: float32 or float64) u and r^2 of one type "
                f"(got {up.dtype}, {r2p.dtype})")
        if up.shape != self._ushape or r2p.shape != self._r2shape:
            raise ValueError(f"B1/B2 shapes: u {tuple(up.shape)}, r^2 "
                             f"{tuple(r2p.shape)} for grid {self.grid}")
        if not (up.is_contiguous() and r2p.is_contiguous()):
            raise ValueError("B1/B2 need contiguous u and r^2")
        lo = io is torch.bfloat16
        dev = up.get_device()
        out = torch.empty((self.nc, 6, X, Y, Z), dtype=io, device=up.device)
        rc = launch.functions("stencil_matvec")[name](
            up.data_ptr(), r2p.data_ptr(), *self.geometry(io, up.device),
            out.data_ptr(), *self._static(dev, io, False),
            launch.stream(dev))
        launch.check(name, rc)
        if self.warped:
            if io == torch.float64:
                self.launches_warped_f64 += 1
            else:
                self.launches_warped += 1
        elif lo:
            self.launches_lo += 1
        elif io == torch.float64:
            self.launches_f64 += 1
        else:
            self.launches += 1
        return out
