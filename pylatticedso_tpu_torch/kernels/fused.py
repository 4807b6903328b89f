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
fits, in global scratch elsewhere.  B5c gives each item a group of G lanes
of one warp, which compute its sides' rows apart (``b5c_lanes``,
``b5c_side_order``), reads d as bf16 pairs and stages the dense records.
The result is the same bits whatever the cluster size, layout or G.

**B3's and B4's launch.**  B3 and B4 run on B1's slab plan (``b3_plan``,
``b4_plan``: runs of a padded plane's flat points, one thread per (class,
point)), over every padded plane, ghosts included.  Every kernel reads the
level's one side table, with the grid's offsets (``StencilMatvec.tables``).

**bf16 compute.**  ``PLDSO_MG_FUSED_COMPUTE=bf16`` selects each kernel's
bf16-compute instance, B3c, B4c and B5c (the JAX kernels built with
``make_stencil_acc(T, ct=jnp.bfloat16)``, ``stencil_pallas.py:724-729,
:761-766, :812-817``), read at every call as JAX reads it when it builds a
kernel.  As in JAX, only a level whose matvec takes the dense form has
them (``dense_form``: the compute-once choice of the tile search); there
the variable means f32 compute.  Their K x is the dense form
(``DenseForm``: JAX's packed coefficient columns, ``_pack_dense_coefs``,
rounded to bf16, summed in bf16 term by term in JAX's order), widened to
float32 for the same pointwise update.

On a CPU tensor every wrapper runs its plain torch version (the gather
form of ``parallel/structured.py`` for K, or ``DenseForm.plain`` under bf16
compute, then the same pointwise update with the same rounding points); on
a CUDA tensor it launches its kernel (through ``kernels/launch.py``) or
raises.  ``launches`` counts each kernel's launches (the bf16-compute
instances under their own keys), ``b5_launches`` B5's by cluster size.
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

__all__ = ["FusedSmoother", "route", "has_kernel_matvec", "dense_form",
           "cheb_static", "storage_dtype", "KERNELS", "b5_plan", "b5_items",
           "b5_partition", "b5c_groups", "b5c_lanes", "b5c_side_order",
           "B5_CLUSTERS", "B5C_GROUPS", "DenseForm", "pack_dense_coefs",
           "DENSE_DTYPE"]

PAD = (1, 1, 1, 1, 1, 1)
SOURCE = "pylatticedso_tpu_torch/csrc/mg_fused.cu"
# (kernel name, what it replaces), by the wrapper method that launches it
# and, for the bf16-compute instances, that method's name + "_bf16c"
KERNELS = {
    "residual": ("mg_residual",
                 "pylatticedso_tpu/parallel/stencil_pallas.py:723"),
    "cheb_run": ("mg_cheb_run",
                 "pylatticedso_tpu/parallel/stencil_pallas.py:757"),
    "cheb_full": ("mg_cheb_full",
                  "pylatticedso_tpu/parallel/stencil_pallas.py:809"),
    "residual_bf16c": ("mg_residual_bf16c",
                       "pylatticedso_tpu/parallel/stencil_pallas.py:724"),
    "cheb_run_bf16c": ("mg_cheb_run_bf16c",
                       "pylatticedso_tpu/parallel/stencil_pallas.py:761"),
    "cheb_full_bf16c": ("mg_cheb_full_bf16c",
                        "pylatticedso_tpu/parallel/stencil_pallas.py:812"),
}
COMPUTE = ("f32", "bf16")


def storage_dtype() -> torch.dtype:
    """The fused smoother's storage dtype, from ``PLDSO_MG_FUSED_DTYPE``
    (``bf16``, the default, or anything else for float32 — the JAX
    package's reading of the same variable)."""
    bf16 = os.environ.get("PLDSO_MG_FUSED_DTYPE", "bf16") == "bf16"
    return torch.bfloat16 if bf16 else torch.float32


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


def dense_form(slat, tile: int = 3072) -> bool:
    """JAX's ``dense`` flag of a level (``stencil_pallas.py:287``): its
    matvec takes the compute-once form, which implies the dense form, at
    the tile the search picks.  Only a dense level has the bf16-compute
    instances; elsewhere JAX's ``make_stencil_acc`` computes in f32
    (:318-319)."""
    if not has_kernel_matvec(slat, tile):
        return False
    return _tile_search(slat, tile)[1]


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


# --------------------------------------------------------- the dense form
def pack_dense_coefs(recs, E_mod, G_mod, kappa):
    """Constant (8, NCOLS) coefficient table for the dense kernel form.

    A copy of ``stencil_pallas._pack_dense_coefs`` (framework-free): every
    (6,) matrix column of the per-record E = A2 @ [d; p3] and rows =
    B_side @ S contractions is packed column-wise into one table (column j
    = table[:6, j]); all-zero columns are skipped at pack time.  Columns
    0/1 hold the stiffness monomial coefficients K = r2*colA + r2^2*colB.
    Annotates each record with its ``dense_a`` / ``dense_b`` column index
    lists.
    """
    cols = []

    def add(col):
        if all(c == 0.0 for c in col):
            return None
        cols.append([float(c) for c in col] + [0.0, 0.0])
        return len(cols) - 1

    add([np.pi * E_mod, np.pi * kappa * G_mod, np.pi * kappa * G_mod,
         0.0, 0.0, 0.0])                                    # idx 0
    add([0.0, 0.0, 0.0, np.pi / 2.0 * G_mod,
         np.pi / 4.0 * E_mod, np.pi / 4.0 * E_mod])          # idx 1
    for r in recs:
        t, a1, a2, L = r["t"], r["a1"], r["a2"], r["L"]
        invL = 1.0 / L
        a_cols = []
        for k in range(3):
            j = add([t[k] * invL, a1[k] * invL, a2[k] * invL,
                     0.0, 0.0, 0.0])
            if j is not None:
                a_cols.append(("d", k, j))
        for k in range(3):
            j = add([0.0, 0.0, 0.0, t[k] * invL, a1[k] * invL,
                     a2[k] * invL])
            if j is not None:
                a_cols.append(("d", 3 + k, j))
        for k in range(3):
            j = add([0.0, -0.5 * a2[k], 0.5 * a1[k], 0.0, 0.0, 0.0])
            if j is not None:
                a_cols.append(("p", k, j))
        sgn = -1.0 if r["side"] == 0 else 1.0
        half_L = 0.5 * L
        b_defs = [
            (0, [sgn * t[0], sgn * t[1], sgn * t[2], 0.0, 0.0, 0.0]),
            (1, [sgn * a1[0], sgn * a1[1], sgn * a1[2],
                 -half_L * a2[0], -half_L * a2[1], -half_L * a2[2]]),
            (2, [sgn * a2[0], sgn * a2[1], sgn * a2[2],
                 half_L * a1[0], half_L * a1[1], half_L * a1[2]]),
            (3, [0.0, 0.0, 0.0, sgn * t[0], sgn * t[1], sgn * t[2]]),
            (4, [0.0, 0.0, 0.0, sgn * a1[0], sgn * a1[1], sgn * a1[2]]),
            (5, [0.0, 0.0, 0.0, sgn * a2[0], sgn * a2[1], sgn * a2[2]]),
        ]
        b_cols = []
        for srow, col in b_defs:
            j = add(col)
            if j is not None:
                b_cols.append((srow, j))
        r["dense_a"], r["dense_b"] = a_cols, b_cols
    table = np.zeros((8, max(len(cols), 1)), dtype=np.float32)
    for j, col in enumerate(cols):
        table[:, j] = col
    return table


# E's term slots (d0..d5, then p0..p2) and the row's (Sd0..Sd5): csrc's
# DENSE_A, DENSE_B; a record's columns are K's two, then E's, then the
# row's, each six bf16 rows (csrc/stencil_body.cuh ``DenseSide``)
DENSE_A, DENSE_B = 9, 6
DENSE_COLS = 2 + DENSE_A + DENSE_B
DENSE_DTYPE = np.dtype([("col", "<u2", (DENSE_COLS, 6)),
                        ("tail", "<u2", (2,))])
assert DENSE_DTYPE.itemsize == 208


def _slot(src: str, k: int) -> int:
    return k if src == "d" else 6 + k


class DenseForm:
    """The dense form of one template's K.u in bf16 arithmetic: JAX's
    ``make_stencil_acc`` dense branch with ``ct=jnp.bfloat16``
    (``stencil_pallas.py:338-377``), the K.x of B3c, B4c and B5c.

    ``pack_dense_coefs`` gives the float32 table and each side's ordered
    term lists; the columns are rounded to bf16 from that float32 table, as
    JAX's ``coef_col`` casts it.  ``table`` holds one ``DENSE_DTYPE``
    record per side in the kernels' side order (``side_table``'s: stably by
    self class): the bf16 bits of K's two columns and of every term's
    column in its slot, zeros in a slot without a term (the kernels sum it
    as a zero column, which leaves acc's bits as they are after the first
    term, slot 0, which every side has: ``csrc/stencil_body.cuh``).
    ``plain`` is the plain version: it skips a slot without a term, as
    JAX does."""

    def __init__(self, slat):
        X, Y, Z = slat.grid
        self.grid = (X, Y, Z)
        self.nc = slat.nc
        recs = edge_sides(slat, Y + 2, Z + 2)
        G_mod = slat.E_mod / (2.0 * (1.0 + slat.nu))
        coefs = pack_dense_coefs(recs, slat.E_mod, G_mod, slat.kappa)
        cols = torch.from_numpy(np.ascontiguousarray(coefs[:6].T)).to(
            torch.bfloat16)                           # [ncols, 6]
        bits = cols.view(torch.int16).numpy().view(np.uint16)
        S = len(recs)
        self.recs = recs
        self.n_terms = [(len(r["dense_a"]), len(r["dense_b"])) for r in recs]
        # per side (record order): each slot's column, and which slots
        # have a term and which is the first
        slot_cols = torch.zeros((S, DENSE_COLS, 6), dtype=torch.bfloat16)
        present = torch.zeros((S, DENSE_COLS), dtype=torch.bool)
        first = torch.zeros((S, DENSE_COLS), dtype=torch.bool)
        records = np.zeros(S, DENSE_DTYPE)
        for i, r in enumerate(recs):
            terms = ([(2 + _slot(src, k), j) for src, k, j in r["dense_a"]],
                     [(2 + DENSE_A + srow, j) for srow, j in r["dense_b"]])
            for group, q0 in zip(terms, (2, 2 + DENSE_A)):
                slots = [q for q, _ in group]
                # the kernels sum every slot, absent ones as zero columns,
                # which leaves the bits as they are only after the first
                # term: slot 0 (the frame's x components) must have one
                if not group or slots[0] != q0 or slots != sorted(set(slots)):
                    raise ValueError(
                        "dense form: a side's terms must be in slot order "
                        "and start at slot 0 (an orthonormal frame's x "
                        "components)")
                first[i, slots[0]] = True
                for q, j in group:
                    slot_cols[i, q] = cols[j]
                    present[i, q] = True
                    records["col"][i, q] = bits[j]
            for q in (0, 1):
                slot_cols[i, q] = cols[q]
                records["col"][i, q] = bits[q]
        order = sorted(range(S), key=lambda i: recs[i]["cs"])
        self.table = records[order]
        self.table_order = order      # record of each side-table position
        # the plain version's gathers: per side, the flat index in the
        # padded fields of its self values, its other endpoint's and its
        # r^2 at every interior point
        Yp, Zp = Y + 2, Z + 2
        Fp = (X + 2) * Yp * Zp
        q = ((np.arange(1, X + 1)[:, None, None] * Yp
              + np.arange(1, Y + 1)[None, :, None]) * Zp
             + np.arange(1, Z + 1)[None, None, :])
        rows = np.arange(6)[None, :, None, None, None] * Fp
        col = lambda a: np.asarray(a)[:, None, None, None, None]
        cs = col([r["cs"] for r in recs])
        self.first, self.present = first.numpy(), present.numpy()
        self._cpu = {
            "cols": slot_cols, "present": present, "first": first,
            "side_b": torch.tensor([r["side"] == 1 for r in recs]),
            "uS": torch.from_numpy(cs * 6 * Fp + rows + q),
            "uO": torch.from_numpy(col([r["co"] * 6 * Fp + r["du"]
                                        for r in recs]) + rows + q),
            "r2": torch.from_numpy(col([r["ei"] * Fp + r["dr"]
                                        for r in recs])[:, 0] + q)}
        # per class, its sides in record order (the order JAX adds them),
        # padded with the index of a zero row
        per = [[i for i, r in enumerate(recs) if r["cs"] == c]
               for c in range(self.nc)]
        width = max(len(p) for p in per)
        self._cpu["order"] = torch.tensor(
            [p + [S] * (width - len(p)) for p in per])
        self._on: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def ops_per_point(self) -> int:
        """bf16 operations of one application per interior point, in the
        compute-once form (each template edge's d, p3, K, E and Sd once,
        its two sides' rows and acc adds each): 28 + 12 a + 12 (bA + bB)
        an edge for a terms of E and b of a row."""
        out = 0
        for e in range(len(self.n_terms) // 2):
            (na, nb_a), (_, nb_b) = self.n_terms[2 * e],                 self.n_terms[2 * e + 1]
            out += 28 + 12 * na + 12 * (nb_a + nb_b)
        return out

    def _dev(self, device) -> Dict[str, torch.Tensor]:
        got = self._on.get(device)
        if got is None:
            got = self._on[device] = {k: v.to(device)
                                      for k, v in self._cpu.items()}
        return got

    def plain(self, up: torch.Tensor, r2p: torch.Tensor) -> torch.Tensor:
        """K u in the dense form on bf16 ghost-padded u [nc, 6, Xp, Yp,
        Zp] and r^2 [n_e, Xp, Yp, Zp]: bf16 [nc, 6, X, Y, Z], every product
        and sum rounded to bf16 on its own, in JAX's order: each side's
        row (``rows``), and per class the rows added one by one in record
        order (a class with fewer sides adds exact zeros, which leave a
        bf16 sum as it is)."""
        X, Y, Z = self.grid
        rows = self.rows(up, r2p)
        t = self._dev(up.device)
        rows = torch.cat([rows, torch.zeros_like(rows[:1])])[t["order"]]
        acc = torch.zeros((self.nc, 6, X, Y, Z), dtype=torch.bfloat16,
                          device=up.device)
        for k in range(rows.shape[1]):
            acc = acc + rows[:, k]
        return acc

    def rows(self, up: torch.Tensor, r2p: torch.Tensor) -> torch.Tensor:
        """Every side's dense-form row at every interior point, bf16 [S,
        6, X, Y, Z] in record order, from bf16 ghost-padded u and r^2.
        Batched over the sides: each side's elements see one torch op for
        each JAX op; a slot without a term is passed over by
        ``torch.where``."""
        if up.dtype != torch.bfloat16 or r2p.dtype != torch.bfloat16:
            raise ValueError("the dense form takes bf16 u and r^2")
        t = self._dev(up.device)
        S = len(self.recs)
        flat, flat_r2 = up.reshape(-1), r2p.reshape(-1)
        uS, uO, r2 = flat[t["uS"]], flat[t["uO"]], flat_r2[t["r2"]]
        side_b = t["side_b"].view(S, 1, 1, 1, 1)
        uA = torch.where(side_b, uO, uS)
        uB = torch.where(side_b, uS, uO)
        col = lambda q: t["cols"][:, q].view(S, 6, 1, 1, 1)
        K = r2[:, None] * col(0) + (r2 * r2)[:, None] * col(1)
        d = uB - uA
        p3 = uA[:, 3:] + uB[:, 3:]
        src = torch.cat([d, p3], dim=1)                 # slots d0..d5, p0..p2

        def col_accum(vals, q0, n):
            out = torch.zeros_like(K)
            for s in range(n):
                q = q0 + s
                first, present = self.first[:, q], self.present[:, q]
                if not present.any():
                    continue
                term = vals[:, s:s + 1] * col(q)
                if first.all():                 # every side starts here
                    out = term
                    continue
                put = out + term
                if first.any():
                    put = torch.where(t["first"][:, q].view(S, 1, 1, 1, 1),
                                      term, put)
                out = put if present.all() else torch.where(
                    t["present"][:, q].view(S, 1, 1, 1, 1), put, out)
            return out

        E = col_accum(src, 2, DENSE_A)
        Sd = K * E
        return col_accum(Sd, 2 + DENSE_A, DENSE_B)


# ------------------------------------------------------------ B5's plan
# B5 runs one thread-block cluster per launch (csrc/mg_fused.cu).  The
# plan is made here, on the host: the cluster size, the partition of the
# level's interior items over its blocks and threads, and where d and r^2
# live.  The kernel takes it as it is.  The layouts of d: a full copy in
# every block's shared memory, each block's updates broadcast into all of
# them, or global scratch.
B5_LAYOUTS = {"bcast": 0, "global": 1}          # csrc's B5_BCAST, B5_GLOBAL
# the layout of d on a level whose d fits a block's shared memory
B5_SMEM_LAYOUT = "bcast"
B5_CLUSTERS = (1, 2, 4, 8, 16)  # 16 needs the non-portable cluster size
# the rule: the smallest cluster that leaves <= 256 items to a block (one
# item a thread); on an H100 it picks the fastest measured cluster at 7^3
# (8), 4^3 (2), 2^3 (1) and the hybrid check case (4)
B5_ITEMS_PER_BLOCK = 256
B5_MAX_THREADS = 256            # csrc's B5_MAX_THREADS
B5_MAX_IPT = 4                  # item slots per thread (B5c: per group)
B5_Q_BITS = 22                  # csrc's B5_Q_BITS: (class << 22) | point
B5_SMEM_LIMIT = 227 * 1024      # csrc's MAX_SMEM: one block's dynamic, sm_90
B5_MAX_DEGREE = 64              # csrc's MAX_DEGREE (Chebyshev coefficients)
# B5c (the bf16-compute instance): G lanes of one warp per item (the
# group; 32 // G groups a warp), blocks of up to 1,024 threads.  The rule:
# the smallest cluster that leaves <= B5C_ITEMS_PER_BLOCK items to a block
# (at most 16); G by the items a block holds (B5C_GROUP_RULE: more than 32
# items, 4 lanes; more than 8, 6; else 12); d broadcast into every block
# where a block holds <= B5C_BCAST_ITEMS items, else in global scratch.
# On an H100 (smoke._b5_sweep, every cluster, layout and G, two runs) it
# picks the fastest or within 2% of it on the shapes the V-cycle launches:
# 7^3 degree 2 (16 blocks, G 4, global), 4^3 degree 2 (16, 6, bcast), the
# coarsest level's 2^3 degree 24 (16, 12, bcast), and the hybrid check
# case (16, 4, global)
B5C_GROUPS = (1, 2, 3, 4, 6, 12)        # csrc's B5C_MAX_GROUP is the last
B5C_MAX_THREADS = 1024                  # csrc's B5C_MAX_THREADS
B5C_ITEMS_PER_BLOCK = 8
B5C_GROUP_RULE = ((32, 4), (8, 6), (0, 12))
B5C_BCAST_ITEMS = 32


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def b5_smem_bytes(layout: str, nc: int, Fp: int, n_sides: int, n_e: int,
                  r2_smem: bool, itemsize: int, compute: str = "f32",
                  per_block: int = 0, threads: int = 0,
                  kmax: int = 0) -> int:
    """Dynamic shared memory of one B5 (B5c under bf16 ``compute``) block,
    as the kernel carves it up (the one place its size is decided; the
    launch passes it).  B5: the sides table, class_start, d in float
    (layout ``bcast``) and r^2 in the storage type.  B5c: the sides table,
    class_start, the sides' dense records, d as bf16 pairs (layout
    ``bcast``), the block's ``per_block`` items' x, r, d and fd in float,
    each of its ``threads`` threads' ``kmax`` rows (3 words each), and
    r^2."""
    n = _align16(n_sides * SIDE_DTYPE.itemsize) + _align16(4 * (nc + 1))
    if compute == "bf16":
        n += _align16(n_sides * DENSE_DTYPE.itemsize)
        if layout == "bcast":
            n += _align16(4 * nc * 3 * Fp)
        n += _align16(8 * 4 * 3 * per_block)
        n += _align16(4 * 3 * kmax * threads)
    elif layout == "bcast":
        n += _align16(4 * nc * 6 * Fp)
    if r2_smem:
        n += _align16(itemsize * n_e * Fp)
    return n


def b5_plan(nc: int, grid, n_e: int, n_sides: int, itemsize: int,
            cluster: Optional[int] = None,
            layout: Optional[str] = None, compute: str = "f32",
            group: Optional[int] = None,
            max_sides: Optional[int] = None) -> Dict:
    """B5's (B5c's under bf16 ``compute``) launch plan for a level:
    ``cluster`` blocks (by default the rule: the smallest power of two
    that leaves at most ``B5_ITEMS_PER_BLOCK`` interior items to a block,
    ``B5C_ITEMS_PER_BLOCK`` for B5c), ``per_block`` contiguous items per
    block; B5: ``threads`` threads of ``ipt`` item slots each; B5c: groups
    of ``group`` lanes (default ``B5C_GROUP_RULE``), ``32 // group`` groups a
    warp, ``ipt`` item slots a group, in whole warps, each lane computing
    ``kmax`` rows (``max_sides``, the most sides of a class, over G); d in
    shared memory (``B5_SMEM_LAYOUT``) where it fits one block (for B5c,
    and the block holds at most ``B5C_BCAST_ITEMS`` items), else in global
    scratch (``layout`` forces one); r^2 staged in shared memory where it
    fits after d.  Raises ValueError for a plan the kernel cannot run."""
    X, Y, Z = grid
    Fp = (X + 2) * (Y + 2) * (Z + 2)
    n_items = nc * X * Y * Z
    bf16c = compute == "bf16"
    if Fp >= 1 << B5_Q_BITS:
        raise ValueError(f"B5: {Fp} padded points per class exceed the "
                         f"item encoding (2^{B5_Q_BITS})")
    if cluster is None:
        most = B5C_ITEMS_PER_BLOCK if bf16c else B5_ITEMS_PER_BLOCK
        cluster = 1
        while cluster < B5_CLUSTERS[-1] and -(-n_items // cluster) > most:
            cluster *= 2
    if cluster not in B5_CLUSTERS or cluster > n_items:
        raise ValueError(f"B5: cluster {cluster} for {n_items} items")
    per_block = -(-n_items // cluster)
    if bf16c:
        if group is None:
            group = next(g for most, g in B5C_GROUP_RULE if per_block > most)
        if group not in B5C_GROUPS:
            raise ValueError(f"B5c: group {group} not in {B5C_GROUPS}")
        if max_sides is None:
            raise ValueError("B5c: the plan needs max_sides")
        kmax = -(-max_sides // group)
        gpw = 32 // group
        for ipt in range(1, B5_MAX_IPT + 1):
            groups = -(-per_block // ipt)
            threads = 32 * -(-groups // gpw)
            if threads <= B5C_MAX_THREADS:
                break
        else:
            raise ValueError(
                f"B5c: {n_items} interior items do not fit a cluster of "
                f"{cluster} blocks of {B5C_MAX_THREADS} threads in groups "
                f"of {group} x {B5_MAX_IPT}")
    else:
        group, kmax = 1, 0
        threads = min(B5_MAX_THREADS, -(-per_block // 32) * 32)
        ipt = -(-per_block // threads)
        if ipt > B5_MAX_IPT:
            raise ValueError(
                f"B5: {n_items} interior items do not fit a cluster of "
                f"{cluster} blocks of {B5_MAX_THREADS} threads x "
                f"{B5_MAX_IPT}")
    size = lambda lay, r2s: b5_smem_bytes(lay, nc, Fp, n_sides, n_e, r2s,
                                          itemsize, compute, per_block,
                                          threads, kmax)
    if layout is None:
        fits = size(B5_SMEM_LAYOUT, False) <= B5_SMEM_LIMIT
        if bf16c:
            fits = fits and per_block <= B5C_BCAST_ITEMS
        layout = B5_SMEM_LAYOUT if fits else "global"
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
            "compute": compute, "group": group, "kmax": kmax,
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
    the kernel's order: B5, thread t's slot j holds block start + t + j *
    threads; B5c, the slot j of the group g (lanes g's of its warp) holds
    block start + g + j * groups, groups = warps * (32 // group)."""
    out = []
    n = plan["threads"] if plan["compute"] == "f32" else b5c_groups(plan)
    for blk in range(plan["cluster"]):
        i0 = blk * plan["per_block"]
        i1 = min(i0 + plan["per_block"], plan["n_items"])
        t = np.arange(n)
        idx = np.concatenate([i0 + t + j * n for j in range(plan["ipt"])])
        out.append(idx[idx < i1])
    return out


def b5c_groups(plan: Dict) -> int:
    """B5c: the item groups of one block (whole warps of 32 // group
    groups)."""
    return plan["threads"] // 32 * (32 // plan["group"])


def b5c_lanes(plan: Dict) -> np.ndarray:
    """B5c: per thread of a block, (group, lane in the group), group -1
    for the lanes past a warp's last whole group (they own no item)."""
    t = np.arange(plan["threads"])
    G = plan["group"]
    gpw = 32 // G
    lane = t % 32
    gi, j = lane // G, lane % G
    g = np.where(gi < gpw, (t // 32) * gpw + gi, -1)
    return np.stack([g, j], axis=1)


def b5c_side_order(group: int, s_begin: int, s_end: int, kmax: int):
    """B5c: the sides of one class as the kernel visits them: (side, lane
    that computes its row, step k of that lane) in the order the group
    adds the rows (k = 0 .. kmax - 1, then lanes 0 .. group - 1)."""
    out = []
    for k in range(kmax):
        for g in range(group):
            s = s_begin + k * group + g
            if s < s_end:
                out.append((s, g, k))
    return out


class FusedSmoother:
    """B3, B4 and B5 for one lattice (one multigrid level), and their
    bf16-compute instances B3c, B4c and B5c where the level is ``dense``.

    ``stencil`` is the level's B1 wrapper: its edge-side table, material
    constants and plain gather form serve these kernels too.  Every
    wrapper and plain version takes ``compute`` ("f32" or "bf16"; None:
    ``PLDSO_MG_FUSED_COMPUTE`` as the call is made, ``compute_type``).
    """

    source = SOURCE

    def __init__(self, slat, stencil: StencilMatvec, level=None):
        # the routing is the whole level's (``level``, on a slab of it:
        # ``slat`` is then its ``LatticeSlab``)
        self.ok, self.single_ok = route(level if level is not None else slat)
        self.dense = dense_form(level if level is not None else slat)
        self.dense_form = DenseForm(slat)
        self.mv = stencil
        self.grid = tuple(slat.grid)
        self.nc = slat.nc
        self.n_e = len(slat.edges)
        # the most sides of one class (B5c's rows per lane follow it)
        self.max_sides = int(np.max(np.bincount(
            [r["cs"] for r in self.dense_form.recs], minlength=self.nc)))
        self.launches: Dict[str, int] = {k: 0 for k in KERNELS}
        # B5's plan, launches by cluster size and by shape (compute,
        # degree, with x0), for the reports
        self.b5_plans: Dict[tuple, Dict] = {}
        self.b5_launches: Dict[int, int] = {}
        self.b5_shapes: Dict[Tuple[str, int, bool], int] = {}
        self._dev: Dict[tuple, object] = {}     # per-device launch args
        self._coefs: Dict[tuple, tuple] = {}    # (frac, degree) -> c1, c2
        padded = tuple(g + 2 for g in self.grid)
        self._shapes = (torch.Size((self.nc, 6) + padded),
                        torch.Size((self.n_e,) + padded))

    # ------------------------------------------------------------ helpers
    @property
    def padded(self) -> Tuple[int, int, int]:
        return tuple(g + 2 for g in self.grid)

    def compute_type(self, compute: Optional[str] = None) -> str:
        """The arithmetic of a launch: ``compute``, or by default "bf16"
        where ``PLDSO_MG_FUSED_COMPUTE=bf16`` and the level is dense (the
        JAX rule, :318-319), else "f32".  An explicit "bf16" on a level
        that is not dense raises."""
        if compute is None:
            return "bf16" if self.dense and os.environ.get(
                "PLDSO_MG_FUSED_COMPUTE") == "bf16" else "f32"
        if compute not in COMPUTE:
            raise ValueError(f"compute {compute!r}: one of {COMPUTE}")
        if compute == "bf16" and not self.dense:
            raise ValueError(f"grid {self.grid}: bf16 compute needs the "
                             f"dense form, which this level's JAX matvec "
                             f"does not take")
        return compute

    @staticmethod
    def counter(method: str, compute: str) -> str:
        """The ``launches`` key of a wrapper method under ``compute``."""
        return method if compute == "f32" else f"{method}_bf16c"

    def sc(self, lmax: torch.Tensor, frac: float) -> torch.Tensor:
        """[inv_theta, inv_delta] of the spectrum [frac lmax, lmax], as a
        float32 device tensor (the kernels read it; no host sync)."""
        lmax = lmax.to(torch.float32)
        inv_theta = 2.0 / ((1.0 + frac) * lmax)
        inv_delta = 2.0 / ((1.0 - frac) * lmax)
        return torch.stack([inv_theta, inv_delta])

    def work(self, kernel: str, itemsize: int, final: bool = False,
             degree: int = 0, with_x0: bool = False,
             compute: str = "f32") -> Tuple[int, int]:
        """(bytes, operations) of one launch: each input read once and each
        output written once (padded fields, ``itemsize`` bytes), and 110
        operations per edge side per interior point for each stencil
        application plus the pointwise update's operations per DOF.  Under
        bf16 compute the operations are bf16 ones, to be taken at the bf16
        rate: the dense form's (``DenseForm.ops_per_point``) and the float
        update's counted twice (a float operation takes the time of two
        bf16 ones at the non-tensor rates)."""
        X, Y, Z = self.grid
        Fp = (X + 2) * (Y + 2) * (Z + 2)
        N = X * Y * Z
        R = self.nc * 6
        if compute == "bf16":
            stencil, upd = self.dense_form.ops_per_point() * N, 2
        else:
            stencil, upd = FLOPS_PER_SIDE * self.mv.n_sides * N, 1
        if kernel == "residual":       # x, b, fm, r^2 -> out
            return (itemsize * (4 * R * Fp + self.n_e * Fp),
                    stencil + upd * 2 * R * N)
        if kernel == "cheb_run":       # x, r, d, fd, r^2 -> 1 or 3 outputs
            n_out = 1 if final else 3
            return (itemsize * ((4 + n_out) * R * Fp + self.n_e * Fp),
                    stencil + upd * (6 + int(final)) * R * N)
        # cheb_full: b, [x0], fd, r^2 -> out; degree (+1) stencils
        n_in = 3 if with_x0 else 2
        return (itemsize * ((n_in + 1) * R * Fp + self.n_e * Fp),
                (degree + int(with_x0)) * stencil
                + upd * (6 * degree + 3) * R * N)

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
        the side table, class_start, the sides' dense records, grid and
        material constants."""
        key = ("stencil", index)
        args = self._dev.get(key)
        if args is None:
            dev = torch.device("cuda", index)
            sides, class_start = self.mv.tables(dev)
            dense = torch.from_numpy(
                self.dense_form.table.view(np.uint8).copy()).to(dev)
            self._dev[("dense", index)] = dense
            args = (sides.data_ptr(), class_start.data_ptr(),
                    dense.data_ptr(), self.nc, *self.grid, *self.mv.consts)
            self._dev[key] = args
        return args

    def _static_slab(self, index: int, io: torch.dtype, compute: str,
                     final: Optional[bool] = None) -> tuple:
        """The launch arguments of B3 (``final`` None) or B4 that never
        change on device ``index``: B5's, with the slab plan's run after
        the dense records."""
        key = ("B3" if final is None else "B4", index, io, compute, final)
        args = self._dev.get(key)
        if args is None:
            plan = self.b3_plan(io, index, compute) if final is None \
                else self.b4_plan(io, final, index, compute)
            sides, class_start, dense, *rest = self._static(index)
            args = self._dev[key] = (sides, class_start, dense, plan["run"],
                                     *rest)
        return args

    # ------------------------------------------------------- plain versions
    # K is the gather form (self.mv.plain_padded) on a ghost-padded field
    # widened to its own dtype, or under bf16 compute the dense form on it
    # rounded to bf16, widened back; its ghosts are read as the kernels
    # read them (zeros on one device, a neighbour slab's planes on a
    # slab); outputs are padded back with zero ghosts, as the kernels write
    def _w(self, v: torch.Tensor) -> torch.Tensor:
        return _unpad(v).to(self.mv.dtype)

    def _K(self, vp: torch.Tensor, r2: torch.Tensor, compute: str):
        wd = self.mv.dtype
        if compute == "bf16":
            bf = torch.bfloat16
            return self.dense_form.plain(vp.to(bf), r2.to(bf)).to(wd)
        return self.mv.plain_padded(vp.to(wd), r2.to(wd))

    def plain_residual(self, b, x, fm, r2, compute: Optional[str] = None):
        io = b.dtype
        ct = self.compute_type(compute)
        out = self._w(fm) * (self._w(b) - self._K(x, r2, ct))
        return F.pad(out, PAD).to(io)

    def plain_cheb_run(self, x, r, d, fd, sc, r2, c1, c2, final,
                       compute: Optional[str] = None):
        io = x.dtype
        wd = self.mv.dtype
        dc = self._w(d)
        kd = self._K(d, r2, self.compute_type(compute))
        x1 = self._w(x) + dc
        r1 = self._w(r) - kd
        d1 = c1 * dc + ((c2 * sc[1].to(wd)) * r1) * self._w(fd)
        if final:
            return F.pad(x1 + d1, PAD).to(io)
        return tuple(F.pad(v, PAD).to(io) for v in (x1, r1, d1))

    def plain_cheb_full(self, b, x0, fd, sc, r2, frac, degree,
                        compute: Optional[str] = None):
        io = b.dtype
        wd = self.mv.dtype
        ct = self.compute_type(compute)
        bw, fdw = self._w(b), self._w(fd)
        inv_theta, inv_delta = sc[0].to(wd), sc[1].to(wd)
        if x0 is not None:
            x = self._w(x0)
            r = bw - self._K(F.pad(x, PAD), r2, ct)
        else:
            x = torch.zeros_like(bw)
            r = bw
        d = (r * fdw) * inv_theta
        for c1, c2 in cheb_static(frac, degree):
            kd = self._K(F.pad(d, PAD), r2, ct)
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

    def residual(self, b, x, fm, r2, compute: Optional[str] = None):
        """B3 (B3c under bf16 compute): fm (b - K x), rounded to the
        storage dtype."""
        ct = self.compute_type(compute)
        if not b.is_cuda:
            self._cpu_only(b)
            return self.plain_residual(b, x, fm, r2, ct)
        io = self._check("B3", (b, x, fm), None, r2)
        out = torch.empty_like(b)
        dev = b.get_device()
        rc = launch.functions("mg_fused")["mg_residual"](
            int(io == torch.bfloat16), int(ct == "bf16"), x.data_ptr(),
            b.data_ptr(), fm.data_ptr(), r2.data_ptr(), out.data_ptr(),
            *self._static_slab(dev, io, ct), launch.stream(dev))
        launch.check("mg_residual", rc)
        self.launches[self.counter("residual", ct)] += 1
        return out

    def b3_plan(self, io: torch.dtype, device: Optional[int] = None,
                compute: str = "f32") -> Dict:
        """B3's (B3c's) slab plan on this level (``StencilMatvec.
        slab_plan`` over the padded planes); on a card its blocks per SM
        come from the instance's own query."""
        dtype, cb = int(io == torch.bfloat16), int(compute == "bf16")
        occ = lambda p: launch.functions("mg_fused")["mg_residual_occupancy"](
            dtype, cb, p["threads"])
        return self.mv.slab_plan(io, device, kernel="B3c" if cb else "B3",
                                 occupancy=occ)

    def b4_plan(self, io: torch.dtype, final: bool,
                device: Optional[int] = None, compute: str = "f32") -> Dict:
        """B4's (B4c's) slab plan on this level (``StencilMatvec.slab_plan``
        over the padded planes); on a card its blocks per SM come from the
        instance's own query (each variant's registers differ)."""
        dtype, cb = int(io == torch.bfloat16), int(compute == "bf16")
        occ = lambda p: launch.functions("mg_fused")["mg_cheb_run_occupancy"](
            dtype, cb, int(final), p["threads"])
        return self.mv.slab_plan(
            io, device, kernel=f"B4{'c' if cb else ''}"
            f"{' final' if final else ''}", occupancy=occ)

    def cheb_run(self, x, r, d, fd, sc, r2, c1: float, c2: float,
                 final: bool, compute: Optional[str] = None):
        """B4 (B4c under bf16 compute): one Chebyshev step; (x1, r1, d1),
        or x1 + d1 when ``final``."""
        ct = self.compute_type(compute)
        if not x.is_cuda:
            self._cpu_only(x)
            return self.plain_cheb_run(x, r, d, fd, sc, r2, c1, c2, final,
                                       ct)
        io = self._check("B4", (x, r, d, fd), sc, r2)
        x1 = torch.empty_like(x)
        r1 = d1 = None
        if not final:
            r1, d1 = torch.empty_like(x), torch.empty_like(x)
        dev = x.get_device()
        rc = launch.functions("mg_fused")["mg_cheb_run"](
            int(io == torch.bfloat16), int(ct == "bf16"), int(final),
            x.data_ptr(), r.data_ptr(), d.data_ptr(), fd.data_ptr(),
            sc.data_ptr(), r2.data_ptr(), x1.data_ptr(),
            None if final else r1.data_ptr(),
            None if final else d1.data_ptr(), c1, c2,
            *self._static_slab(dev, io, ct, final),
            launch.stream(dev))
        launch.check("mg_cheb_run", rc)
        self.launches[self.counter("cheb_run", ct)] += 1
        return x1 if final else (x1, r1, d1)

    def b5_plan(self, io: torch.dtype, with_x0: bool = False,
                cluster: Optional[int] = None, layout: Optional[str] = None,
                device: Optional[int] = None,
                compute: str = "f32",
                group: Optional[int] = None) -> Dict:
        """B5's (B5c's) plan on this level (``b5_plan``) for storage
        ``io``.  On a card (``device``) the plan is asked of the card once,
        for the instance that will run, before its first launch there
        (plans are cached), and raises if the card cannot hold one such
        cluster."""
        key = (io, with_x0, cluster, layout, device, compute, group)
        plan = self.b5_plans.get(key)
        if plan is not None:
            return plan
        itemsize = torch.finfo(io).bits // 8
        plan = b5_plan(self.nc, self.grid, self.n_e, self.mv.n_sides,
                       itemsize, cluster, layout, compute, group,
                       self.max_sides)
        if device is not None:
            fits = launch.functions("mg_fused")["mg_cheb_full_max_clusters"](
                int(io == torch.bfloat16), int(compute == "bf16"),
                int(with_x0),
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
                  layout: Optional[str] = None,
                  compute: Optional[str] = None,
                  group: Optional[int] = None):
        """B5 (B5c under bf16 compute): the whole smoother (x0 residual
        when ``x0`` is given, ``degree`` steps, x + d) in one launch, on a
        single-program level only.  ``cluster``, ``layout`` and B5c's
        ``group`` override the plan's (the card tests and
        ``chip_smoke.py`` run every one; the result is the same bits
        whatever they are)."""
        if not self.single_ok:
            raise ValueError(
                f"B5 runs only on levels the routing marks single (grid "
                f"{self.grid} is not): use B3 + B4")
        ct = self.compute_type(compute)
        if not b.is_cuda:
            self._cpu_only(b)
            return self.plain_cheb_full(b, x0, fd, sc, r2, frac, degree, ct)
        vecs = (b, fd) if x0 is None else (b, fd, x0)
        io = self._check("B5", vecs, sc, r2)
        if not 0 <= degree <= B5_MAX_DEGREE:
            raise ValueError(f"B5 degree {degree} out of range")
        dev = b.get_device()
        plan = self.b5_plan(io, x0 is not None, cluster, layout, dev, ct,
                            group)
        items = self._b5_items(dev)
        c1, c2 = self._b5_coefs(frac, degree)
        dg = None
        if plan["layout"] == "global":
            # d in float (B5), or as bf16 pairs in 32-bit words (B5c)
            dg = torch.empty(b.numel() // (2 if ct == "bf16" else 1),
                             dtype=torch.float32, device=b.device)
        out = torch.empty_like(b)
        rc = launch.functions("mg_fused")["mg_cheb_full"](
            int(io == torch.bfloat16), int(ct == "bf16"), int(x0 is not None),
            B5_LAYOUTS[plan["layout"]], b.data_ptr(),
            None if x0 is None else x0.data_ptr(), fd.data_ptr(),
            sc.data_ptr(), r2.data_ptr(), out.data_ptr(),
            None if dg is None else dg.data_ptr(), items, c1, c2,
            degree, plan["cluster"], plan["threads"], plan["ipt"],
            plan["per_block"], plan["n_items"], plan["n_sides"], self.n_e,
            int(plan["r2_smem"]), plan["group"], plan["kmax"],
            plan["smem_bytes"], *self._static(dev), launch.stream(dev))
        launch.check("mg_cheb_full", rc)
        self.launches[self.counter("cheb_full", ct)] += 1
        self.b5_launches[plan["cluster"]] = \
            self.b5_launches.get(plan["cluster"], 0) + 1
        shape = (ct, degree, x0 is not None)
        self.b5_shapes[shape] = self.b5_shapes.get(shape, 0) + 1
        return out

