"""Geometric multigrid preconditioner for the structured stencil operator
(PyTorch).

Mirrors ``pylatticedso_tpu.parallel.multigrid``: a hierarchy of coarse
lattices with 2x cells and 2x radii, per-class trilinear transfers with
restriction as the exact transpose of prolongation, and a Chebyshev
smoother with Jacobi scaling whose lmax comes from a fixed-length power
iteration.  Three V-cycles, selected by the JAX package's switches with the
same names and defaults:

* unfused, working dtype: every smoother matvec is B1 (the stencil kernel);
* ``lo_smoother`` (``PLDSO_MG_BF16=1``): unfused, the smoother matvecs of
  every level that has a bf16 operand are B2, the bf16-I/O stencil kernel
  (f32 vectors outside it); the JAX rule gives a level that operand only
  where it builds its Pallas matvec (``kernels.fused.has_kernel_matvec``),
  and every other level — every level of a float64 hierarchy — smooths
  with B1 at full precision, as JAX smooths there with its gather form;
* ``fused`` (``mg_opts["fused"]`` or ``PLDSO_MG_FUSED=1``/``force``): the
  fused V-cycle of kernels B3 (residual), B4 (one Chebyshev step) and B5
  (a whole smoother in one launch), with smoother vectors stored in
  ``PLDSO_MG_FUSED_DTYPE`` (bf16 by default, or f32) between launches;
  under ``PLDSO_MG_FUSED_COMPUTE=bf16`` their bf16-compute instances B3c,
  B4c and B5c on every level whose matvec takes the dense form (the JAX
  rule; each wrapper reads the variable as it is called).

Where the JAX package warns and falls back to the unfused V-cycle, the port
raises: a fused request it cannot meet never runs another path.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.fused import cheb_static, has_kernel_matvec, storage_dtype
from .mesh import OPS, Sharded, scatter

__all__ = ["build_mg_hierarchy", "mg_precond_state", "mg_apply",
           "mg_preconditioner", "make_transfers", "make_radius_restrictor"]

PAD = (1, 1, 1, 1, 1, 1)        # one ghost cell on every side of X, Y, Z


def _unpad(v: torch.Tensor) -> torch.Tensor:
    return v[..., 1:-1, 1:-1, 1:-1]


# ---------------------------------------------------------------- transfers
@contextlib.contextmanager
def _full_precision_matmul():
    """TF32 off and bf16 products reduced in float32 (as XLA's are) for
    the block, the caller's settings restored after it: the flags are
    process-wide, so the transfers never leave them changed."""
    m = torch.backends.cuda.matmul
    old = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = old


def _interp_matrix(X: int, C: int, frac: float) -> np.ndarray:
    """[X, C] 1-D linear interpolation matrix coarse->fine (factor 2),
    offset-aware: a class with fractional template coordinate ``frac`` has
    its fine node p at (p + frac) h and its coarse node i at (2i + 2 frac) h,
    so the fine sample interpolates the coarse field at t = (p - frac) / 2.
    Out-of-hull samples extrapolate linearly."""
    P = np.zeros((X, C))
    if C == 1:
        P[:, 0] = 1.0
        return P
    pos = (np.arange(X) - frac) / 2.0
    i0 = np.clip(np.floor(pos).astype(int), 0, C - 2)
    w1 = pos - i0
    P[np.arange(X), i0] += 1.0 - w1
    P[np.arange(X), i0 + 1] += w1
    return P


def make_transfers(fine_grid: Tuple[int, int, int],
                   coarse_grid: Tuple[int, int, int],
                   class_keys: np.ndarray, dtype=torch.float64,
                   device="cuda"):
    """(prolong, restrict) for [nc, 6, X, Y, Z] class fields.

    Three per-axis batched contractions with stacked per-class [X, C]
    interpolation matrices.  ``restrict`` is the same chain transposed
    (axes in reverse order, each matrix transposed), so
    <prolong(c), f> == <c, restrict(f)> up to rounding — the symmetry of
    the V-cycle depends on it.  The contractions run in full precision:
    TF32 is switched off for them, and bf16 transfers (fused V-cycle)
    accumulate in float32, as XLA's do; both flags are set around each
    contraction only (``_full_precision_matmul``).
    """
    keys = np.asarray(class_keys, dtype=float)
    nc = len(keys)
    Ps = []
    for a in range(3):
        P = np.stack([_interp_matrix(fine_grid[a], coarse_grid[a],
                                     float(keys[ci][a])) for ci in range(nc)])
        Ps.append(torch.as_tensor(P, dtype=dtype, device=device))

    by_dtype = {Ps[0].dtype: Ps}

    def _mats(x):
        if x.dtype not in by_dtype:
            by_dtype[x.dtype] = [P.to(x.dtype) for P in Ps]
        return by_dtype[x.dtype]

    def prolong(c):
        P0, P1, P2 = _mats(c)
        with _full_precision_matmul():
            f = torch.einsum("cdqyz,cxq->cdxyz", c, P0)
            f = torch.einsum("cdxqz,cyq->cdxyz", f, P1)
            return torch.einsum("cdxyq,czq->cdxyz", f, P2)

    def restrict(f):
        P0, P1, P2 = _mats(f)
        with _full_precision_matmul():
            c = torch.einsum("cdxyz,czq->cdxyq", f, P2)
            c = torch.einsum("cdxyq,cyp->cdxpq", c, P1)
            return torch.einsum("cdxpq,cxo->cdopq", c, P0)

    return prolong, restrict


def _coarsen_cells(n: Tuple[int, int, int]) -> Tuple[int, int, int]:
    return tuple(max(1, -(-ni // 2)) for ni in n)


def _coarse_cell_valid(valid: np.ndarray) -> np.ndarray:
    nx, ny, nz = valid.shape
    cx, cy, cz = _coarsen_cells((nx, ny, nz))
    pad = np.zeros((2 * cx, 2 * cy, 2 * cz), dtype=bool)
    pad[:nx, :ny, :nz] = valid
    return (pad.reshape(cx, 2, cy, 2, cz, 2).sum(axis=(1, 3, 5)) > 0)


def make_radius_restrictor(valid: np.ndarray, dtype=torch.float64,
                           device="cuda"):
    """Coarse per-cell radii: validity-weighted 2x2x2 mean, doubled (keeps
    r/L, hence relative density and homogenized moduli, across levels)."""
    nx, ny, nz = valid.shape
    cx, cy, cz = _coarsen_cells((nx, ny, nz))
    w = np.zeros((2 * cx, 2 * cy, 2 * cz))
    w[:nx, :ny, :nz] = valid.astype(float)
    cnt = w.reshape(cx, 2, cy, 2, cz, 2).sum(axis=(1, 3, 5))
    cnt = np.maximum(cnt, 1.0)
    w_t = torch.as_tensor(w, dtype=dtype, device=device)
    cnt_t = torch.as_tensor(cnt, dtype=dtype, device=device)

    def _restrict3(r):
        p = torch.zeros((2 * cx, 2 * cy, 2 * cz), dtype=r.dtype,
                        device=r.device)
        p[:nx, :ny, :nz] = r
        p = p * w_t.to(r.dtype)
        s = p.reshape(cx, 2, cy, 2, cz, 2).sum(dim=(1, 3, 5))
        return 2.0 * s / cnt_t.to(r.dtype)

    def restrict_radius(r):
        # hybrid lattices carry one radius field per superposed geometry
        if r.ndim == 4:
            return torch.stack([_restrict3(rg) for rg in r])
        return _restrict3(r)

    return restrict_radius


# ---------------------------------------------------------------- hierarchy
class MGLevel:
    def __init__(self, slat, free_field: np.ndarray):
        self.slat = slat
        self.matvec, self.diag_fn = slat.make_matvec()
        fm = np.asarray(free_field)
        if fm.ndim == 4:
            fm = np.broadcast_to(fm[:, None], (slat.nc, 6) + slat.grid)
        self.free = torch.as_tensor(np.ascontiguousarray(fm, np.float64),
                                    dtype=slat.dtype,
                                    device=torch.device(slat.device))
        self._free_as = {slat.dtype: self.free}
        # the JAX rule: only a level with the Pallas matvec has B2
        self.has_lo = has_kernel_matvec(slat)

    @property
    def fused(self):
        """The level's fused smoother (kernels B3-B5)."""
        return self.matvec.apply.fused

    def free_as(self, dtype) -> torch.Tensor:
        """The free mask in ``dtype`` (0/1: exact in any dtype)."""
        if dtype not in self._free_as:
            self._free_as[dtype] = self.free.to(dtype)
        return self._free_as[dtype]

    def A(self, u, radius):
        f = self.free
        return f * self.matvec(f * u, radius) + (1.0 - f) * u

    def prepare(self, radius):
        """Loop-invariant matvec operands (padded r^2 fields) for a fixed
        radius."""
        return self.matvec.prepare(radius)

    def A_aux(self, u, radius, aux):
        if aux is None:
            return self.A(u, radius)
        f = self.free
        return f * self.matvec.apply(f * u, aux) + (1.0 - f) * u

    def prepare_lo(self, aux):
        """bf16 copy of the hoisted r^2 operands (B2's second operand), or
        None on a level without the bf16-I/O matvec (JAX ``prepare_lo``)."""
        if not self.has_lo:
            return None
        return self.matvec.apply.prepare_lo(aux)

    def A_aux_lo(self, u, aux_lo):
        """Smoother-grade matvec: bf16 kernel I/O (f32 arithmetic inside),
        vectors of the working dtype outside; only valid inside the
        preconditioner — the outer CG matvec stays full precision."""
        f = self.free
        out = self.matvec.apply.lo((f * u).to(torch.bfloat16),
                                   aux_lo).to(u.dtype)
        return f * out + (1.0 - f) * u

    def D(self, radius):
        f = self.free
        d = f * self.diag_fn(radius) + (1.0 - f)
        return torch.where(d == 0, torch.ones_like(d), d)


def build_mg_hierarchy(slat, free_field: np.ndarray, min_cells: int = 3,
                       max_levels: int = 10) -> dict:
    """Static multilevel structure for a StructuredLattice.

    Coarse Dirichlet/validity masks are the even-index subsample of the fine
    ones (coarse class node (i,j,k) corresponds to fine (2i,2j,2k)), ANDed
    with the coarse lattice's own node validity.
    """
    from .structured import StructuredLattice

    dev = torch.device(slat.device)
    levels: List[MGLevel] = [MGLevel(slat, free_field)]
    prolongs: List[Callable] = []
    restricts: List[Callable] = []
    rad_restrictors: List[Callable] = []

    cur, cur_free = slat, np.asarray(free_field)
    if cur_free.ndim == 4:
        cur_free = np.broadcast_to(cur_free[:, None],
                                   (slat.nc, 6) + slat.grid).copy()
    while max(cur.num_cells) > min_cells and len(levels) < max_levels:
        n_c = _coarsen_cells(cur.num_cells)
        cv_c = _coarse_cell_valid(np.asarray(cur.cell_valid))
        coarse = StructuredLattice(
            cur.geom, n_c, tuple(2.0 * np.asarray(cur.cell_size)),
            cur.E_mod, cur.nu, kappa=cur.kappa, dtype=cur.dtype,
            cell_valid=cv_c, node_transform=cur.node_transform,
            device=cur.device)
        # even-index subsample, clamped to the coarse grid extent
        cx, cy, cz = coarse.grid
        sub = cur_free[:, :, 0::2, 0::2, 0::2][:, :, :cx, :cy, :cz]
        if sub.shape[2:] != coarse.grid:
            padded = np.zeros((cur.nc, 6) + coarse.grid, dtype=bool)
            padded[:, :, :sub.shape[2], :sub.shape[3], :sub.shape[4]] = sub
            sub = padded
        free_c = sub & np.broadcast_to(coarse.node_valid[:, None], sub.shape)

        rad_restrictors.append(make_radius_restrictor(
            np.asarray(cur.cell_valid), dtype=slat.dtype, device=dev))
        p, r = make_transfers(cur.grid, coarse.grid, cur.class_keys,
                              dtype=slat.dtype, device=dev)
        prolongs.append(p)
        restricts.append(r)
        levels.append(MGLevel(coarse, free_c))
        cur, cur_free = coarse, free_c

    return {"levels": levels, "prolong": prolongs, "restrict": restricts,
            "restrict_radius": rad_restrictors}


# ------------------------------------------------------------- smoothing
def _estimate_lmax(A: Callable, D: torch.Tensor, shape, dtype,
                   iters: int = 10) -> torch.Tensor:
    """lmax(D^-1 A) via power iteration with a deterministic start.  On a
    level held in slabs (``D`` a ``parallel.mesh.Sharded``) the start is
    scattered over the slabs and the norms and dots are reduced over them
    in rank order (``parallel.mesh.OPS``); the result is then replicated."""
    n = int(np.prod(shape))
    v = 1.0 + 0.5 * torch.sin(torch.arange(n, dtype=dtype, device=D.device)
                              * 0.7)
    v = v.reshape(shape)
    if isinstance(D, Sharded):
        v = scatter(v, D.devices, D.dim)
        vnorm, vdot = OPS.vector_norm, OPS.dot
    else:
        vnorm = lambda x: torch.linalg.vector_norm(x.reshape(-1))
        vdot = lambda a, b: torch.dot(a.reshape(-1), b.reshape(-1))
    v = v / vnorm(v)
    for _ in range(iters):
        w = A(v) / D
        v = w / torch.clamp_min(vnorm(w), 1e-30)
    w = A(v) / D
    lam = vdot(v, w) / vdot(v, v)
    return 1.1 * lam


def _chebyshev(A: Callable, D: torch.Tensor, b: torch.Tensor,
               x0: Optional[torch.Tensor], lmax, lmin_frac: float,
               degree: int) -> torch.Tensor:
    """Chebyshev semi-iteration for A x = b, Jacobi-scaled, on
    [lmax * lmin_frac, lmax]: a polynomial in D^-1 A applied to D^-1 r,
    symmetric positive as an operator, hence V-cycle-safe."""
    lmin = lmax * lmin_frac
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x) if x0 is not None else b
    d = (r / D) / theta
    rho = 1.0 / sigma
    for _ in range(degree):
        x = x + d
        r = r - A(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (r / D)
        rho = rho_new
    return x + d


def _mg_apply_fused(h: dict, state: dict, nu_at: Callable,
                    coarse_degree: int, smooth_frac: float) -> Callable:
    """The fused V-cycle (``multigrid._mg_apply_fused`` of the JAX
    package): each Chebyshev step is one B4 launch, the mid-cycle residual
    one B3 launch, and a level that the routing marks single runs its whole
    smoother — the coarsest's degree-``coarse_degree`` sweep included — in
    one B5 launch.  Smoother vectors stay ghost-padded in the storage dtype
    between launches, with the JAX package's rounding points: b is rounded
    to the storage dtype on entry to each level, the first d is computed in
    f32 and rounded, and the residual field, the transfers, the free masks
    and x + corr run in the storage dtype.  The result returns in the
    caller's dtype."""
    levels: List[MGLevel] = h["levels"]
    nL = len(levels)
    fused_ops = state["fused"]
    fzs = [lvl.fused for lvl in levels]
    f32 = torch.float32
    # [inv_theta, inv_delta] per level as device tensors, built once per M:
    # no launch needs a host sync
    fracs = [1.0 / 64.0 if lvl == nL - 1 else smooth_frac
             for lvl in range(nL)]
    scs = [fz.sc(state["lmaxs"][lvl], fracs[lvl])
           for lvl, fz in enumerate(fzs)]

    def smooth(level, bp, x0p, deg):
        fz, st, sc = fzs[level], fused_ops[level], scs[level]
        frac = fracs[level]
        if fz.single_ok:
            return fz.cheb_full(bp, x0p, st["fdinv"], sc, st["r2"], frac,
                                deg)
        if x0p is None:
            x, r = torch.zeros_like(bp), bp
        else:
            x = x0p
            r = fz.residual(bp, x0p, st["fm"], st["r2"])
        d = (r.to(f32) * st["fdinv"].to(f32) * sc[0]).to(bp.dtype)
        steps = cheb_static(frac, deg)
        for k, (c1, c2) in enumerate(steps):
            final = k == len(steps) - 1
            out = fz.cheb_run(x, r, d, st["fdinv"], sc, st["r2"], c1, c2,
                              final)
            if final:
                return out
            x, r, d = out

    def vcycle(level: int, b: torch.Tensor) -> torch.Tensor:
        fz, st = fzs[level], fused_ops[level]
        io = st["fdinv"].dtype
        bp = F.pad(b.to(io), PAD)
        if level == nL - 1:
            x = smooth(level, bp, None, coarse_degree)
            return _unpad(x).to(b.dtype)
        deg = nu_at(level)
        xp = smooth(level, bp, None, deg)
        rp = fz.residual(bp, xp, st["fm"], st["r2"])
        free_c = levels[level + 1].free_as(io)
        rc = free_c * h["restrict"][level](_unpad(rp))
        ec = vcycle(level + 1, rc)
        corr = levels[level].free_as(io) * h["prolong"][level](free_c * ec)
        x2 = smooth(level, bp, xp + F.pad(corr, PAD), deg)
        return _unpad(x2).to(b.dtype)

    def M(r):
        return vcycle(0, r)

    return M


# ------------------------------------------------------------- V-cycle
def mg_precond_state(h: dict, radius_field: torch.Tensor,
                     power_iters: int = 10,
                     fused: Optional[bool] = None,
                     lmax_of: Optional[Callable] = None) -> dict:
    """Radius-derived V-cycle state: per-level radii, hoisted matvec
    operands (and their bf16 copies for B2 where the level has B2, None
    elsewhere), Jacobi diagonals and lmax
    estimates, and — when the fused V-cycle is on (``fused``, default
    ``PLDSO_MG_FUSED``) — per level the fused smoother's operands
    ``fdinv = free / D``, ``fm = free`` (ghost-padded) and r^2, in the
    storage dtype (``PLDSO_MG_FUSED_DTYPE``); None on a level whose routing
    has no fused smoother.  A descent loop whose radii move slowly can
    FREEZE it and skip the per-solve power iterations and per-level operand
    rebuilds.  ``lmax_of(level, D, aux)`` (the sharded step's) may give a
    level's lmax in place of the power iteration here, or None."""
    levels: List[MGLevel] = h["levels"]
    dt = levels[0].slat.dtype
    radii = [torch.as_tensor(radius_field, dtype=dt,
                             device=levels[0].free.device)]
    for rr in h["restrict_radius"]:
        radii.append(rr(radii[-1]))

    auxs = [lvl.prepare(rad) for lvl, rad in zip(levels, radii)]
    lmaxs = []
    for i, (lvl, rad, aux) in enumerate(zip(levels, radii, auxs)):
        D = lvl.D(rad)
        lmax = None if lmax_of is None else lmax_of(i, D, aux)
        if lmax is None:
            Af = lambda u, _l=lvl, _r=rad, _a=aux: _l.A_aux(u, _r, _a)
            lmax = _estimate_lmax(Af, D, D.shape, dt, iters=power_iters)
        lmaxs.append(lmax)
    Ds = [lvl.D(rad) for lvl, rad in zip(levels, radii)]
    auxs_lo = [lvl.prepare_lo(aux) for lvl, aux in zip(levels, auxs)]
    if fused is None:
        fused = os.environ.get("PLDSO_MG_FUSED") in ("1", "force")
    io = storage_dtype()
    fused_ops = []
    for lvl, aux, D in zip(levels, auxs, Ds):
        if not (fused and lvl.fused.ok):
            fused_ops.append(None)
            continue
        fused_ops.append({
            "fdinv": F.pad(lvl.free / D, PAD).to(io),
            "fm": F.pad(lvl.free, PAD).to(io),
            "r2": aux.to(io),
        })
    return {"radii": radii, "auxs": auxs, "Ds": Ds, "lmaxs": lmaxs,
            "auxs_lo": auxs_lo, "fused": fused_ops}


def mg_apply(h: dict, state: dict, nu=2, coarse_degree: int = 24,
             smooth_frac: float = 0.25,
             lo_smoother: Optional[bool] = None,
             fused: Optional[bool] = None) -> Callable:
    """V(nu,nu)-cycle application M(r) from a precomputed state.

    ``nu`` may be a single degree or a per-level schedule (clamped to its
    last entry for deeper levels).  The cycle stays symmetric (pre == post
    at every level), so it remains a valid SPD preconditioner for plain
    CG.  ``fused`` (default ``PLDSO_MG_FUSED`` in ``1``/``force``) runs the
    fused V-cycle and raises if the state lacks a level's fused operands;
    otherwise ``lo_smoother`` (default ``PLDSO_MG_BF16=1``) runs the
    smoother matvecs of every level whose state has bf16 operands through
    B2, and those of the other levels through B1 (the JAX rule,
    ``multigrid.py:496-499``).
    """
    if lo_smoother is None:
        lo_smoother = os.environ.get("PLDSO_MG_BF16") == "1"
    if fused is None:
        fused = os.environ.get("PLDSO_MG_FUSED", "") in ("1", "force")
    nus = ([int(v) for v in nu] if isinstance(nu, (tuple, list))
           else [int(nu)])
    nu_at = lambda lvl: nus[min(lvl, len(nus) - 1)]
    levels: List[MGLevel] = h["levels"]
    nL = len(levels)
    if fused:
        fused_ops = state.get("fused") or [None] * nL
        missing = [i for i, f in enumerate(fused_ops) if f is None]
        if missing:
            warped = [i for i in missing
                      if levels[i].slat.node_transform is not None]
            why = (f"; levels {warped} are warped (node_transform), and a "
                   "warped lattice has no fused smoother, as in the JAX "
                   "package (multigrid.py:413-416)") if warped else ""
            raise RuntimeError(
                f"fused V-cycle requested but levels {missing} have no fused "
                "operands (state built without fused=True / PLDSO_MG_FUSED, "
                "or the routing found no fused smoother there)" + why
                + "; the port does not fall back to the unfused V-cycle")
        return _mg_apply_fused(h, state, nu_at, coarse_degree, smooth_frac)
    radii, auxs, Ds, lmaxs = (state["radii"], state["auxs"], state["Ds"],
                              state["lmaxs"])
    auxs_lo = state.get("auxs_lo") or [None] * nL

    def vcycle(level: int, b: torch.Tensor) -> torch.Tensor:
        lvl, rad, D, lmax = levels[level], radii[level], Ds[level], lmaxs[level]
        if lo_smoother and auxs_lo[level] is not None:
            Af = lambda u: lvl.A_aux_lo(u, auxs_lo[level])
        else:
            Af = lambda u: lvl.A_aux(u, rad, auxs[level])
        if level == nL - 1:
            # coarsest: aggressive Chebyshev over (almost) the full spectrum
            return _chebyshev(Af, D, b, None, lmax, 1.0 / 64.0, coarse_degree)
        nu_l = nu_at(level)
        x = _chebyshev(Af, D, b, None, lmax, smooth_frac, nu_l)     # pre
        r = b - Af(x)
        rc = levels[level + 1].free * h["restrict"][level](r)
        ec = vcycle(level + 1, rc)
        x = x + lvl.free * h["prolong"][level](levels[level + 1].free * ec)
        return _chebyshev(Af, D, b, x, lmax, smooth_frac, nu_l)     # post

    def M(r):
        return vcycle(0, r)

    return M


def mg_preconditioner(h: dict, radius_field: torch.Tensor, nu=2,
                      coarse_degree: int = 24, smooth_frac: float = 0.25,
                      power_iters: int = 10) -> Callable:
    """Symmetric V(nu,nu)-cycle preconditioner M(r) for PCG, its state
    derived from ``radius_field`` once per call (JAX
    ``multigrid.mg_preconditioner``).  The radii are detached: a
    preconditioner never moves the fixed point."""
    with torch.no_grad():
        state = mg_precond_state(h, radius_field.detach(),
                                 power_iters=power_iters)
    return mg_apply(h, state, nu=nu, coarse_degree=coarse_degree,
                    smooth_frac=smooth_frac)
