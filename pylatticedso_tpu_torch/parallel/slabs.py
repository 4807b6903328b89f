"""The structured step on slabs of a mesh (PyTorch): the port of what
GSPMD makes of JAX's ``shard_structured_step`` (``structured.py:902-968``).

JAX shards the nodal fields ``[nc, 6, X, Y, Z]`` along one grid axis and
lets XLA partition the jitted step: the stencil's shifted reads become
halo exchanges and CG's dot products reductions.  Here one process drives
the shards of one mesh row (``parallel.mesh``), and the same happens by
hand:

* ``SlabLevel``: one level of the operator on the slabs.  Slab k holds its
  planes of the field (a ``Sharded``); K.u is a ``halo_exchange`` of the
  ghost-padded slabs (``SLAB_HALO = 1``, the stencil's reach) and B1 (B1w
  on a warped lattice, B2 on the lo route) on every slab, on its device,
  through ``StencilMatvec.apply_padded``: the kernel source is B1's, the
  grid the slab's.  The gather form gives each output point one owner, so
  no output is reduced.  Its r^2 operand (and a warped lattice's geometry
  rows) is sliced, halo included, from the replicated padded field.  It
  answers the V-cycle as an ``MGLevel`` does (``A_aux``, ``A_aux_lo``,
  ``free``, ``fused``), so ``multigrid.mg_apply`` runs on it unchanged.
* ``SlabFused``: B3 and B4 (B3c, B4c) per slab, with a halo exchange of
  the field they read at neighbours (x for B3, d for B4) before each
  launch; their outputs come back with zero ghosts.  B5 and B5c, the
  whole smoother in one launch, cannot exchange halos inside the launch,
  so a level the fused plan gives B5 runs gathered.
* the transfers: between two sharded levels the dense ``[X, C]`` rows of
  ``multigrid._interp_matrix`` are read across the slab boundary, each
  output slab fetching the input planes its rows reach; between the last
  sharded level and the first gathered one the field is gathered onto the
  replicated device (row 0, shard 0) and the correction scattered back.
* ``ShardedStructuredStep``: the implicit-form value and gradient of
  ``make_structured_compliance_step`` (JAX's wrapper runs
  ``step._jitted``, the implicit form) on the slabs of mesh row 0; JAX
  replicates the step over ``dp``, and computing it once gives the same
  answer.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..fem.solve import pcg
from .mesh import (OPS, Sharded, _copy, all_reduce_sum, broadcast, gather,
                   halo_exchange, scatter, slices)
from .multigrid import (_estimate_lmax, _full_precision_matmul,
                        _interp_matrix, mg_apply, mg_precond_state)

__all__ = ["SlabLevel", "SlabFused", "ShardedStructuredStep",
           "sharded_levels"]

PAD = (1, 1, 1, 1, 1, 1)


def _on(t: torch.Tensor):
    """A slab's card made current for its launch (a kernel launches on the
    current card's stream); nothing on the CPU."""
    return torch.cuda.device(t.device) if t.is_cuda \
        else contextlib.nullcontext()


def _each(fn, *parts):
    """``fn`` on every slab's parts, each on its own card."""
    out = []
    for args in zip(*parts):
        with _on(args[0]):
            out.append(fn(*args))
    return out


class SlabLevel:
    """One level of the structured operator on the slabs of a mesh row:
    ``matvec`` the level's operator (``make_matvec``), cut along grid
    ``axis`` into ``len(devices)`` slabs, slab k on ``devices[k]``;
    ``free`` the level's replicated free mask."""

    def __init__(self, matvec, slat, free: torch.Tensor, devices, axis: int):
        self.slat = slat
        self.devices = list(devices)
        self.axis = axis
        self.dim = 2 + axis             # in [nc, 6, X, Y, Z]
        self.rdim = 1 + axis            # in r^2 [n_e, Xp, Yp, Zp]
        self.replicated = free.device
        n = len(self.devices)
        self.ops = [matvec.slab(axis, n, k, d)
                    for k, d in enumerate(self.devices)]
        self.free = scatter(free, self.devices, self.dim)
        self._free_as = {free.dtype: self.free}
        self.fused = SlabFused(self)

    # ---------------------------------------------------------- layout
    def scatter(self, field: torch.Tensor) -> Sharded:
        return scatter(field, self.devices, self.dim)

    def gather(self, x: Sharded) -> torch.Tensor:
        return gather(x, self.replicated)

    def padded_r2(self, r2p: torch.Tensor) -> Sharded:
        """A replicated padded per-edge field [n_e, Xp, Yp, Zp] (r^2, its
        bf16 copy) sliced into the slabs' operands, halo included."""
        return slices(r2p, self.devices, self.rdim)

    def padded(self, fp: torch.Tensor) -> Sharded:
        """A replicated ghost-padded nodal field sliced with its halo."""
        return slices(fp, self.devices, self.dim)

    def exchange(self, u: Sharded) -> Sharded:
        """The slabs ghost-padded, their ghost planes along the axis the
        neighbours' boundary planes."""
        return halo_exchange(u.map(lambda p: F.pad(p, PAD)))

    def free_as(self, dtype) -> Sharded:
        if dtype not in self._free_as:
            self._free_as[dtype] = self.free.to(dtype)
        return self._free_as[dtype]

    # -------------------------------------------------------- operator
    def K(self, u: Sharded, aux: Sharded) -> Sharded:
        """K.u: a halo exchange, then B1 (B2 on bfloat16) on every slab."""
        up = self.exchange(u)
        return Sharded(_each(lambda p, a, op: op.apply_padded(p, a),
                             up.parts, aux.parts, self.ops), self.dim)

    def A_aux(self, u: Sharded, radius, aux: Sharded) -> Sharded:
        f = self.free
        return f * self.K(f * u, aux) + (1.0 - f) * u

    def A_aux_lo(self, u: Sharded, aux_lo: Sharded) -> Sharded:
        """The smoother's bf16-I/O matvec (B2 on every slab)."""
        f = self.free
        out = self.K((f * u).to(torch.bfloat16), aux_lo).to(u.dtype)
        return f * out + (1.0 - f) * u

    def vjp_r2(self, g: Sharded, u: Sharded, aux: Sharded) -> torch.Tensor:
        """The padded r^2-cotangent of sum(g * K u) on the replicated
        device: each slab's (the r^2-cotangent kernel on its ghost-padded
        u, the terms of the beams' endpoints inside the slab) added into
        the whole field in rank order, where neighbouring slabs overlap."""
        up = self.exchange(u)
        parts = _each(lambda gk, pk, ak, op: op.vjp_r2_padded(gk, pk, ak),
                      g.parts, up.parts, aux.parts, self.ops)
        s = self.ops[0].grid[self.axis]
        shape = list(parts[0].shape)
        shape[self.rdim] = s * len(parts) + 2
        out = torch.zeros(shape, dtype=parts[0].dtype,
                          device=self.replicated)
        for k, p in enumerate(parts):
            out.narrow(self.rdim, k * s, s + 2).add_(
                _copy(p, self.replicated))
        return out

    def lmax(self, D: torch.Tensor, aux: torch.Tensor,
             iters: int) -> torch.Tensor:
        """The level's power iteration on the slabs (norms reduced in rank
        order), from its replicated D and r^2; the replicated result."""
        Ds, auxs = self.scatter(D), self.padded_r2(aux)
        lam = _estimate_lmax(lambda u: self.A_aux(u, None, auxs), Ds,
                             D.shape, D.dtype, iters=iters)
        return lam.parts[0]


class SlabFused:
    """B3 and B4 (and B3c, B4c) on the slabs of a ``SlabLevel``, each
    launch after a halo exchange of the field read at neighbours.  Routed
    by the whole level; never a single (B5) level."""

    def __init__(self, level: SlabLevel):
        self.fzs = [op.fused for op in level.ops]
        self.ok = self.fzs[0].ok
        self.single_ok = False

    def sc(self, lmax: Sharded, frac: float) -> Sharded:
        return Sharded([fz.sc(lm, frac)
                        for fz, lm in zip(self.fzs, lmax.parts)])

    def residual(self, b, x, fm, r2, compute: Optional[str] = None):
        halo_exchange(x)
        return Sharded(_each(
            lambda bk, xk, fk, rk, fz: fz.residual(bk, xk, fk, rk, compute),
            b.parts, x.parts, fm.parts, r2.parts, self.fzs), b.dim)

    def cheb_run(self, x, r, d, fd, sc, r2, c1: float, c2: float,
                 final: bool, compute: Optional[str] = None):
        halo_exchange(d)
        outs = _each(lambda xk, rk, dk, fk, sk, r2k, fz: fz.cheb_run(
            xk, rk, dk, fk, sk, r2k, c1, c2, final, compute),
            x.parts, r.parts, d.parts, fd.parts, sc.parts, r2.parts,
            self.fzs)
        if final:
            return Sharded(outs, x.dim)
        return tuple(Sharded(list(v), x.dim) for v in zip(*outs))


# -------------------------------------------------------------- transfers
def _window(x: Sharded, k: int, lo: int, hi: int) -> torch.Tensor:
    """Planes [lo, hi) of the whole field along ``x.dim``, fetched from
    the slabs that hold them (in rank order) onto slab k's device."""
    s = x.parts[0].shape[x.dim]
    pieces = []
    for j, p in enumerate(x.parts):
        a, b = max(lo, j * s), min(hi, (j + 1) * s)
        if a < b:
            piece = p.narrow(x.dim, a - j * s, b - a)
            pieces.append(piece if j == k else _copy(piece, x.parts[k].device))
    return torch.cat(pieces, dim=x.dim)


def _spans(P: np.ndarray, n: int, by_rows: bool):
    """Per output slab k, the range [lo, hi) of input indices its dense
    rows of the per-class matrices ``P`` [nc, X, C] reach: for prolong
    (``by_rows``) the output is X, cut into n slabs, and the inputs C; for
    restrict the other way round."""
    nz = np.abs(P).sum(axis=0) > 0          # [X, C], any class
    if not by_rows:
        nz = nz.T
    s = nz.shape[0] // n
    out = []
    for k in range(n):
        cols = np.nonzero(nz[k * s:(k + 1) * s].any(axis=0))[0]
        out.append((int(cols.min()), int(cols.max()) + 1))
    return out


def slab_transfers(fine_grid, coarse_grid, class_keys, axis: int, devices,
                   dtype):
    """(prolong, restrict) between two levels held in slabs along grid
    ``axis``: ``multigrid.make_transfers``'s per-axis contractions in its
    order (prolong x, y, z; restrict z, y, x), the sharded axis's taking
    each output slab's dense rows of ``_interp_matrix`` over the input
    planes they reach (``_window``), the others local to the slab."""
    keys = np.asarray(class_keys, dtype=float)
    nc = len(keys)
    Ps = [np.stack([_interp_matrix(fine_grid[a], coarse_grid[a],
                                   float(keys[c][a])) for c in range(nc)])
          for a in range(3)]
    n = len(devices)
    letters = "xyz"
    dim = 2 + axis
    sf, sc = fine_grid[axis] // n, coarse_grid[axis] // n
    spans_p = _spans(Ps[axis], n, True)
    spans_r = _spans(Ps[axis], n, False)
    tens = lambda a, d: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                        device=d)
    # per slab: the three axes' matrices, the sharded one cut to the
    # slab's rows (prolong) or columns (restrict) and its input span
    pro = [[tens(Ps[a], d) if a != axis else
            tens(Ps[a][:, k * sf:(k + 1) * sf, slice(*spans_p[k])], d)
            for a in range(3)] for k, d in enumerate(devices)]
    res = [[tens(Ps[a], d) if a != axis else
            tens(Ps[a][:, slice(*spans_r[k]), k * sc:(k + 1) * sc], d)
            for a in range(3)] for k, d in enumerate(devices)]

    def spec(a: int, inp: str, out: str) -> str:
        src = "cd" + letters[:a] + inp + letters[a + 1:]
        dst = "cd" + letters[:a] + out + letters[a + 1:]
        return f"{src},c{out}{inp}->{dst}" if inp == "q" \
            else f"{src},c{inp}{out}->{dst}"

    def contract(x: Sharded, mats, a: int, to_fine: bool, spans):
        eq = spec(a, "q", letters[a]) if to_fine else spec(a, letters[a], "q")
        parts = []
        for k in range(len(x.parts)):
            v = _window(x, k, *spans[k]) if a == axis else x.parts[k]
            parts.append(torch.einsum(eq, v, mats[k][a].to(v.dtype)))
        return Sharded(parts, dim)

    def prolong(c: Sharded) -> Sharded:
        with _full_precision_matmul():
            for a in range(3):
                c = contract(c, pro, a, True, spans_p)
            return c

    def restrict(f: Sharded) -> Sharded:
        with _full_precision_matmul():
            for a in (2, 1, 0):
                f = contract(f, res, a, False, spans_r)
            return f

    return prolong, restrict


def sharded_levels(h: dict, n: int, axis: int, fused: bool) -> int:
    """How many leading levels of the hierarchy run on slabs: each must
    divide along ``axis`` by ``n`` and, on the fused route, smooth with B3
    and B4 (a level the plan gives B5, one launch for the whole smoother
    with no halo exchange inside it, runs gathered); from the first level
    that fails, the rest of the V-cycle runs gathered."""
    k = 0
    for lvl in h["levels"]:
        if lvl.slat.grid[axis] % n or (fused and lvl.fused.single_ok):
            break
        k += 1
    return k


# --------------------------------------------------------------- the step
class ShardedStructuredStep:
    """``sharded_step(radius_field, u0=None, precond_state=None) -> (c, g,
    u)`` of ``make_structured_compliance_step``'s step on the slabs of the
    devices ``devices`` (mesh row 0 along the sharded axis), cut along
    grid ``axis``.

    The radius field, r^2, the diagonal and the multigrid state stay
    replicated on ``devices[0]`` (as in JAX); the nodal fields live in
    slabs.  Every CG matvec and smoother matvec is a halo exchange and B1
    (f32 or f64; B1w, B2, B3, B4 where the route takes them) per slab; the
    dots and norms are reduced in rank order.  The gradient is the
    implicit form: the adjoint solve on the slabs, each slab's
    r^2-cotangent (its beams' terms from the endpoints inside it) added
    into the replicated padded r^2 cotangent in rank order, then autograd
    of ``prepare`` on the replicated device; every cell's entry comes from
    that one replicated sum.  ``u`` comes back as a ``Sharded`` (its
    ``gather()`` the whole field) and is taken back as ``u0``."""

    def __init__(self, step, devices, axis: int):
        p = step._parts
        self.step = step
        self.devices = list(devices)
        self.axis = axis
        self.n = len(self.devices)
        self.matvec = p["matvec"]
        self.dtype = p["f"].dtype
        self.replicated = p["f"].device
        if self.devices[0] != self.replicated:
            raise ValueError(f"shard_structured_step: the mesh's first "
                             f"device {self.devices[0]} is not the step's "
                             f"{self.replicated}")
        self.op = SlabLevel(p["matvec"], p["lattice"], p["free"],
                            self.devices, axis)
        self.free = self.op.free
        self.f = self.op.scatter(p["f"])
        self.u_imp = None if p["u_imposed"] is None \
            else self.op.scatter(p["u_imposed"])
        self.h = p["hierarchy"]
        self.fused = p["fused"]
        self.opts = p["mg_opts"]
        self.solves: List[dict] = []
        self.last_solve = self.last_adjoint = None
        self.n_sharded = 0
        if self.h is not None:
            self._shard_hierarchy()

    def _shard_hierarchy(self) -> None:
        h, n, axis = self.h, self.n, self.axis
        levels = h["levels"]
        ns = self.n_sharded = sharded_levels(h, n, axis, self.fused)
        slabs = [SlabLevel(lvl.matvec, lvl.slat, lvl.free, self.devices,
                           axis) for lvl in levels[:ns]]
        self.slab_levels = slabs
        restrict, prolong = list(h["restrict"]), list(h["prolong"])
        dev0, dim = self.replicated, 2 + axis
        for i in range(min(ns, len(levels) - 1)):
            if i < ns - 1:
                prolong[i], restrict[i] = slab_transfers(
                    levels[i].slat.grid, levels[i + 1].slat.grid,
                    levels[i].slat.class_keys, axis, self.devices,
                    self.dtype)
            else:
                # into the gathered levels: gather the residual onto the
                # replicated device, scatter the correction back
                r_, p_ = h["restrict"][i], h["prolong"][i]
                restrict[i] = lambda x, _r=r_: _r(gather(x, dev0))
                prolong[i] = lambda c, _p=p_: scatter(_p(c), self.devices,
                                                      dim)
        self.hs = {"levels": slabs + list(levels[ns:]),
                   "restrict": restrict, "prolong": prolong,
                   "restrict_radius": h["restrict_radius"]}

    # ------------------------------------------------------------ state
    def precond_state(self, radius: torch.Tensor) -> dict:
        """The replicated multigrid state, with the power iteration of
        every sharded level on its slabs."""
        power = self.step._parts["power"]
        lmax_of = lambda i, D, aux: self.slab_levels[i].lmax(D, aux, power) \
            if i < self.n_sharded else None
        return mg_precond_state(self.h, radius, power_iters=power,
                                fused=self.opts.get("fused"),
                                lmax_of=lmax_of)

    def slab_state(self, state: dict) -> dict:
        """The replicated state with the sharded levels' entries sliced
        onto their slabs (halos included); lmax broadcast."""
        out = {k: list(v) if isinstance(v, list) else v
               for k, v in state.items()}
        for i, sl in enumerate(self.slab_levels):
            out["auxs"][i] = sl.padded_r2(state["auxs"][i])
            out["Ds"][i] = sl.scatter(state["Ds"][i])
            out["lmaxs"][i] = broadcast(state["lmaxs"][i], sl.devices)
            lo = (state.get("auxs_lo") or [None] * (i + 1))[i]
            if lo is not None:
                out["auxs_lo"][i] = sl.padded_r2(lo)
            fo = (state.get("fused") or [None] * (i + 1))[i]
            if fo is not None:
                out["fused"][i] = {"fdinv": sl.padded(fo["fdinv"]),
                                   "fm": sl.padded(fo["fm"]),
                                   "r2": sl.padded_r2(fo["r2"])}
        return out

    def preconditioner(self, radius: torch.Tensor,
                       pstate: Optional[dict]) -> Callable:
        with torch.no_grad():
            r = radius.detach()
            if self.h is not None:
                if pstate is None:
                    pstate = self.precond_state(r)
                M = mg_apply(self.hs, self.slab_state(pstate), **self.opts)
                if self.n_sharded:
                    return M
                # no level on slabs: the whole V-cycle runs gathered
                return lambda r_: self.op.scatter(M(self.op.gather(r_)))
            p = self.step._parts
            free = p["free"]
            dg = free * p["diag"](r) + (1.0 - free)
            dg = self.op.scatter(torch.where(dg == 0, torch.ones_like(dg),
                                             dg))
            return lambda r_: r_ / dg

    # ------------------------------------------------------------- step
    def _u(self, u0) -> Sharded:
        if u0 is None:
            return self.f.map(torch.zeros_like)
        if isinstance(u0, Sharded):
            if len(u0.parts) != self.n or u0.dim != self.op.dim:
                raise ValueError(f"u0: {u0!r} is not a field in {self.n} "
                                 f"slabs along dim {self.op.dim}")
            return u0
        return self.op.scatter(torch.as_tensor(
            u0, dtype=self.dtype, device=self.replicated))

    def __call__(self, radius_field, u0=None, precond_state=None):
        p = self.step._parts
        free, f, op = self.free, self.f, self.op
        fused, tol, maxiter = self.fused, p["tol"], p["maxiter"]
        r = torch.as_tensor(radius_field, dtype=self.dtype,
                            device=self.replicated)
        u0 = self._u(u0)
        rf = r.detach().requires_grad_(True)
        with torch.enable_grad():
            aux = self.matvec.prepare(rf)
        aux_s = op.padded_r2(aux.detach())
        K = lambda u: op.K(u, aux_s)
        A = lambda u: free * K(free * u) + (1.0 - free) * u
        u_imp = self.u_imp if self.u_imp is not None \
            else f.map(torch.zeros_like)
        b = free * f if self.u_imp is None \
            else free * (f - K(u_imp)) + (1.0 - free) * u_imp
        M = self.preconditioner(r, precond_state)
        x0 = u0 * free
        self.solves = []

        def solve(rhs):
            res = pcg(A, free * rhs if fused else rhs, M=M, x0=x0,
                      maxiter=maxiter, tol=tol, ops=OPS)
            self.solves.append({"iterations": res.iterations,
                                "residual_norm": res.residual_norm.parts[0],
                                "converged": res.converged})
            return res.x + (1.0 - free) * rhs if fused else res.x

        with torch.no_grad():
            x = solve(b)
            u = free * x + (1.0 - free) * u_imp
        obj, ubar = self._objective(u)
        with torch.no_grad():
            lam = solve(ubar * free)
            r2bar = op.vjp_r2((-lam) * free, free * x, aux_s)
            if self.u_imp is not None:
                r2bar = r2bar + op.vjp_r2(-(lam * free), self.u_imp, aux_s)
        (g,) = torch.autograd.grad(aux, rf, grad_outputs=r2bar)
        self.last_solve, self.last_adjoint = self.solves
        return obj, g, u

    def _objective(self, u: Sharded):
        """(objective, its u-cotangent as slabs): the compliance as
        per-slab sums added in rank order (its cotangent f), or a custom
        objective on the gathered field with its cotangent by autograd,
        scattered back."""
        p = self.step._parts
        if p["objective"] is None:
            with torch.no_grad():
                parts = [torch.sum(fk * uk)
                         for fk, uk in zip(self.f.parts, u.parts)]
                return all_reduce_sum(parts)[0], self.f
        ug = self.op.gather(u).requires_grad_(True)
        with torch.enable_grad():
            obj = p["objective"](ug, p["f"])
            (ubar,) = torch.autograd.grad(obj, ug)
        return obj.detach(), self.op.scatter(ubar)
