"""Surrogate-DDM design optimization — the reference's headline workflow
(PyTorch).

The port of ``pylatticedso_tpu.opti.ddm_optimizer``.  The reference's fast
path (26 min vs 8 h, optimization_methods.md:19,62) is: per-cell Schur
surrogates (greedy RB + RBF alpha(mu)), analytic dS/dr = B dalpha/dr,
interface CG, adjoint CG, SLSQP (lattice_opti.py:559-901,
lattice_sim.py:921-1082).  Here the chain is one differentiable torch
program on the problem's device: theta -> cell radii -> RBF alpha (one
batched expression over the cells) -> batched S reconstruction (one GEMM)
-> masked interface solve (``fem.solve``'s implicit solves) -> objective;
autograd runs the adjoint solve and the dS/dr chain, and the SLSQP and
projected drivers of ``OptimizationProblem`` are reused unchanged.  Every
gather on the gradient path (the cells' radii, the cells' boundary nodes)
has the ordered per-segment sum of ``SegmentSum`` as its gradient, and the
dense interface matrix is an ordered sum per entry, so an evaluation gives
the same bits on every call.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product
from typing import Optional

import numpy as np
import torch

from ..design.lattice import Lattice
from ..fem.operator import SegmentSum
from ..fem.solve import (linear_solve, linear_solve_dense_refined,
                         linear_solve_refined)
from ..ddm.schur import (EntrySum, discretize_cell_chained,
                         schur_batch_chained, schur_penalized_batch)
from ..ddm.solver import build_ddm_system
from ..ddm.surrogate import (SchurSurrogate, ThinPlateSplineRBF,
                             reduce_basis_greedy)
from .optimizer import OptimizationProblem, _np

__all__ = ["DDMOptimizationProblem", "build_schur_surrogate"]

#: interface size above which the refined route stays matrix-free: the
#: dense f32 interface matrix is O((6N)^2) memory
DENSE_MAX_DOF = 20_000


def build_schur_surrogate(lattice: Lattice, material, min_radius: float,
                          max_radius: float, step: float = 0.01,
                          tol_greedy: float = 1e-6,
                          target_h: Optional[float] = None,
                          share_weights: bool = True,
                          penalization: bool = False,
                          batch: int = 64, cell: int = 0,
                          cache_tag: str = "",
                          device="cuda") -> SchurSurrogate:
    """Offline RB training over the radius grid
    (construct_schur_complement_dataset parity).

    Uses the chained condensation (per-beam binary-doubling elimination of
    the subdivision chain, then a junction-level Schur), in float64 on
    ``device`` in batches of ``batch`` samples: identical to the
    subdivided computation to machine precision at ~1/1000 the dense cost,
    so dense multi-geometry grids (10 points/axis ^ 3 geometries) are
    affordable.

    ``penalization=True`` reproduces the reference's dataset semantics of
    re-penalizing the cell for every radius sample (its dataset script calls
    reset_cell_with_new_radii -> set_penalized_beams per combination,
    lattice_sim.py:1480-1500): 1.5x-radius end zones of per-sample length
    L = r/tan(theta/2), condensed exactly via the piecewise chain (host
    numpy, as in the JAX package).  This is what the reference's committed
    optimization records were produced with.

    ``cell`` selects the representative cell to condense (default 0, the
    full template); ``cache_tag`` distinguishes cached bases of different
    cell topologies (per-group surrogates for trimmed lattices).  The basis
    is cached under the working directory's
    ``data/outputs/schur_complement`` with the JAX package's file names and
    schema, so a basis cached by one package loads in the other.
    """
    grid = np.round(np.arange(min_radius, max_radius + step / 2, step), 6)
    combos = np.array([c for c in product(grid, repeat=lattice.config.n_geom)
                       if sum(c) > 0.003])

    # cache the trained basis like the reference's reduced-basis npz files
    # (greedy_algorithm.py:157-233): keyed by geometries, grid, tolerance,
    # and penalization mode
    from pathlib import Path

    from ..ddm.surrogate import load_reduced_basis, save_reduced_basis
    cache = Path("data/outputs/schur_complement") / (
        "rb_" + "_".join(lattice.config.geom_types)
        + f"_{grid[0]:g}_{grid[-1]:g}_{len(grid)}"
        + f"_tol{tol_greedy:g}"
        + ("_pen" if penalization else "")
        + ("_shared" if share_weights else "")
        + (f"_{cache_tag}" if cache_tag else "") + ".npz")
    if cache.exists():
        d = load_reduced_basis(cache)
        return SchurSurrogate(basis=d["basis_reduced_ortho"],
                              alpha=d["alpha_ortho"],
                              samples=d["list_elements"], kind="RBF",
                              device=device)
    S_all = []
    if penalization:
        if cell != 0:
            raise NotImplementedError(
                "penalized surrogate training only supports the full cell "
                "template (cell 0); train per-group surrogates without "
                "penalization")
        for i in range(0, len(combos), batch):
            S_all.append(schur_penalized_batch(
                lattice, combos[i:i + batch], material.young_modulus,
                material.poisson_ratio, target_h=target_h,
                share_weights=share_weights))
    else:
        disc = discretize_cell_chained(lattice, cell, target_h=target_h,
                                       share_weights=share_weights)
        for i in range(0, len(combos), batch):
            S_all.append(schur_batch_chained(
                disc, combos[i:i + batch], material.young_modulus,
                material.poisson_ratio, device=device).cpu().numpy())
    S_all = np.concatenate(S_all, axis=0)
    schur_dict = {tuple(c): S for c, S in zip(combos, S_all)}
    B, A, L = reduce_basis_greedy(schur_dict, tol_greedy)
    try:
        save_reduced_basis(cache, B, A, L)
    except OSError:
        pass
    return SchurSurrogate(basis=B, alpha=A, samples=L, kind="RBF",
                          device=device)


@dataclass
class _SurrogateGroup:
    """One cell-topology group of the surrogate interface operator."""
    cells: np.ndarray        # [C_g] cell ids
    bn: torch.Tensor         # [C_g, nb_g] boundary-node ids (sim order)
    m: int                   # 6 * nb_g
    basis: torch.Tensor      # [m*m, m_rb] reduced basis
    rbf: ThinPlateSplineRBF  # alpha(mu)
    cell_gather: SegmentSum  # the group's cell radii, cr[cells]
    node_sum: SegmentSum     # per-node sum over bn, and the gather u[bn]


def _topology_groups(lattice: Lattice):
    """Group cells by the radius-independent part of the DDM grouping
    signature (local subgraph, per-edge geometry types and multiplicities,
    cell size) — cells in one group share a Schur parameterization
    S_g(cell_radii) and can share one RB surrogate.

    Returns (group_of_cell [C], representative cell ids, topology tags).
    """
    import hashlib

    mult = np.bincount(lattice.cell_edge_idx, minlength=lattice.num_edges)
    sig_to_group: dict = {}
    group_of_cell = np.zeros(lattice.num_cells, dtype=np.int64)
    reps, tags = [], []
    for c in range(lattice.num_cells):
        eids = lattice.cell_edge_idx[
            lattice.cell_edge_ptr[c]:lattice.cell_edge_ptr[c + 1]]
        nids = lattice.cell_node_idx[
            lattice.cell_node_ptr[c]:lattice.cell_node_ptr[c + 1]]
        o, s = lattice.cell_origin[c], lattice.cell_size[c]
        remap = np.zeros(lattice.num_nodes, dtype=np.int64)
        remap[nids] = np.arange(len(nids))
        sig = (np.round((lattice.nodes[nids] - o) / s, 9).tobytes(),
               remap[lattice.edges[eids]].tobytes(),
               lattice.edge_type[eids].tobytes(),
               mult[eids].tobytes(),
               tuple(np.round(s, 9)))
        if sig not in sig_to_group:
            sig_to_group[sig] = len(reps)
            reps.append(c)
            h = hashlib.sha1()
            for part in sig[:-1]:
                h.update(part)
            h.update(np.asarray(sig[-1]).tobytes())
            tags.append(h.hexdigest()[:12])
        group_of_cell[c] = sig_to_group[sig]
    return group_of_cell, reps, tags


class DDMOptimizationProblem(OptimizationProblem):
    """OptimizationProblem whose equilibrium solve runs on the surrogate-DDM
    interface system instead of the full matrix-free operator."""

    def __init__(self, lattice: Lattice, surrogate: Optional[SchurSurrogate] = None,
                 tol_greedy: float = 1e-6, grid_step: float = 0.01,
                 share_weights: bool = True, penalization: bool = False,
                 spd_shift: float = 1e-6,
                 refined: Optional[bool] = None,
                 target_h: Optional[float] = None, **kwargs):
        super().__init__(lattice, **kwargs)
        dev = self.device
        #: mixed-precision interface solve: f32 CG iterations or an
        #: equilibrated f32 dense Cholesky, with float64 residual
        #: refinement (fem.solve.linear_solve_refined /
        #: linear_solve_dense_refined) — the JAX package's accelerator
        #: route to the penalized tol-1e-9 interface solve (the
        #: reference's PETSc-f64 semantics).  Auto: ON on a CUDA device.
        if refined is None:
            refined = dev.type == "cuda"
        self.refined = refined
        #: relative diagonal shift added to every reconstructed Schur block.
        #: RBF interpolation error (~1e-3 relative) can push a cell's
        #: near-null rigid-body modes slightly NEGATIVE at the sample-grid
        #: edges (measured with the JAX package: -1.6e-5 at r = r_min),
        #: making the interface operator indefinite and CG divergent on
        #: SLSQP line-search trials.
        self.spd_shift = spd_shift

        # interface topology from the exact DDM assembly (radius-independent
        # without penalization), in float64: here the interface data feeds
        # the f64 surrogate operator directly — an f32-rounded f_applied
        # perturbs the objective by ~5e-8 relative, above the 1e-9 solve
        # tolerance
        sys_ = build_ddm_system(lattice, self.material, self.bc,
                                penalization=False,
                                share_weights=share_weights,
                                dtype=torch.float64, device=dev)
        self._iface_free = sys_.free                    # [N,6]
        self._iface_f = sys_.f_applied
        self._iface_u_imp = sys_.u_imposed
        self._n_nodes = sys_.n_nodes

        def group(cells, bn, sur):
            return _SurrogateGroup(
                cells=cells, bn=bn, m=6 * bn.shape[1],
                basis=torch.as_tensor(sur.basis, dtype=torch.float64,
                                      device=dev),
                rbf=sur._rbf,
                cell_gather=SegmentSum(torch.as_tensor(cells, device=dev),
                                       lattice.num_cells),
                node_sum=SegmentSum(bn.reshape(-1), self._n_nodes))

        if sys_.homogeneous:
            if surrogate is None:
                surrogate = build_schur_surrogate(
                    lattice, self.material, self.param.min_radius,
                    self.param.max_radius, step=grid_step,
                    tol_greedy=tol_greedy, share_weights=share_weights,
                    penalization=penalization, target_h=target_h,
                    device=dev)
            self._surrogate = surrogate
            self._cell_bnodes = sys_.cell_bnodes        # [C, nb]
            self._nb = sys_.nb
            self._m = sys_.m
            self._groups = [group(np.arange(lattice.num_cells),
                                  sys_.cell_bnodes, surrogate)]
            self._basis = self._groups[0].basis
        else:
            # mixed-topology (trimmed/bone) lattice: one RB surrogate per
            # cell-TOPOLOGY group (same local subgraph, edge types, and
            # cell size — the radius-independent part of the exact DDM's
            # grouping signature), trained on that group's representative
            # cell.  The online operator batches per group, exactly like
            # the exact heterogeneous DDM (ddm/solver.py DDMSystem.matvec).
            if surrogate is not None:
                raise ValueError(
                    "a single pre-trained surrogate cannot serve a "
                    "mixed-topology lattice; leave surrogate=None so "
                    "per-group surrogates are trained")
            if penalization:
                import warnings
                warnings.warn(
                    "penalized per-group surrogates are not supported for "
                    "mixed-topology lattices; training without penalization",
                    stacklevel=2)
            group_of_cell, reps, tags = _topology_groups(lattice)
            self._surrogate = None
            self._cell_bnodes = self._nb = self._m = self._basis = None
            self._groups = []
            verbose = bool(int(__import__("os").environ.get(
                "PLDSO_DDM_VERBOSE", "0")))
            for g, (rep, tag) in enumerate(zip(reps, tags)):
                if verbose:
                    print(f"  training surrogate group {g + 1}/"
                          f"{len(reps)} (rep cell {rep})", flush=True)
                sur = build_schur_surrogate(
                    lattice, self.material, self.param.min_radius,
                    self.param.max_radius, step=grid_step,
                    tol_greedy=tol_greedy, share_weights=share_weights,
                    penalization=False, cell=rep, cache_tag=tag,
                    target_h=target_h, device=dev)
                cells = np.nonzero(group_of_cell == g)[0]
                bn = torch.as_tensor(
                    np.stack([sys_.bn_list[c] for c in cells]),
                    dtype=torch.long, device=dev)
                self._groups.append(group(cells, bn, sur))
        # the dense refined branch's interface matrix A32.at[I, J].add of
        # every group's blocks: one ordered sum per distinct entry
        self._dense = None
        if self.refined and 6 * self._n_nodes <= DENSE_MAX_DOF:
            I, J = [], []
            for grp in self._groups:
                bn = grp.bn.cpu().numpy().astype(np.int64)
                dof = (bn[:, :, None] * 6 + np.arange(6)).reshape(-1, grp.m)
                I.append(np.repeat(dof, grp.m, axis=1).reshape(-1))
                J.append(np.tile(dof, (1, grp.m)).reshape(-1))
            self._dense = EntrySum(np.concatenate(I), np.concatenate(J),
                                   6 * self._n_nodes, dev)
        # warm start of each interface solve (and its adjoint, via the
        # A-norm-optimal guess scaling) from the previous iterate's
        # solution, and one value+grad evaluation per point (SLSQP asks for
        # the objective and the gradient separately)
        self._u_warm = None
        self._vg_cache = None
        #: the last value-and-gradient's preconditioner applications in its
        #: forward and adjoint solves: its CG iterations (on the dense
        #: refined branch, its refinement passes)
        self.last_solves = {"forward": None, "adjoint": None}
        self._applied = 0

    def _counted(self, M):
        def apply(r):
            self._applied += 1
            return M(r)
        return apply

    def _vg_aux(self, theta, u0):
        """((objective, u), d objective / d theta) at ``theta`` from the
        warm start ``u0``."""
        th = self._theta(theta).detach().requires_grad_(True)
        self._applied = 0
        with torch.enable_grad():
            v, u = self._objective_theta_aux(th, u0)
            forward = self._applied
            (g,) = torch.autograd.grad(v, th)
        self.last_solves = {"forward": forward,
                            "adjoint": self._applied - forward}
        return (v.detach(), u), g

    def _eval(self, theta):
        tb = np.asarray(theta, dtype=np.float64).tobytes()
        if self._vg_cache is not None and self._vg_cache[0] == tb:
            return self._vg_cache[1], self._vg_cache[2]
        u0 = self._u_warm
        if u0 is None:
            u0 = torch.zeros((self._n_nodes, 6), dtype=self._iface_f.dtype,
                             device=self.device)
        (v, u), g = self._vg_aux(theta, u0)
        self._u_warm = u
        v = float(v)
        if self.objective_type == "compliance" and v <= 0.0:
            # compliance of a stable structure is strictly positive; a
            # non-positive value means the RBF-interpolated interface
            # operator went indefinite at this design (sparse sample
            # grids).  Surface it as NaN so the SLSQP driver's rejection
            # layer treats the trial like any other invalid region instead
            # of DESCENDING into the unphysical minimum (observed with the
            # JAX package: a 3-points-per-axis grid optimizing to
            # compliance -18).
            v = float("nan")
        out = (v, _np(g))
        self._vg_cache = (tb, out[0], out[1])
        return out

    def objective(self, theta) -> float:
        return self._eval(theta)[0]

    def gradient(self, theta) -> np.ndarray:
        return self._eval(theta)[1]

    # ------------------------------------------------------------------
    def _group_schur_batch(self, g: int, cell_radii: torch.Tensor) -> torch.Tensor:
        """[C_g, m_g, m_g] Schur blocks of topology group ``g`` from its RBF
        surrogate — one batched RBF expression and one GEMM."""
        grp = self._groups[g]
        alpha = grp.rbf.evaluate_batch(grp.cell_gather.gather(cell_radii))
        vec = alpha @ grp.basis.T                                  # [C_g, m*m]
        n = grp.m
        S = vec.reshape(-1, n, n).transpose(1, 2)                  # F-order unravel
        S = 0.5 * (S + S.transpose(1, 2))                          # SPD hygiene
        if self.spd_shift:
            tr = torch.diagonal(S, dim1=1, dim2=2).sum(1) / n
            S = S + (self.spd_shift * tr)[:, None, None] \
                * torch.eye(n, dtype=S.dtype, device=S.device)
        return S

    def _cell_schur_batch(self, cell_radii: torch.Tensor) -> torch.Tensor:
        """[C, m, m] Schur blocks (homogeneous single-group lattices)."""
        return self._group_schur_batch(0, cell_radii)

    def _solve_u(self, radius_e=None, *, theta=None):
        raise RuntimeError("use _objective_theta")

    def _objective_theta(self, theta: torch.Tensor) -> torch.Tensor:
        return self._objective_theta_aux(theta, None)[0]

    def _objective_theta_aux(self, theta: torch.Tensor, u0):
        cr = self.param.cell_radii(theta)
        # one [C_g, m_g, m_g] reconstruction per topology group (homogeneous
        # lattices are the single-group case, one GEMM over all cells)
        S_list = [self._group_schur_batch(g, cr)
                  for g in range(len(self._groups))]
        free, f, u_imp = self._iface_free, self._iface_f, self._iface_u_imp
        N = self._n_nodes

        def make_K(Ss):
            def K(u):
                out = torch.zeros((N, 6), dtype=u.dtype, device=u.device)
                for S_, grp in zip(Ss, self._groups):
                    Ub = grp.node_sum.gather(u).reshape(-1, grp.m)
                    R = torch.bmm(S_, Ub[:, :, None])[:, :, 0]
                    out = out + grp.node_sum(R.reshape(-1, 6))
                return out
            return K

        def make_A(K_, free_):
            return lambda u: free_ * K_(free_ * u) + (1.0 - free_) * u

        K = make_K(S_list)
        A = make_A(K, free)

        # node-diagonal Jacobi from the assembled S blocks (the
        # preconditioner never moves the fixed point: no gradient)
        with torch.no_grad():
            diag = torch.zeros((N, 6), dtype=S_list[0].dtype,
                               device=S_list[0].device)
            for S_, grp in zip(S_list, self._groups):
                blocks = torch.diagonal(S_, dim1=1, dim2=2)
                diag = diag + grp.node_sum(blocks.reshape(-1, 6))
            diag = free * diag + (1.0 - free)
            diag = torch.where(diag == 0, torch.ones_like(diag), diag)

        b = free * (f - K(u_imp)) + (1.0 - free) * u_imp
        x0 = None if u0 is None else u0.detach()
        if self.refined and S_list[0].dtype == torch.float64 \
                and self._dense is None:
            # large interface (6N > DENSE_MAX_DOF): the dense assembly
            # below is O((6N)^2) memory — stay matrix-free: f32 CG on the
            # surrogate operator
            # + f64 residual refinement to the same tol-1e-9 semantics
            f32 = torch.float32
            S32 = [S_.detach().to(f32) for S_ in S_list]
            free32 = free.to(f32)
            A_lo = make_A(make_K(S32), free32)
            diag32 = diag.to(f32)
            u = linear_solve_refined(
                A_lo, b, A_hi=A, M=self._counted(lambda r: r / diag32),
                maxiter=self.cg_maxiter, tol=self.cg_tol, x0=x0)
        elif self.refined and S_list[0].dtype == torch.float64:
            # small interface (a few thousand DOFs): dense mixed precision —
            # assemble the interface matrix, equilibrate, factor once in
            # f32, and refine with f64 residuals
            # (linear_solve_dense_refined).  Gradients flow through the
            # f64 operator via the implicit solve; the adjoint solve reuses
            # the same factor.
            f32 = torch.float32
            A32 = self._dense(torch.cat([S_.detach().to(f32).reshape(-1)
                                         for S_ in S_list]))
            free_flat = free.reshape(-1).to(f32)
            A32 = free_flat[:, None] * A32 * free_flat[None, :] \
                + torch.diag(1.0 - free_flat)
            # Jacobi equilibration: halves the effective condition number's
            # spread across penalized/thin-radius cells before the f32 factor
            d32 = torch.diagonal(A32)
            s32 = torch.rsqrt(torch.where(d32 <= 0, torch.ones_like(d32),
                                          d32))
            L32, info = torch.linalg.cholesky_ex(
                s32[:, None] * A32 * s32[None, :])
            # a trial design whose operator is not positive definite gives
            # a NaN factor (as jnp.linalg.cholesky does), so the
            # evaluation is NaN and SLSQP's rejection layer drops the trial
            L32 = torch.where(info != 0, torch.full_like(L32, float("nan")),
                              L32)

            def apply_inv(r):
                y = (s32 * r.reshape(-1).to(f32))[:, None]
                y = torch.linalg.solve_triangular(L32, y, upper=False)
                y = torch.linalg.solve_triangular(L32.T, y, upper=True)
                return (s32 * y[:, 0]).reshape(N, 6)

            u = linear_solve_dense_refined(self._counted(apply_inv), b,
                                           A_hi=A, tol=self.cg_tol, x0=x0)
        else:
            # periodic restart (reference CG guard,
            # conjugate_gradient_solver.py): surrogate interpolation noise
            # can make the interface operator momentarily indefinite on
            # SLSQP line-search trials; restarting bounds the drift.  The
            # reference also clamps alpha at 0.1, but under OUR Jacobi
            # scaling natural CG steps are O(1) — the clamp stalls
            # convergence entirely (measured), so it stays off.
            u = linear_solve(A, b, M=self._counted(lambda r: r / diag),
                             maxiter=self.cg_maxiter, tol=self.cg_tol,
                             restart_every=1000, x0=x0, scale_x0=True)
        u = free * u + (1.0 - free) * u_imp
        return self._objective_u(u), u.detach()
