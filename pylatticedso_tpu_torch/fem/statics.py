"""Full-lattice static equilibrium solve (PyTorch).

The port of ``pylatticedso_tpu.fem.statics``: lattice arrays (+ optional
subdivision) -> ``BeamOperator`` -> SPD-preserving Dirichlet masking ->
Jacobi-preconditioned CG -> displacements, reactions, compliance, strain
energy.  The operator sums per node in a fixed order (``SegmentSum``), so
a solve gives the same bits on every call, on the card and on the CPU.
Tensors live on ``device`` (default ``"cuda"``) in ``dtype`` (default
float64, as ``build_operator``); results come back as numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..design.lattice import Lattice
from ..materials import MatProperties
from ..utils.timing import timing
from .bc import BCArrays, apply_boundary_conditions
from .operator import build_operator, masked_operator
from .solve import linear_solve, pcg
from .subdivide import subdivide_edges

__all__ = ["FEMResult", "StaticProblem", "make_problem", "solve_fem"]


@dataclass
class FEMResult:
    u: np.ndarray           # [N,6] displacements+rotations (original nodes first)
    reaction: np.ndarray    # [N,6] reaction forces at fixed DOFs (0 elsewhere)
    compliance: float       # f_total . u  (external work, lattice_opti.py:645)
    energy: float           # 1/2 u^T K u
    iterations: int
    residual: float


class StaticProblem:
    """Device-ready static problem: operator + BC tensors.  ``radius`` may
    be a tensor that requires grad (``solve(differentiable=True)``)."""

    def __init__(self, nodes, edges, radius, E, nu, bc: BCArrays,
                 n_original_nodes: int, dtype=torch.float64, device="cuda"):
        N = len(nodes)
        self.n_original_nodes = n_original_nodes
        self.op = build_operator(nodes, edges, radius, E, nu, dtype=dtype,
                                 device=device)
        fdt, dev = self.op.geom.L.dtype, self.op.geom.L.device
        free = np.ones((N, 6), dtype=bool)
        free[:bc.fixed.shape[0]] &= ~bc.fixed
        u_imp = np.zeros((N, 6)); u_imp[:bc.fixed.shape[0]] = bc.u_imposed
        f_app = np.zeros((N, 6)); f_app[:bc.fixed.shape[0]] = bc.f_applied
        as_t = lambda a: torch.as_tensor(a, dtype=fdt, device=dev)
        self.free = as_t(free)
        self.u_imposed = as_t(u_imp)
        self.f_applied = as_t(f_app)

    def _field(self, a) -> torch.Tensor:
        """A field set by the caller (a tensor or an array) on the
        operator's device and dtype."""
        L = self.op.geom.L
        return torch.as_tensor(a, dtype=L.dtype, device=L.device)

    def solve(self, tol: float = 1e-12, maxiter: int = 20000,
              differentiable: bool = False):
        op, free = self.op, self.free
        u_imp, f_app = self._field(self.u_imposed), self._field(self.f_applied)
        A = masked_operator(op, free)
        # rhs: applied forces minus coupling to imposed displacements on free
        # dofs; imposed values on fixed dofs (so A u = b has u = u_imp there)
        b = free * (f_app - op.matvec(u_imp)) + (1.0 - free) * u_imp
        diag = free * op.diagonal() + (1.0 - free)
        safe = torch.where(diag == 0, torch.ones_like(diag), diag)
        M = lambda r: r / safe
        if differentiable:
            u_free = linear_solve(A, b, M=M, maxiter=maxiter, tol=tol)
            it = -1
            res = torch.tensor(float("nan"), dtype=b.dtype, device=b.device)
        else:
            out = pcg(A, b, M=M, maxiter=maxiter, tol=tol)
            u_free, it, res = out.x, out.iterations, out.residual_norm
        u = free * u_free + (1.0 - free) * u_imp
        return u, it, res


def make_problem(lattice: Lattice, material: Optional[MatProperties] = None,
                 bc: Optional[BCArrays] = None, subdivide_h: Optional[float] = None,
                 radius: Optional[np.ndarray] = None, penalization: bool = False,
                 periodicity: Optional[bool] = None, dtype=torch.float64,
                 device="cuda") -> StaticProblem:
    mat = material or MatProperties(lattice.config.material_name())
    bc = bc or apply_boundary_conditions(lattice)
    nodes, edges = lattice.nodes, lattice.edges
    rad = lattice.radius if radius is None else np.asarray(radius)
    if penalization:
        from ..sim.penalization import penalize_edges
        if periodicity is None:
            periodicity = bool((lattice.config.simulation or {}).get("periodicity", False))
        pen = penalize_edges(nodes, edges, rad, periodicity=periodicity)
        nodes, edges, rad = pen.nodes, pen.edges, pen.radius
    if subdivide_h is not None:
        nodes, edges, parent, rad = subdivide_edges(nodes, edges, subdivide_h,
                                                    edge_data=(rad,))
    return StaticProblem(nodes, edges, rad, mat.young_modulus, mat.poisson_ratio,
                         bc, n_original_nodes=lattice.num_nodes, dtype=dtype,
                         device=device)


@timing.timeit(category="simulation")
def solve_fem(lattice: Lattice, material: Optional[MatProperties] = None,
              bc: Optional[BCArrays] = None, subdivide_h: Optional[float] = None,
              tol: float = 1e-12, maxiter: int = 20000,
              penalization: bool = False, dtype=torch.float64,
              device="cuda") -> FEMResult:
    """End-to-end linear static solve of the lattice under its config BCs."""
    bc = bc or apply_boundary_conditions(lattice)
    prob = make_problem(lattice, material, bc, subdivide_h,
                        penalization=penalization, dtype=dtype, device=device)
    u, it, res = prob.solve(tol=tol, maxiter=maxiter)
    Ku = prob.op.matvec(u)
    fixed = 1.0 - prob.free
    reaction = fixed * (Ku - prob.f_applied)
    f_total = prob.f_applied + reaction
    compliance = torch.sum(f_total * u)
    energy = prob.op.strain_energy(u)
    n0 = lattice.num_nodes
    return FEMResult(
        u=u[:n0].cpu().numpy(),
        reaction=reaction[:n0].cpu().numpy(),
        compliance=float(compliance),
        energy=float(energy),
        iterations=int(it),
        residual=float(res),
    )
