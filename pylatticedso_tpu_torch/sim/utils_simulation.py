"""Simulation entrypoints mirroring the reference's module-level API.

`solve_FEM_FenicsX` / `solve_FEM_cell` / `get_homogenized_properties`
(utils_simulation.py:21-121) become thin wrappers over the array pipeline:
full-lattice solve, per-cell solve (the FE^2 inner problem), unit-cell
homogenization, and the force-displacement aggregation of
`get_global_force_displacement_curve` (lattice_sim.py:1510-1552).
The port of ``pylatticedso_tpu.sim.utils_simulation``: the solves run on
``device`` (default ``"cuda"``) through the port's statics and
homogenization, and return numpy results.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..design.lattice import Lattice
from ..fem.bc import BCArrays
from ..fem.homogenization import HomogenizationResult, homogenize_cell
from ..fem.statics import FEMResult, StaticProblem, solve_fem
from ..materials import MatProperties

__all__ = ["solve_fem_lattice", "solve_fem_cell", "get_homogenized_properties",
           "force_displacement_curve"]


def solve_fem_lattice(lattice: Lattice, subdivide_h: Optional[float] = "auto",
                      **kwargs) -> FEMResult:
    """Full-scale FEM solve (solve_FEM_FenicsX parity).

    Defaults to the reference's gmsh discretization (element length
    0.05 * cell_size_x, lattice_generation.py:50-60) — a single linear
    Timoshenko element per strut is far too stiff in bending, so parity
    with reference displacement fields requires the subdivision.
    """
    if subdivide_h == "auto":
        subdivide_h = 0.05 * lattice.config.cell_size[0]
    return solve_fem(lattice, subdivide_h=subdivide_h, **kwargs)


def solve_fem_cell(lattice: Lattice, cell_index: int,
                   u_boundary: np.ndarray, material: Optional[MatProperties] = None,
                   target_h: Optional[float] = None, tol: float = 1e-12,
                   dtype=torch.float64, device="cuda") -> FEMResult:
    """FE^2 inner problem: one cell under imposed boundary displacements.

    ``u_boundary``: [n_b, 6] displacements at the cell's boundary nodes in
    simulation (face-priority) order — the Dirichlet data a DDM iteration
    hands to the cell (solve_FEM_cell, utils_simulation.py:58-81).
    Returns the cell solve; its boundary reactions are the S u product the
    Schur path computes algebraically.
    """
    from ..sim.boundary_order import boundary_node_order

    mat = material or MatProperties(lattice.config.material_name())
    c = cell_index
    eids = lattice.cell_edge_idx[lattice.cell_edge_ptr[c]:lattice.cell_edge_ptr[c + 1]]
    nids = lattice.cell_node_idx[lattice.cell_node_ptr[c]:lattice.cell_node_ptr[c + 1]]
    remap = -np.ones(lattice.num_nodes, dtype=np.int64)
    remap[nids] = np.arange(len(nids))
    nodes = lattice.nodes[nids]
    edges = remap[lattice.edges[eids]].astype(np.int32)
    radius = lattice.radius[eids]
    o, s = lattice.cell_origin[c], lattice.cell_size[c]
    bbox = [o[0], o[0] + s[0], o[1], o[1] + s[1], o[2], o[2] + s[2]]
    b_local = boundary_node_order(nodes, bbox)

    N = len(nodes)
    fixed = np.zeros((N, 6), dtype=bool)
    u_imp = np.zeros((N, 6))
    fixed[b_local] = True
    u_imp[b_local] = np.asarray(u_boundary)
    bc = BCArrays(fixed=fixed, u_imposed=u_imp, f_applied=np.zeros((N, 6)))

    if target_h is not None:
        from ..fem.subdivide import subdivide_edges
        nodes, edges, parent, radius = subdivide_edges(nodes, edges, target_h,
                                                       edge_data=(radius,))
    prob = StaticProblem(nodes, edges, radius, mat.young_modulus,
                         mat.poisson_ratio, bc, n_original_nodes=len(nids),
                         dtype=dtype, device=device)
    u, it, res = prob.solve(tol=tol)
    Ku = prob.op.matvec(u)
    reaction = (1.0 - prob.free) * Ku
    return FEMResult(u=u.cpu().numpy()[:len(nids)],
                     reaction=reaction.cpu().numpy()[:len(nids)],
                     compliance=float(torch.sum(reaction * u)),
                     energy=float(prob.op.strain_energy(u)),
                     iterations=int(it), residual=float(res))


def get_homogenized_properties(lattice: Lattice, **kwargs) -> HomogenizationResult:
    """Unit-cell homogenization (utils_simulation.py:83-121 asserts 1 cell)."""
    if lattice.num_cells != 1:
        raise ValueError("The lattice must contain exactly one cell for "
                         "homogenization.")
    return homogenize_cell(lattice, **kwargs)


def force_displacement_curve(lattice: Lattice, result: FEMResult, bc: BCArrays,
                             dof: int = 2) -> Tuple[np.ndarray, float]:
    """(imposed displacements at BC nodes, total |reaction|) on one DOF —
    the experiment-comparison aggregate of lattice_sim.py:1510-1552."""
    has_bc = bc.fixed.any(axis=1) | (bc.f_applied != 0).any(axis=1)
    disp = np.asarray(result.u)[has_bc, dof]
    force = float(np.abs(np.asarray(result.reaction)[has_bc, dof]).sum())
    return disp, force
