"""Boundary-condition engine: config block -> per-node DOF arrays.

Replicates the reference's surface-driven BC application
(lattice_sim.py:405-494): each named condition selects nodes as the
intersection of ordered lattice-surface filters, then either pins DOFs to a
displacement value or distributes a total force equally over the target DOFs
that are still free at application time.  Conditions apply in JSON order, so
Displacement-before-Force interactions match the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..config import DOF_NAMES
from ..design.lattice import Lattice

__all__ = ["BCArrays", "apply_boundary_conditions"]


@dataclass
class BCArrays:
    """Per-node, per-DOF boundary state (host numpy; device-ready shapes)."""
    fixed: np.ndarray       # [N,6] bool — Dirichlet mask
    u_imposed: np.ndarray   # [N,6] imposed displacement values (0 where free)
    f_applied: np.ndarray   # [N,6] applied nodal forces

    @property
    def free(self) -> np.ndarray:
        return ~self.fixed

    @property
    def n_free_dof(self) -> int:
        return int(self.free.sum())


def apply_boundary_conditions(lattice: Lattice,
                              boundary_conditions: Optional[Dict] = None) -> BCArrays:
    """Evaluate a ``boundary_conditions`` config block into arrays."""
    bc = boundary_conditions if boundary_conditions is not None \
        else (lattice.config.boundary_conditions or {})
    N = lattice.num_nodes
    fixed = np.zeros((N, 6), dtype=bool)
    u_imposed = np.zeros((N, 6), dtype=np.float64)
    f_applied = np.zeros((N, 6), dtype=np.float64)

    for kind, conditions in bc.items():
        if kind not in ("Force", "Displacement"):
            raise ValueError(f"Invalid boundary condition type: {kind}.")
        for name, data in conditions.items():
            dofs = [DOF_NAMES[d] for d in data["DOF"]]
            values = data["Value"]
            nodes = lattice.find_nodes_on_surface(data["Surface"],
                                                  data.get("SurfaceCells"))
            if kind == "Displacement":
                for val, d in zip(values, dofs):
                    u_imposed[nodes, d] = val
                    fixed[nodes, d] = True
            else:
                # split the total force over currently-free target DOFs
                # (lattice_sim.py:432-457); the per-node share is still
                # written to every target node, matching the reference
                for val, d in zip(values, dofs):
                    n_free = max(1, int((~fixed[nodes, d]).sum()))
                    f_applied[nodes, d] = val / n_free

    return BCArrays(fixed=fixed, u_imposed=u_imposed, f_applied=f_applied)
