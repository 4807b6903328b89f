"""Deterministic boundary-node ordering for cell condensation.

Mirrors Cell.define_node_order_to_simulate (cell.py:611-680): every boundary
node is assigned to exactly one face by the priority
[Xmin, Xmax, Ymin, Ymax, Zmin, Zmax], then sorted within each face bucket by
its two in-plane coordinates.  The resulting node order fixes the row/column
layout of cell Schur complements (6 DOFs per node: u_x u_y u_z th_x th_y
th_z).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["boundary_node_order", "boundary_nodes_of_cell"]

_FACE_PRIORITY = ("Xmin", "Xmax", "Ymin", "Ymax", "Zmin", "Zmax")


def boundary_nodes_of_cell(coords: np.ndarray, bbox: Sequence[float],
                           tol: float = 1e-9) -> np.ndarray:
    """Indices (into coords) of nodes on the cell bounding box."""
    x0, x1, y0, y1, z0, z1 = bbox
    on = (
        (np.abs(coords[:, 0] - x0) <= tol) | (np.abs(coords[:, 0] - x1) <= tol) |
        (np.abs(coords[:, 1] - y0) <= tol) | (np.abs(coords[:, 1] - y1) <= tol) |
        (np.abs(coords[:, 2] - z0) <= tol) | (np.abs(coords[:, 2] - z1) <= tol)
    )
    return np.nonzero(on)[0]


def boundary_node_order(coords: np.ndarray, bbox: Sequence[float],
                        candidates: np.ndarray = None, tol: float = 1e-9) -> np.ndarray:
    """Order ``candidates`` (default: all boundary nodes) by face priority.

    Returns node indices in simulation order.
    """
    if candidates is None:
        candidates = boundary_nodes_of_cell(coords, bbox, tol)
    x0, x1, y0, y1, z0, z1 = bbox
    p = coords[candidates]
    on_face = {
        "Xmin": np.abs(p[:, 0] - x0) <= tol, "Xmax": np.abs(p[:, 0] - x1) <= tol,
        "Ymin": np.abs(p[:, 1] - y0) <= tol, "Ymax": np.abs(p[:, 1] - y1) <= tol,
        "Zmin": np.abs(p[:, 2] - z0) <= tol, "Zmax": np.abs(p[:, 2] - z1) <= tol,
    }
    assigned = np.zeros(len(candidates), dtype=bool)
    ordered = []
    for face in _FACE_PRIORITY:
        sel = on_face[face] & ~assigned
        idx = np.nonzero(sel)[0]
        if idx.size == 0:
            continue
        assigned[idx] = True
        q = p[idx]
        if face[0] == "X":
            key = (q[:, 0], q[:, 2], q[:, 1])   # lexsort: last key primary -> (y, z, x)
        elif face[0] == "Y":
            key = (q[:, 1], q[:, 2], q[:, 0])   # (x, z, y)
        else:
            key = (q[:, 2], q[:, 1], q[:, 0])   # (x, y, z)
        ordered.append(candidates[idx[np.lexsort(key)]])
    if not ordered:
        return np.array([], dtype=np.int64)
    return np.concatenate(ordered)
