"""Design transforms: coordinate maps applied to the node array.

Vectorized equivalents of the reference's per-Point loops
(design_transformation.py:13-206): point-attractor warp, curvature warp,
cylindrical wrap (stents), cylinder-form bending, and fit-to-surface.  Each
transform mutates ``lattice.nodes`` in place and re-derives boundary tags.
The cylindrical wrap also merges the seam nodes (y = 0 with y = y_max) and
deduplicates the resulting coincident beams — the step the reference calls
through a method that does not exist (`delete_duplicated_beams`,
design_transformation.py:127, a latent crash not reproduced here).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from .tags import tag_points

__all__ = ["attractor_lattice", "curve_lattice", "cylindrical_transform",
           "move_to_cylinder_form", "fit_to_surface"]


def _refresh(lattice) -> None:
    mins, maxs = lattice.nodes.min(axis=0), lattice.nodes.max(axis=0)
    bbox = [mins[0], maxs[0], mins[1], maxs[1], mins[2], maxs[2]]
    lattice.node_tag = tag_points(lattice.nodes, bbox)


def _record(lattice, fn: Callable) -> None:
    """Record a topology-preserving pointwise map f(x, y, z) -> (x, y, z)
    so the structured stencil path can rebuild the warped geometry as
    per-instance fields (parallel/structured.py node_transform) instead of
    falling back to the general-graph operator.  Also snapshots the
    pre-transform coordinates once — the structured optimizer maps nodes
    onto the class grids in UNWARPED coordinates (exact arithmetic on both
    sides, no float-roundtrip through the composed map)."""
    tfs = getattr(lattice, "node_transforms", [])
    if tfs is None:         # poisoned by a topology-changing transform
        return
    if not tfs:
        lattice.nodes_pre_transform = lattice.nodes.copy()
    lattice.node_transforms = list(tfs) + [fn]


def _poison(lattice) -> None:
    """Mark the lattice as NOT representable by a pointwise map (topology
    changed, e.g. a seam merge): the structured path must decline it."""
    lattice.node_transforms = None


def attractor_lattice(lattice, point_attractor: Sequence[float] = (5.0, 0.5, -2.0),
                      alpha: float = 0.5, inverse: bool = False) -> None:
    """Pull every node toward (or away from) an attractor point."""
    p = np.asarray(point_attractor, dtype=float)

    def _map(x, y, z, p=p, alpha=alpha, inverse=inverse):
        dx, dy, dz = p[0] - x, p[1] - y, p[2] - z
        L = np.sqrt(dx * dx + dy * dy + dz * dz)
        if inverse:
            factor = np.where(L != 0, alpha / np.where(L == 0, 1, L), alpha)
        else:
            factor = alpha * L
        return x + dx * factor, y + dy * factor, z + dz * factor

    _record(lattice, _map)
    d = p[None, :] - lattice.nodes
    L = np.linalg.norm(d, axis=1)
    if inverse:
        factor = np.where(L != 0, alpha / np.where(L == 0, 1, L), alpha)
    else:
        factor = alpha * L
    lattice.nodes = lattice.nodes + d * factor[:, None]
    _refresh(lattice)


def curve_lattice(lattice, center: Sequence[float],
                  curvature_strength: float = 0.1) -> None:
    """Quadratic curvature warp of z around a center point."""
    c = np.asarray(center, dtype=float)

    def _map(x, y, z, c=c, k=curvature_strength):
        d2 = (x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2
        return x, y, z - k * d2

    _record(lattice, _map)
    d2 = np.sum((lattice.nodes - c[None, :])**2, axis=1)
    lattice.nodes = lattice.nodes.copy()
    lattice.nodes[:, 2] -= curvature_strength * d2
    _refresh(lattice)


def cylindrical_transform(lattice, radius: float, merge_seam: bool = True) -> None:
    """Wrap the lattice sheet around a cylinder (stent generator).

    y in [0, height] maps to theta in [0, 2 pi); nodes at y = height coincide
    with y = 0 and are merged, and beams collapsing onto existing beams are
    deduplicated.
    """
    nodes = lattice.nodes.copy()
    max_y = lattice.size_lattice[1]

    def _map(x, y, z, radius=radius, max_y=float(max_y)):
        th = (y / max_y) * 2.0 * np.pi
        return radius * np.cos(th), radius * np.sin(th), z

    _record(lattice, _map)   # poisoned below if the seam actually merges
    theta = (nodes[:, 1] / max_y) * 2.0 * np.pi
    nodes[:, 0] = radius * np.cos(theta)
    nodes[:, 1] = radius * np.sin(theta)
    lattice.nodes = nodes

    if merge_seam:
        keys = np.round(nodes, 9)
        uniq, first, inverse = np.unique(keys, axis=0, return_index=True,
                                         return_inverse=True)
        if len(uniq) < len(nodes):
            _poison(lattice)   # seam merge changes the graph topology
            remap = inverse  # node -> merged id (ids into uniq order)
            lattice.nodes = nodes[np.sort(first)]
            order = np.argsort(first, kind="stable")
            rank = np.empty(len(first), dtype=np.int64)
            rank[order] = np.arange(len(first))
            node_map = rank[inverse]
            edges = node_map[lattice.edges].astype(lattice.edges.dtype)
            pair = np.sort(edges, axis=1)
            _, e_first, e_inv = np.unique(pair, axis=0, return_index=True,
                                          return_inverse=True)
            sel = np.sort(e_first)
            lattice.edges = edges[sel]
            lattice.radius = lattice.radius[sel]
            lattice.edge_type = lattice.edge_type[sel]
            lattice.edge_mat = lattice.edge_mat[sel]
            lattice.edge_cell = lattice.edge_cell[sel]
            # rebuild the cell membership maps under the merge (surface
            # BC resolution needs them on the merged cylinder too)
            from .lattice import _pairs_to_csr
            C = lattice.num_cells
            if lattice.cell_node_ptr is not None:
                cells_n = np.repeat(np.arange(C),
                                    np.diff(lattice.cell_node_ptr))
                cn = np.unique(np.stack(
                    [cells_n, node_map[lattice.cell_node_idx]], 1), axis=0)
                lattice.cell_node_ptr, lattice.cell_node_idx = \
                    _pairs_to_csr(cn, C)
            if lattice.cell_edge_ptr is not None:
                e_order = np.argsort(e_first, kind="stable")
                e_rank = np.empty(len(e_first), dtype=np.int64)
                e_rank[e_order] = np.arange(len(e_first))
                edge_map = e_rank[e_inv]          # old edge -> merged edge
                cells_e = np.repeat(np.arange(C),
                                    np.diff(lattice.cell_edge_ptr))
                ce = np.unique(np.stack(
                    [cells_e, edge_map[lattice.cell_edge_idx]], 1), axis=0)
                lattice.cell_edge_ptr, lattice.cell_edge_idx = \
                    _pairs_to_csr(ce, C)
    _refresh(lattice)


def move_to_cylinder_form(lattice, radius: float) -> None:
    """Bend the sheet onto a cylinder surface along x (z drop formula)."""
    x_max = lattice.nodes[:, 0].max()
    if radius <= x_max / 2:
        raise ValueError(f"Cylinder radius too small: minimum {x_max / 2}")
    def _map(x, y, z, radius=radius, x_max=float(x_max)):
        return (x, y,
                z - (radius - np.sqrt(radius**2 - (x - x_max / 2)**2)))

    _record(lattice, _map)
    x = lattice.nodes[:, 0]
    drop = radius - np.sqrt(radius**2 - (x - x_max / 2)**2)
    lattice.nodes = lattice.nodes.copy()
    lattice.nodes[:, 2] -= drop
    _refresh(lattice)


def fit_to_surface(lattice, equation: Callable, mode: str = "z",
                   params: Optional[dict] = None) -> None:
    """Offset ("z") or project ("z_plan") nodes onto z = f(x, y)."""
    params = params or {}

    def _map(x, y, z, equation=equation, mode=mode, params=dict(params)):
        fz = np.vectorize(
            lambda a, b: equation(a, b, **params), otypes=[float])(x, y)
        return (x, y, z + fz) if mode == "z" else (x, y, fz + 0.0 * z)

    if mode in ("z", "z_plan"):
        _record(lattice, _map)
    x, y = lattice.nodes[:, 0], lattice.nodes[:, 1]
    fz = np.asarray([equation(xi, yi, **params) for xi, yi in zip(x, y)])
    lattice.nodes = lattice.nodes.copy()
    if mode == "z":
        lattice.nodes[:, 2] += fz
    elif mode == "z_plan":
        lattice.nodes[:, 2] = fz
    else:
        raise ValueError(f"Unsupported mode {mode!r}")
    _refresh(lattice)
