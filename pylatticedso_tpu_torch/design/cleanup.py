"""Graph maintenance transforms on the lattice arrays.

Vectorized equivalents of the reference's topology-cleanup methods:
``merge_degree2_nodes`` (lattice.py:1451-1616: collapse collinear chains
through degree-2 nodes), ``delete_unconnected_beams`` (lattice.py:1618-1692:
iteratively prune leaf beams touching degree<=1 nodes, protecting fixed or
loaded nodes), and ``delete_beams_under_radius_threshold``
(lattice.py:583-600).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["merge_degree2_nodes", "delete_unconnected_beams",
           "delete_beams_under_radius_threshold"]


def _apply_edge_selection(lattice, keep: np.ndarray) -> None:
    lattice.edges = lattice.edges[keep]
    lattice.radius = lattice.radius[keep]
    lattice.edge_type = lattice.edge_type[keep]
    lattice.edge_mat = lattice.edge_mat[keep]
    lattice.edge_cell = lattice.edge_cell[keep]
    lattice.cell_edge_ptr = lattice.cell_edge_idx = None
    lattice.cell_node_ptr = lattice.cell_node_idx = None


def _compact_nodes(lattice) -> int:
    """Drop nodes not referenced by any edge; returns number removed."""
    used = np.zeros(lattice.num_nodes, dtype=bool)
    used[lattice.edges.reshape(-1)] = True
    if used.all():
        return 0
    remap = -np.ones(lattice.num_nodes, dtype=np.int64)
    remap[used] = np.arange(used.sum())
    lattice.nodes = lattice.nodes[used]
    lattice.node_tag = lattice.node_tag[used]
    lattice.edges = remap[lattice.edges].astype(lattice.edges.dtype)
    return int((~used).sum())


def merge_degree2_nodes(lattice, colinear_only: bool = True,
                        radius_strategy: str = "inherit",
                        iterative: bool = True, max_passes: int = 10,
                        tol: float = 1e-9) -> int:
    """Collapse chains a-m-b where m has exactly two (collinear) beams."""
    total = 0
    for _ in range(max_passes if iterative else 1):
        E = lattice.num_edges
        deg = np.bincount(lattice.edges.reshape(-1), minlength=lattice.num_nodes)
        merged_this_pass = 0
        # adjacency for degree-2 nodes
        cand = np.nonzero(deg == 2)[0]
        if cand.size == 0:
            break
        # incident edge list per node
        order = np.argsort(lattice.edges.reshape(-1), kind="stable")
        flat = lattice.edges.reshape(-1)
        starts = np.searchsorted(flat[order], cand)
        edge_of_slot = order // 2
        removed = np.zeros(E, dtype=bool)
        new_edges = []
        new_data = []
        for idx, m in zip(starts, cand):
            e1, e2 = edge_of_slot[idx], edge_of_slot[idx + 1]
            if removed[e1] or removed[e2] or e1 == e2:
                continue
            a = lattice.edges[e1, 0] if lattice.edges[e1, 1] == m else lattice.edges[e1, 1]
            b = lattice.edges[e2, 0] if lattice.edges[e2, 1] == m else lattice.edges[e2, 1]
            if a == b:
                continue
            if colinear_only:
                va = lattice.nodes[m] - lattice.nodes[a]
                vb = lattice.nodes[b] - lattice.nodes[m]
                cr = np.cross(va, vb)
                if np.dot(cr, cr) > tol * max(np.dot(va, va), np.dot(vb, vb)):
                    continue
                if np.dot(va, vb) <= 0:
                    continue
            r1, r2 = lattice.radius[e1], lattice.radius[e2]
            r = {"inherit": r1, "max": max(r1, r2), "min": min(r1, r2),
                 "avg": 0.5 * (r1 + r2)}[radius_strategy]
            removed[e1] = removed[e2] = True
            new_edges.append((min(a, b), max(a, b)))
            new_data.append((r, lattice.edge_type[e1], lattice.edge_mat[e1],
                             lattice.edge_cell[e1]))
            merged_this_pass += 1
        if merged_this_pass == 0:
            break
        keep = ~removed
        ne = np.asarray(new_edges, dtype=lattice.edges.dtype)
        nd = np.asarray(new_data)
        lattice.edges = np.concatenate([lattice.edges[keep], ne])
        lattice.radius = np.concatenate([lattice.radius[keep], nd[:, 0]])
        lattice.edge_type = np.concatenate(
            [lattice.edge_type[keep], nd[:, 1].astype(lattice.edge_type.dtype)])
        lattice.edge_mat = np.concatenate(
            [lattice.edge_mat[keep], nd[:, 2].astype(lattice.edge_mat.dtype)])
        lattice.edge_cell = np.concatenate(
            [lattice.edge_cell[keep], nd[:, 3].astype(lattice.edge_cell.dtype)])
        lattice.cell_edge_ptr = lattice.cell_edge_idx = None
        lattice.cell_node_ptr = lattice.cell_node_idx = None
        total += merged_this_pass
    _compact_nodes(lattice)
    return total


def delete_unconnected_beams(lattice, protect_nodes: Optional[np.ndarray] = None,
                             also_delete_orphan_nodes: bool = True,
                             max_passes: int = 100) -> Tuple[int, int]:
    """Iteratively remove leaf beams (an endpoint of degree <= 1).

    ``protect_nodes``: boolean mask of nodes whose beams survive (the
    reference protects fixed/loaded nodes).
    """
    protect = np.zeros(lattice.num_nodes, dtype=bool) if protect_nodes is None \
        else np.asarray(protect_nodes, dtype=bool)
    n_removed = 0
    for _ in range(max_passes):
        deg = np.bincount(lattice.edges.reshape(-1), minlength=lattice.num_nodes)
        leaf_node = (deg <= 1) & ~protect
        kill = leaf_node[lattice.edges[:, 0]] | leaf_node[lattice.edges[:, 1]]
        if not kill.any():
            break
        n_removed += int(kill.sum())
        _apply_edge_selection(lattice, ~kill)
    n_nodes_removed = _compact_nodes(lattice) if also_delete_orphan_nodes else 0
    return n_removed, n_nodes_removed


def delete_beams_under_radius_threshold(lattice, threshold: float = 0.01) -> int:
    """Remove beams with radius <= threshold (+ orphan nodes)."""
    keep = lattice.radius > threshold
    n = int((~keep).sum())
    if n:
        _apply_edge_selection(lattice, keep)
        _compact_nodes(lattice)
    return n
