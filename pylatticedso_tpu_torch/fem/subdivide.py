"""Host-side beam subdivision (the graph IS the mesh).

The reference meshes every strut with gmsh at target element length
``0.05 * cell_size_x`` (lattice_generation.py:50-60, beam_model.py:127-141),
so each beam becomes ~L/h collinear elements.  Here subdivision is a pure
array transform: new interior nodes are appended after the original ones
(originals keep their indices, so BC/tag arrays extend with zeros).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = ["subdivide_edges", "segment_counts"]


def segment_counts(lengths: np.ndarray, target_h: float) -> np.ndarray:
    """Number of elements per beam for a target element size.

    gmsh's 1D meshing of a straight line with uniform size field produces
    ceil(L/h) intervals (at least 1) — calibrated to machine precision
    against the reference's committed PETSc Schur artifacts
    (data/outputs/schur_complement/*.npz).
    """
    return np.maximum(1, np.ceil(lengths / target_h)).astype(np.int64)


def subdivide_edges(nodes: np.ndarray, edges: np.ndarray, target_h: Optional[float] = None,
                    n_segments: Optional[np.ndarray] = None,
                    edge_data: Tuple[np.ndarray, ...] = ()) -> tuple:
    """Split each edge into collinear segments.

    Returns (new_nodes, new_edges, parent_edge, *(edge_data replicated)).
    ``parent_edge[j]`` is the original edge index of segment j (for mapping
    per-beam quantities like radius to segments and summing gradients back).
    """
    lengths = np.linalg.norm(nodes[edges[:, 1]] - nodes[edges[:, 0]], axis=1)
    if n_segments is None:
        if target_h is None:
            raise ValueError("pass target_h or n_segments")
        n_segments = segment_counts(lengths, target_h)
    n_segments = np.asarray(n_segments, dtype=np.int64)

    E = len(edges)
    new_pts = []
    new_edges = []
    parent = []
    next_id = len(nodes)
    for e in range(E):
        n = int(n_segments[e])
        a, b = int(edges[e, 0]), int(edges[e, 1])
        if n <= 1:
            new_edges.append((a, b))
            parent.append(e)
            continue
        pa, pb = nodes[a], nodes[b]
        ts = np.arange(1, n) / n
        mids = pa[None, :] + ts[:, None] * (pb - pa)[None, :]
        ids = [a] + list(range(next_id, next_id + n - 1)) + [b]
        next_id += n - 1
        new_pts.append(mids)
        for i in range(n):
            new_edges.append((ids[i], ids[i + 1]))
            parent.append(e)

    all_nodes = np.concatenate([nodes] + new_pts) if new_pts else nodes.copy()
    new_edges = np.asarray(new_edges, dtype=edges.dtype)
    parent = np.asarray(parent, dtype=np.int64)
    out = [all_nodes, new_edges, parent]
    for arr in edge_data:
        out.append(np.asarray(arr)[parent])
    return tuple(out)
