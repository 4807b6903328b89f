"""Vectorized boundary tagging of lattice nodes.

Tag codes follow the reference's convention (point.py:169-235): faces 10-15,
edges 100-111, corners 1000-1007, interior -> no tag (0 here).  Comparisons
are exact (``==``) against the bounding box, matching the reference's
float-equality semantics — node coordinates are generated by identical
arithmetic on host, so exact matches are reproducible.
"""

from __future__ import annotations

import numpy as np

__all__ = ["tag_points", "FACE_TAGS", "EDGE_TAGS", "CORNER_TAGS"]

# (on_xmin, on_xmax, on_ymin, on_ymax, on_zmin, on_zmax) -> tag
FACE_TAGS = {
    (1, 0, 0, 0, 0, 0): 12, (0, 1, 0, 0, 0, 0): 13,
    (0, 0, 1, 0, 0, 0): 11, (0, 0, 0, 1, 0, 0): 14,
    (0, 0, 0, 0, 1, 0): 10, (0, 0, 0, 0, 0, 1): 15,
}
EDGE_TAGS = {
    (1, 0, 1, 0, 0, 0): 102, (0, 0, 1, 0, 1, 0): 100, (0, 1, 1, 0, 0, 0): 104,
    (0, 0, 1, 0, 0, 1): 108, (1, 0, 0, 0, 1, 0): 101, (0, 1, 0, 0, 1, 0): 103,
    (1, 0, 0, 1, 0, 0): 106, (0, 0, 0, 1, 1, 0): 105, (0, 1, 0, 1, 0, 0): 107,
    (0, 0, 0, 1, 0, 1): 111, (1, 0, 0, 0, 0, 1): 109, (0, 1, 0, 0, 0, 1): 110,
}
CORNER_TAGS = {
    (1, 0, 1, 0, 1, 0): 1000, (0, 1, 1, 0, 1, 0): 1001, (1, 0, 0, 1, 1, 0): 1002,
    (0, 1, 0, 1, 1, 0): 1003, (1, 0, 1, 0, 0, 1): 1004, (0, 1, 1, 0, 0, 1): 1005,
    (1, 0, 0, 1, 0, 1): 1006, (0, 1, 0, 1, 0, 1): 1007,
}

_ALL_TAGS = {**FACE_TAGS, **EDGE_TAGS, **CORNER_TAGS}

# Lookup table indexed by the 6-bit on-plane pattern
_LUT = np.zeros(64, dtype=np.int32)
for pattern, tag in _ALL_TAGS.items():
    bit = sum(b << i for i, b in enumerate(pattern))
    _LUT[bit] = tag


def tag_points(coords: np.ndarray, bbox) -> np.ndarray:
    """Boundary tag per point (0 = interior / untagged).

    ``bbox`` = [xmin, xmax, ymin, ymax, zmin, zmax]; equality is exact, as in
    the reference's tag_point.
    """
    coords = np.asarray(coords)
    xmin, xmax, ymin, ymax, zmin, zmax = bbox
    on = np.stack([
        coords[:, 0] == xmin, coords[:, 0] == xmax,
        coords[:, 1] == ymin, coords[:, 1] == ymax,
        coords[:, 2] == zmin, coords[:, 2] == zmax,
    ], axis=1)
    bits = (on.astype(np.int32) * (1 << np.arange(6, dtype=np.int32))).sum(axis=1)
    return _LUT[bits]
