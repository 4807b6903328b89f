"""Unit-cell topology catalog.

Re-implements the reference's 18-geometry JSON catalog
(`pyLatticeDesign/geometries/*.json`, loaded by
`geometries_utils.get_beam_structure`, geometries_utils.py:41-88) as constructive
generators.  Each topology is a set of beams given as rows
``[x1, y1, z1, x2, y2, z2]`` in unit-cube fractions, exactly the array the
reference parses out of JSON.  Construction here is programmatic (corners,
face centers, edge midpoints, tetrahedral sites ...) instead of literal
coordinate dumps, but evaluates to the same beam sets.

User-supplied geometry JSON files (with optional symbolic parameters) are
still supported through :func:`load_geometry_json`, mirroring the reference's
sympy-evaluated schema (geometries_utils.py:26-38).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Union

import numpy as np

__all__ = [
    "get_beam_structure",
    "available_geometries",
    "register_geometry",
    "load_geometry_json",
]

# ---------------------------------------------------------------------------
# Geometric primitives of the unit cube
# ---------------------------------------------------------------------------

_CORNERS = np.array(
    [[x, y, z] for x in (0.0, 1.0) for y in (0.0, 1.0) for z in (0.0, 1.0)]
)
_CENTER = np.array([0.5, 0.5, 0.5])

# One face center per cube face: (axis, side) -> coordinate
_FACE_CENTERS = np.array(
    [
        [0.0, 0.5, 0.5], [1.0, 0.5, 0.5],
        [0.5, 0.0, 0.5], [0.5, 1.0, 0.5],
        [0.5, 0.5, 0.0], [0.5, 0.5, 1.0],
    ]
)

# 12 edge midpoints of the cube
_EDGE_MIDPOINTS = np.array(
    [
        [0.5, y, z] for y in (0.0, 1.0) for z in (0.0, 1.0)
    ] + [
        [x, 0.5, z] for x in (0.0, 1.0) for z in (0.0, 1.0)
    ] + [
        [x, y, 0.5] for x in (0.0, 1.0) for y in (0.0, 1.0)
    ]
)

# 8 tetrahedral interior sites (corners pulled 1/4 toward the center)
_TETRA_SITES = np.array(
    [[x, y, z] for x in (0.25, 0.75) for y in (0.25, 0.75) for z in (0.25, 0.75)]
)


def _beams(pairs: Sequence[tuple]) -> np.ndarray:
    """Stack (p1, p2) point pairs into an [n, 6] beam array."""
    return np.array([list(p1) + list(p2) for p1, p2 in pairs], dtype=np.float64)


def _connect_by_distance(points_a, points_b, dist, tol=1e-9) -> np.ndarray:
    """All beams between points of a and b at euclidean distance ``dist``.

    When a is b, each unordered pair is emitted once.
    """
    a = np.asarray(points_a, dtype=np.float64)
    b = np.asarray(points_b, dtype=np.float64)
    same = a is points_b or (a.shape == b.shape and np.array_equal(a, b))
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    ii, jj = np.nonzero(np.abs(d - dist) < tol)
    if same:
        keep = ii < jj
        ii, jj = ii[keep], jj[keep]
    return np.concatenate([a[ii], b[jj]], axis=1)


def _nearest_corner(p: np.ndarray) -> np.ndarray:
    return np.round(p)


# ---------------------------------------------------------------------------
# Topology constructors
# ---------------------------------------------------------------------------

def _bcc() -> np.ndarray:
    """Body-centered cubic: center connected to all 8 corners."""
    return _beams([(_CENTER, c) for c in _CORNERS])


def _bccz() -> np.ndarray:
    """BCC plus two vertical half-struts along Z through the center."""
    extra = _beams([
        ([0.5, 0.5, 0.0], _CENTER),
        (_CENTER, [0.5, 0.5, 1.0]),
    ])
    return np.concatenate([_bcc(), extra])


def _cubic() -> np.ndarray:
    """The 12 edges of the unit cube."""
    return _connect_by_distance(_CORNERS, _CORNERS, 1.0)


def _octet() -> np.ndarray:
    """Octet truss: face-center-to-corner struts + octahedron edges."""
    return np.concatenate([_octet_ext(), _octahedron()])


def _octet_ext() -> np.ndarray:
    """Only the boundary (face-center to corner) struts of the octet truss."""
    return _connect_by_distance(_CORNERS, _FACE_CENTERS, math.sqrt(2.0) / 2.0)


def _octahedron() -> np.ndarray:
    """The 12 edges of the inscribed octahedron (face center to face center)."""
    return _connect_by_distance(_FACE_CENTERS, _FACE_CENTERS, math.sqrt(2.0) / 2.0)


def _octahedron_z() -> np.ndarray:
    """Octahedron plus a Z strut between bottom and top face centers."""
    extra = _beams([([0.5, 0.5, 0.0], [0.5, 0.5, 1.0])])
    return np.concatenate([_octahedron(), extra])


def _octahedron_yz() -> np.ndarray:
    """Octahedron plus struts from every face center to the body center."""
    extra = _beams([(fc, _CENTER) for fc in _FACE_CENTERS])
    return np.concatenate([_octahedron(), extra])


def _kelvin() -> np.ndarray:
    """Kelvin cell (truncated octahedron).

    Vertices are the 24 permutations of (0, 1/4, 1/2) about the cell center;
    every edge of the truncated octahedron has length sqrt(2)/4, so the edge
    set is exactly the pairs at that distance.
    """
    verts = []
    for ax in range(3):
        for side in (0.0, 1.0):
            for off_ax in range(3):
                if off_ax == ax:
                    continue
                for s in (0.25, 0.75):
                    v = [0.5, 0.5, 0.5]
                    v[ax] = side
                    v[off_ax] = s
                    verts.append(v)
    verts = np.unique(np.array(verts, dtype=np.float64), axis=0)
    return _connect_by_distance(verts, verts, math.sqrt(2.0) / 4.0)


def _diamond() -> np.ndarray:
    """Diamond cubic: each tetrahedral site bonds its 4 nearest FCC sites."""
    fcc = np.concatenate([_CORNERS, _FACE_CENTERS])
    return _connect_by_distance(_TETRA_SITES, fcc, math.sqrt(3.0) / 4.0)


def _original() -> np.ndarray:
    """Each tetrahedral site connects to its nearest corner and the 3 edge
    midpoints adjacent to that corner."""
    pairs = []
    for p in _TETRA_SITES:
        c = _nearest_corner(p)
        pairs.append((p, c))
        for ax in range(3):
            m = c.copy()
            m[ax] = 0.5
            pairs.append((p, m))
    return _beams(pairs)


def _original2() -> np.ndarray:
    """BCC plus, on every face, struts from the face's 8 boundary points
    (4 corners + 4 edge midpoints) to the face center."""
    pairs = []
    boundary = np.concatenate([_CORNERS, _EDGE_MIDPOINTS])
    for fc in _FACE_CENTERS:
        ax = int(np.argmax(np.abs(fc - 0.5)))
        on_face = boundary[np.abs(boundary[:, ax] - fc[ax]) < 1e-12]
        pairs.extend((p, fc) for p in on_face)
    return np.concatenate([_bcc(), _beams(pairs)])


def _hybrid1() -> np.ndarray:
    """Original without the corner struts: tetra sites to 3 edge midpoints."""
    pairs = []
    for p in _TETRA_SITES:
        c = _nearest_corner(p)
        for ax in range(3):
            m = c.copy()
            m[ax] = 0.5
            pairs.append((p, m))
    return _beams(pairs)


def _hybrid2() -> np.ndarray:
    """Body center connected to all 12 edge midpoints."""
    return _beams([(m, _CENTER) for m in _EDGE_MIDPOINTS])


def _hybrid3() -> np.ndarray:
    """Each tetrahedral site connects to its 3 nearest face centers."""
    return _connect_by_distance(_TETRA_SITES, _FACE_CENTERS, math.sqrt(2.0) / 4.0 * math.sqrt(1.5))


def _hybrid4() -> np.ndarray:
    """Hybrid3 plus struts from every face center to the body center."""
    extra = _beams([(fc, _CENTER) for fc in _FACE_CENTERS])
    return np.concatenate([_hybrid3(), extra])


def _hybrid5() -> np.ndarray:
    """Inner octahedron points (center +- 1/4 on each axis), each connected to
    the body center and to the 4 corners of its nearest face."""
    pairs = []
    for ax in range(3):
        for s in (-0.25, 0.25):
            p = _CENTER.copy()
            p[ax] += s
            pairs.append((p, _CENTER))
            face_val = 0.0 if s < 0 else 1.0
            for c in _CORNERS:
                if c[ax] == face_val:
                    pairs.append((p, c))
    return _beams(pairs)


def _auxetic(hgeom: float = 0.35, angle_deg: float = 20.0) -> np.ndarray:
    """Re-entrant (auxetic) frame on the four lateral faces of the cube.

    ``val = hgeom - tan(angle)/2`` sets the re-entrant kink height, matching
    the reference's symbolic parameters (Auxetic.json).
    """
    val = hgeom - math.tan(math.radians(angle_deg)) / 2.0
    pairs = []

    def face_pattern(fixed_axis: int, fixed_val: float, u_axis: int, z_axis: int = 2):
        """Re-entrant honeycomb half-pattern on one lateral face.

        u is the in-face horizontal axis, z vertical. Pattern (lower half):
        vertical mid strut, two vertical side struts, and 2 inclined struts;
        mirrored for the upper half.
        """
        def pt(u, z):
            p = [0.0, 0.0, 0.0]
            p[fixed_axis] = fixed_val
            p[u_axis] = u
            p[z_axis] = z
            return p

        return [
            (pt(0.5, 0.0), pt(0.5, hgeom)),          # lower mid vertical
            (pt(0.5, 1.0), pt(0.5, 1.0 - hgeom)),    # upper mid vertical
            (pt(0.0, val), pt(0.0, 1.0 - val)),      # left side vertical
            (pt(1.0, val), pt(1.0, 1.0 - val)),      # right side vertical
            (pt(0.0, val), pt(0.5, hgeom)),          # lower-left incline
            (pt(0.0, 1.0 - val), pt(0.5, 1.0 - hgeom)),
            (pt(1.0, 1.0 - val), pt(0.5, 1.0 - hgeom)),
            (pt(1.0, val), pt(0.5, hgeom)),          # lower-right incline
        ]

    # Full pattern on the two y faces
    pairs += face_pattern(1, 0.0, 0)
    pairs += face_pattern(1, 1.0, 0)

    # On the two x faces only the connecting half-frame (6 beams each):
    # kink points joined to side verticals of the y-face patterns.
    for xv in (1.0, 0.0):
        def pt(y, z, xv=xv):
            return [xv, y, z]
        pairs += [
            (pt(0.0, val), pt(0.5, hgeom)),
            (pt(1.0, val), pt(0.5, hgeom)),
            (pt(0.5, 0.0), pt(0.5, hgeom)),
            (pt(0.5, 1.0 - hgeom), pt(1.0, 1.0 - val)),
            (pt(0.5, 1.0 - hgeom), pt(0.0, 1.0 - val)),
            (pt(0.5, 1.0 - hgeom), pt(0.5, 1.0)),
        ]
    return _beams(pairs)


_CATALOG: Dict[str, Callable[[], np.ndarray]] = {
    "BCC": _bcc,
    "BCCZ": _bccz,
    "Cubic": _cubic,
    "Octet": _octet,
    "OctetExt": _octet_ext,
    "Octahedron": _octahedron,
    "OctahedronZ": _octahedron_z,
    "OctahedronYZ": _octahedron_yz,
    "Kelvin": _kelvin,
    "Diamond": _diamond,
    "Original": _original,
    "Original2": _original2,
    "Hybrid1": _hybrid1,
    "Hybrid2": _hybrid2,
    "Hybrid3": _hybrid3,
    "Hybrid4": _hybrid4,
    "Hybrid5": _hybrid5,
    "Auxetic": _auxetic,
}

_SAFE_MATH = {
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "asin": math.asin, "acos": math.acos, "atan": math.atan,
    "exp": math.exp, "log": math.log, "sqrt": math.sqrt, "pi": math.pi,
}


def _eval_expr(expr: Union[str, float, int], local_vars: dict) -> float:
    """Evaluate a (possibly symbolic) coordinate expression to a float.

    Matches the reference's whitelisted-function behavior
    (geometries_utils.py:12-38) without requiring sympy at import time.
    """
    if isinstance(expr, (int, float)):
        return float(expr)
    scope = {**_SAFE_MATH, **local_vars}
    try:
        return float(eval(compile(expr, "<geometry-expr>", "eval"), {"__builtins__": {}}, scope))
    except Exception as e:  # noqa: BLE001 - propagate with guidance like the reference
        raise ValueError(
            f"Failed to evaluate expression {expr!r}: {e}\n"
            "Tip: remove 'math.' and use functions like tan(), pi directly."
        ) from e


def load_geometry_json(path: Union[str, Path]) -> np.ndarray:
    """Load a user geometry JSON (same schema as the reference catalog files)."""
    with open(path, "r") as fh:
        geometry = json.load(fh)
    params: dict = {}
    for key, val in geometry.get("parameters", {}).items():
        params[key] = _eval_expr(val, params)
    rows = [[_eval_expr(c, params) for c in beam] for beam in geometry["beams"]]
    return np.asarray(rows, dtype=np.float64).reshape(-1, 6)


def available_geometries() -> List[str]:
    return sorted(_CATALOG)


def register_geometry(name: str, beams: Union[np.ndarray, Callable[[], np.ndarray]]) -> None:
    """Register a custom unit-cell topology under ``name``."""
    if callable(beams):
        _CATALOG[name] = beams
    else:
        arr = np.asarray(beams, dtype=np.float64).reshape(-1, 6)
        _CATALOG[name] = lambda: arr


def get_beam_structure(lattice_type: str, rng: "np.random.Generator | None" = None) -> np.ndarray:
    """Return the [n_beams, 6] fractional beam array for a topology name.

    ``"Random"`` picks a uniformly random catalog entry, mirroring
    geometries_utils.py:59-63.  A path ending in ``.json`` is loaded as a user
    geometry file.
    """
    if lattice_type == "Random":
        rng = rng or np.random.default_rng()
        lattice_type = sorted(_CATALOG)[int(rng.integers(len(_CATALOG)))]
    if lattice_type.endswith(".json"):
        return load_geometry_json(lattice_type)
    try:
        return _CATALOG[lattice_type]().copy()
    except KeyError:
        raise FileNotFoundError(
            f"Geometry '{lattice_type}' not found. Available: {available_geometries()}"
        ) from None
