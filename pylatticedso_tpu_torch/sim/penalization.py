"""Joint-stiffness penalization: angles, L-zones, and beam splitting.

Re-implements the reference's junction model (Cadart et al. 2025, IJSS
113107) as a vectorized host transform:

* per-endpoint beam angles over node connectivity, with optional periodic
  stitching (lattice.py:805-867) and tag-matched periodic pairing
  (beam.py:204-278),
* penalization length ``L_zone = r / tan(theta/2)`` with the reference's
  special cases (utils.py:432-453), selecting the connected beam maximizing
  L_zone (lattice.py:871-905),
* splitting every beam with a positive end-zone into up to three collinear
  segments whose end segments carry ``radius * 1.5`` (lattice_sim.py:245-308,
  beam.py:405-413).

Deviation from the reference (documented): beams shared by two cells are
split once globally; the reference's per-cell loop re-splits the shared copy
creating duplicate overlapping segments (lattice_sim.py:252 iterates cells) —
a double-stiffness artifact we do not reproduce.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = ["PenalizationResult", "compute_l_zones", "penalize_edges",
           "function_penalization_Lzone", "lzone_coefficients"]

PENALIZATION_COEFFICIENT = 1.5  # beam.py:71

# periodic tag groups (beam.py:234-252): edge tags grouped by cube-edge
# direction, face tags paired across the cell
_EDGE_TAG_GROUPS = [[102, 104, 106, 107], [100, 108, 105, 111], [101, 109, 103, 110]]
_FACE_TAG_GROUPS = [[10, 15], [11, 14], [12, 13]]
_CORNER_RANGE = (1000, 1007)


def function_penalization_Lzone(radius: float, angle_deg: float) -> float:
    """L = r / tan(theta/2); ~0 for quasi-aligned beams (utils.py:432-453)."""
    if angle_deg > 170.0:
        return 0.0000001
    if angle_deg == 0.0:
        return 0.0
    return radius / math.tan(math.radians(angle_deg) / 2.0)


_lzone_vec = np.vectorize(function_penalization_Lzone, otypes=[np.float64])


def _node_groups(nodes: np.ndarray, node_tag: np.ndarray, periodicity: bool,
                 merge_tol: float = 1e-9) -> np.ndarray:
    """Group id per node: identity, plus periodic wrap (max faces -> min)."""
    N = len(nodes)
    group = np.arange(N)
    if not periodicity:
        return group
    mins = nodes.min(axis=0)
    maxs = nodes.max(axis=0)
    wrapped = nodes.copy()
    for ax in range(3):
        on_max = np.abs(nodes[:, ax] - maxs[ax]) <= merge_tol
        wrapped[on_max, ax] = mins[ax]
    keys = np.round(wrapped / merge_tol).astype(np.int64)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    return inv


def _angle_between(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Angle in degrees between row vectors (beam.py:271-278 clamped acos)."""
    dot = np.einsum("ij,ij->i", u, v)
    nu = np.linalg.norm(u, axis=1)
    nv = np.linalg.norm(v, axis=1)
    c = np.clip(dot / (nu * nv), -1.0, 1.0)
    return np.degrees(np.arccos(c))


def compute_l_zones(nodes: np.ndarray, edges: np.ndarray, radius: np.ndarray,
                    node_tag: Optional[np.ndarray] = None,
                    periodicity: bool = False) -> np.ndarray:
    """Per-edge end-zone lengths L[:, 0] (at endpoint 0) and L[:, 1].

    For each endpoint, over all other edges connected to the (possibly
    periodically stitched) node group, pick the (angle, other-radius) pair
    maximizing L_zone — lattice.py:878-905.
    """
    E = len(edges)
    group = _node_groups(nodes, node_tag, periodicity)
    g1, g2 = group[edges[:, 0]], group[edges[:, 1]]

    # adjacency: (group, edge, local_end) triples
    ge = np.concatenate([
        np.stack([g1, np.arange(E), np.zeros(E, dtype=np.int64)], axis=1),
        np.stack([g2, np.arange(E), np.ones(E, dtype=np.int64)], axis=1),
    ])
    order = np.argsort(ge[:, 0], kind="stable")
    ge = ge[order]
    grp_sorted = ge[:, 0]
    starts = np.searchsorted(grp_sorted, np.unique(grp_sorted), side="left")
    ends = np.append(starts[1:], len(ge))

    # candidate pairs (edge a end ea) x (edge b) within each group
    pair_a, end_a, pair_b, end_b = [], [], [], []
    for s, t in zip(starts, ends):
        members = ge[s:t]
        if len(members) < 2:
            continue
        eids = members[:, 1]
        lends = members[:, 2]
        ii, jj = np.meshgrid(np.arange(len(members)), np.arange(len(members)),
                             indexing="ij")
        mask = eids[ii] != eids[jj]
        pair_a.append(eids[ii][mask]); end_a.append(lends[ii][mask])
        pair_b.append(eids[jj][mask]); end_b.append(lends[jj][mask])
    if not pair_a:
        return np.zeros((E, 2))
    ea = np.concatenate(pair_a); enda = np.concatenate(end_a)
    eb = np.concatenate(pair_b); endb = np.concatenate(end_b)

    # away-vectors following get_angle_between_beams: when the two edges share
    # a node identity, directions point away from the shared point; for
    # periodic pairs the tag-matched endpoints play that role.  Since group
    # membership already encodes the (possibly wrapped) shared node, the
    # away-vector from the in-group endpoint reproduces both branches.
    vecs = nodes[edges[:, 1]] - nodes[edges[:, 0]]
    sign_a = np.where(enda == 0, 1.0, -1.0)[:, None]
    sign_b = np.where(endb == 0, 1.0, -1.0)[:, None]
    u = vecs[ea] * sign_a
    v = vecs[eb] * sign_b
    ang = _angle_between(u, v)

    keep = ang > 1e-12
    ea, enda, eb, ang = ea[keep], enda[keep], eb[keep], ang[keep]
    L = _lzone_vec(radius[eb], ang)

    # segment-max of L over (edge, end)
    out = np.zeros((E, 2))
    key = ea * 2 + enda
    np.maximum.at(out.reshape(-1), key, L)
    return out


def lzone_coefficients(nodes: np.ndarray, edges: np.ndarray,
                       edge_type: np.ndarray, n_geom: int,
                       node_tag: Optional[np.ndarray] = None,
                       periodicity: bool = False):
    """Radius-independent L-zone structure for radius-grid sweeps.

    L_zone at (edge, end) = max over connected pairs of
    ``f(angle) * r_other`` with f = 1/tan(angle/2) for angle <= 170 deg and
    an absolute 1e-7 floor above (utils.py:432-453).  Within a cell every
    edge of geometry g shares radius mu[g], so

        L_zone(mu)[e, end] = max(max_g coefs[e, end, g] * mu[g],
                                 floor[e, end])

    Returns (coefs [E, 2, n_geom], floor [E, 2]); evaluating this at a
    concrete mu reproduces ``compute_l_zones`` exactly.
    """
    E = len(edges)
    group = _node_groups(nodes, node_tag, periodicity)
    g1, g2 = group[edges[:, 0]], group[edges[:, 1]]
    ge = np.concatenate([
        np.stack([g1, np.arange(E), np.zeros(E, dtype=np.int64)], axis=1),
        np.stack([g2, np.arange(E), np.ones(E, dtype=np.int64)], axis=1),
    ])
    order = np.argsort(ge[:, 0], kind="stable")
    ge = ge[order]
    grp_sorted = ge[:, 0]
    starts = np.searchsorted(grp_sorted, np.unique(grp_sorted), side="left")
    ends = np.append(starts[1:], len(ge))

    pair_a, end_a, pair_b, end_b = [], [], [], []
    for s, t in zip(starts, ends):
        members = ge[s:t]
        if len(members) < 2:
            continue
        eids = members[:, 1]
        lends = members[:, 2]
        ii, jj = np.meshgrid(np.arange(len(members)), np.arange(len(members)),
                             indexing="ij")
        mask = eids[ii] != eids[jj]
        pair_a.append(eids[ii][mask]); end_a.append(lends[ii][mask])
        pair_b.append(eids[jj][mask]); end_b.append(lends[jj][mask])
    coefs = np.zeros((E, 2, n_geom))
    floor = np.zeros((E, 2))
    if not pair_a:
        return coefs, floor
    ea = np.concatenate(pair_a); enda = np.concatenate(end_a)
    eb = np.concatenate(pair_b); endb = np.concatenate(end_b)

    vecs = nodes[edges[:, 1]] - nodes[edges[:, 0]]
    sign_a = np.where(enda == 0, 1.0, -1.0)[:, None]
    sign_b = np.where(endb == 0, 1.0, -1.0)[:, None]
    u = vecs[ea] * sign_a
    v = vecs[eb] * sign_b
    ang = _angle_between(u, v)

    keep = ang > 1e-12
    ea, enda, eb, ang = ea[keep], enda[keep], eb[keep], ang[keep]
    gb = np.asarray(edge_type)[eb]

    aligned = ang > 170.0
    # absolute floor from quasi-aligned pairs
    key = (ea * 2 + enda)[aligned]
    np.maximum.at(floor.reshape(-1), key, 1e-7)
    # radius-proportional coefficients elsewhere
    ok = ~aligned
    c = np.zeros_like(ang)
    c[ok] = 1.0 / np.tan(np.radians(ang[ok]) / 2.0)
    key3 = (ea * 2 + enda) * n_geom + gb
    np.maximum.at(coefs.reshape(-1), key3[ok], c[ok])
    return coefs, floor


@dataclass
class PenalizationResult:
    nodes: np.ndarray          # original nodes + inserted zone points
    edges: np.ndarray          # [E',2]
    radius: np.ndarray         # [E'] (end segments already scaled by 1.5)
    parent_edge: np.ndarray    # [E'] original edge id per segment
    penalized: np.ndarray      # [E'] bool — True for modified end segments
    l_zones: np.ndarray        # [E,2] zone lengths used


def penalize_edges(nodes: np.ndarray, edges: np.ndarray, radius: np.ndarray,
                   node_tag: Optional[np.ndarray] = None,
                   periodicity: bool = False,
                   coefficient: float = PENALIZATION_COEFFICIENT,
                   l_zones: Optional[np.ndarray] = None) -> PenalizationResult:
    """Split beams into penalized end zones + core segment."""
    if l_zones is None:
        l_zones = compute_l_zones(nodes, edges, radius, node_tag, periodicity)
    E = len(edges)
    # the reference places zone points using its 4-decimal-rounded beam
    # length (beam.py:125-135, get_point_on_beam_at_distance:306-313)
    lengths = np.round(np.linalg.norm(nodes[edges[:, 1]] - nodes[edges[:, 0]], axis=1), 4)

    new_nodes = [nodes]
    next_id = len(nodes)
    out_edges, out_radius, out_parent, out_mod = [], [], [], []
    for e in range(E):
        L1, L2 = l_zones[e]
        a, b = int(edges[e, 0]), int(edges[e, 1])
        r = radius[e]
        if L1 <= 0 and L2 <= 0:
            out_edges.append((a, b)); out_radius.append(r)
            out_parent.append(e); out_mod.append(False)
            continue
        pa, pb = nodes[a], nodes[b]
        t = (pb - pa) / lengths[e]
        start = a
        if L1 > 0:
            new_nodes.append((pa + L1 * t)[None])
            m1 = next_id; next_id += 1
            out_edges.append((a, m1)); out_radius.append(r * coefficient)
            out_parent.append(e); out_mod.append(True)
            start = m1
        if L2 > 0:
            new_nodes.append((pb - L2 * t)[None])
            m2 = next_id; next_id += 1
            out_edges.append((start, m2)); out_radius.append(r)
            out_parent.append(e); out_mod.append(False)
            out_edges.append((m2, b)); out_radius.append(r * coefficient)
            out_parent.append(e); out_mod.append(True)
        else:
            out_edges.append((start, b)); out_radius.append(r)
            out_parent.append(e); out_mod.append(False)

    return PenalizationResult(
        nodes=np.concatenate(new_nodes),
        edges=np.asarray(out_edges, dtype=edges.dtype),
        radius=np.asarray(out_radius),
        parent_edge=np.asarray(out_parent, dtype=np.int64),
        penalized=np.asarray(out_mod, dtype=bool),
        l_zones=l_zones,
    )
