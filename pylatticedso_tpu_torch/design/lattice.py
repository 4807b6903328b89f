"""Host-side lattice builder: JSON config -> fixed-shape connectivity arrays.

This replaces the reference's pointer-web object model (Lattice/Cell/Beam/
Point, `pyLatticeDesign/{lattice,cell,beam,point}.py`)
with a vectorized numpy pipeline that emits the arrays the device physics core
consumes:

* ``nodes [N,3]`` float64 positions,
* ``edges [E,2]`` int32 node indices,
* per-edge ``radius``, ``edge_type`` (geometry index), ``edge_mat``,
* per-node boundary ``node_tag`` (reference tag codes, 0 = interior),
* per-cell grid position / origin / size and CSR cell->edge / cell->node maps.

Reference semantics reproduced exactly:
* node dedup by coordinates rounded to 9 digits (cell.py:317-380),
* one beam per unordered node pair, first geometry wins (cell.py:366-380),
* ``random.seed(44)`` radius randomness drawn in cell loop order
  (lattice.py:426-466),
* per-axis gradient tables for radius / cell size (gradient_properties.py),
* erased blocks (lattice.py:637-661), deterministic node/beam indexing
  (lattice.py:665-698), boundary tagging by exact equality (point.py:169-235),
* hybrid collision splitting of beams crossing interior nodes
  (lattice.py:1111-1216),
* beam length rounded to 4 decimals for volume/relative-density parity
  (beam.py:125-156).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..catalog import get_beam_structure
from ..config import LatticeConfig, load_config
from ..gradients import gradient_factor_table, material_field
from .. import native as _native
from .tags import tag_points

__all__ = ["Lattice", "build_lattice"]

_ROUND_DIGITS = 9  # node dedup key precision (cell.py:317)
_LEN_DIGITS = 4    # beam length rounding (beam.py:135)


def _round_key(coords: np.ndarray) -> np.ndarray:
    return np.round(coords, _ROUND_DIGITS)


@dataclass
class Lattice:
    """Array-of-structs lattice: everything the device core needs, as numpy."""

    config: LatticeConfig

    # node arrays
    nodes: np.ndarray = None          # [N,3] f64
    node_tag: np.ndarray = None       # [N] i32, 0 = interior

    # edge arrays (orientation: endpoint with lexicographically smaller coords first)
    edges: np.ndarray = None          # [E,2] i32
    radius: np.ndarray = None         # [E] f64
    edge_type: np.ndarray = None      # [E] i32 geometry index into config.geom_types
    edge_mat: np.ndarray = None       # [E] i32 material id

    # cell arrays
    cell_pos: np.ndarray = None       # [C,3] i32 grid position
    cell_origin: np.ndarray = None    # [C,3] f64
    cell_size: np.ndarray = None      # [C,3] f64
    cell_radii: np.ndarray = None     # [C,G] f64 per-geometry radius of each cell

    # CSR membership maps
    cell_edge_ptr: np.ndarray = None  # [C+1] i64
    cell_edge_idx: np.ndarray = None  # [sum] i32 edge ids per cell
    cell_node_ptr: np.ndarray = None  # [C+1] i64
    cell_node_idx: np.ndarray = None  # [sum] i32 node ids per cell

    # per-edge primary owner cell (first cell that created it)
    edge_cell: np.ndarray = None      # [E] i32

    name: str = "lattice"
    _extras: dict = field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------
    # basic queries (reference: lattice.py get_number_beams/nodes, etc.)
    # ------------------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def num_cells(self) -> int:
        return int(self.cell_pos.shape[0])

    @property
    def num_dof(self) -> int:
        return 6 * self.num_nodes

    def get_number_beams(self) -> int:
        return self.num_edges

    def get_number_nodes(self) -> int:
        return self.num_nodes

    def get_lattice_boundary_box(self) -> List[float]:
        mins = self.nodes.min(axis=0)
        maxs = self.nodes.max(axis=0)
        return [mins[0], maxs[0], mins[1], maxs[1], mins[2], maxs[2]]

    @property
    def size_lattice(self) -> List[float]:
        b = self.get_lattice_boundary_box()
        return [b[1] - b[0], b[3] - b[2], b[5] - b[4]]

    # ------------------------------------------------------------------
    # derived per-edge quantities
    # ------------------------------------------------------------------
    @property
    def edge_vectors(self) -> np.ndarray:
        return self.nodes[self.edges[:, 1]] - self.nodes[self.edges[:, 0]]

    @property
    def edge_lengths(self) -> np.ndarray:
        """Exact euclidean lengths (used by the solver)."""
        return np.linalg.norm(self.edge_vectors, axis=1)

    @property
    def edge_lengths_rounded(self) -> np.ndarray:
        """Lengths rounded to 4 decimals — the reference's beam.length."""
        return np.round(self.edge_lengths, _LEN_DIGITS)

    @property
    def edge_volumes(self) -> np.ndarray:
        """pi r^2 L with the reference's rounded length (beam.py:140-156)."""
        return math.pi * self.radius**2 * self.edge_lengths_rounded

    # ------------------------------------------------------------------
    # densities
    # ------------------------------------------------------------------
    def cell_relative_density(self) -> np.ndarray:
        """Relative density per cell: sum of member beam volumes / cell volume.

        Beams shared by two cells count fully in both, as in the reference's
        ``Cell.relative_density`` (cell.py:169-176).
        """
        vols = self.edge_volumes
        per_cell = np.add.reduceat(
            vols[self.cell_edge_idx],
            self.cell_edge_ptr[:-1],
        )
        # reduceat misbehaves on empty segments; mask them
        seg_len = np.diff(self.cell_edge_ptr)
        per_cell = np.where(seg_len > 0, per_cell, 0.0)
        cell_vol = np.prod(self.cell_size, axis=1)
        return per_cell / cell_vol

    def get_relative_density(self) -> float:
        """Mean of per-cell relative densities (lattice.py:348-363)."""
        return float(self.cell_relative_density().mean())

    def get_beam_radius_min_max(self) -> Tuple[float, float]:
        return float(self.radius.max()), float(self.radius.min())

    # ------------------------------------------------------------------
    # cell / surface selection (lattice.py:1320-1412)
    # ------------------------------------------------------------------
    def cells_on_surfaces(self, surfaces: Sequence[str]) -> np.ndarray:
        """Cell indices matching iterative extrema filters like ["Xmin","Zmax"]."""
        axis_map = {"X": 0, "Y": 1, "Z": 2}
        cand = np.arange(self.num_cells)
        for token in surfaces:
            t = token.strip().lower()
            if not t:
                continue
            ax = axis_map.get(t[0].upper())
            if ax is None:
                raise ValueError(f"Invalid axis in constraint '{token}', expected X/Y/Z with min/max.")
            vals = self.cell_pos[cand, ax]
            if "min" in t:
                cand = cand[vals == vals.min()]
            elif "max" in t:
                cand = cand[vals == vals.max()]
            else:
                raise ValueError(f"Invalid extrema in constraint '{token}', expected 'min' or 'max'.")
            if cand.size == 0:
                return cand
        return cand

    def _cell_surface_node_mask(self, cell_ids: np.ndarray, surface: str) -> np.ndarray:
        """Boolean mask over nodes lying on ``surface`` of any cell in cell_ids.

        Mirrors Cell.get_point_on_surface (cell.py:436-490): min/max planes of
        the cell bbox, or the Mid planes through the cell origin.
        """
        axis = {"X": 0, "Y": 1, "Z": 2}[surface[0].upper()]
        mask = np.zeros(self.num_nodes, dtype=bool)
        kind = surface[1:].lower()
        for c in cell_ids:
            nids = self.cell_node_idx[self.cell_node_ptr[c]:self.cell_node_ptr[c + 1]]
            if kind == "min":
                val = self.cell_origin[c, axis]
            elif kind == "max":
                val = self.cell_origin[c, axis] + self.cell_size[c, axis]
            elif kind == "mid":
                val = self.cell_origin[c, axis]
            else:
                raise ValueError(f"Invalid surface '{surface}'")
            mask[nids[self.nodes[nids, axis] == val]] = True
        return mask

    def find_nodes_on_surface(self, surfaces: Sequence[str],
                              surface_cells: Optional[Sequence[str]] = None) -> np.ndarray:
        """Node ids on the intersection of the named lattice surfaces.

        Two-stage selection as in find_point_on_lattice_surface
        (lattice.py:1320-1359): first pick the extreme cells, then intersect
        per-cell surface point sets.
        """
        bad = [s for s in surfaces if s not in
               {"Xmin", "Xmax", "Ymin", "Ymax", "Zmin", "Zmax", "Xmid", "Ymid", "Zmid"}]
        if bad:
            raise ValueError(f"Invalid surface name(s): {bad}")
        cell_ids = self.cells_on_surfaces([s for s in surfaces if "mid" not in s.lower()] or surfaces)
        node_surfaces = surface_cells if surface_cells is not None else surfaces
        mask = np.ones(self.num_nodes, dtype=bool)
        for s in node_surfaces:
            mask &= self._cell_surface_node_mask(cell_ids, s)
        ids = np.nonzero(mask)[0]
        if ids.size == 0:
            raise ValueError("No points found on the specified surfaces.")
        return ids

    # ------------------------------------------------------------------
    # misc
    # ------------------------------------------------------------------
    def get_cell_occupancy_matrix(self) -> np.ndarray:
        """[nx, ny, nz] grid of cell indices (-1 where erased/trimmed) —
        get_cell_occupancy_matrix parity (lattice.py:1003-1021)."""
        nx, ny, nz = self.config.num_cells
        occ = -np.ones((nx, ny, nz), dtype=np.int64)
        for c, (i, j, k) in enumerate(self.cell_pos):
            occ[i, j, k] = c
        return occ

    def are_cells_identical(self) -> bool:
        """True when all cells share size and per-geometry radii
        (are_cells_identical diagnostic, lattice.py:1219-1272)."""
        return (np.allclose(self.cell_size, self.cell_size[0]) and
                np.allclose(self.cell_radii, self.cell_radii[0]))

    def find_minimum_beam_length(self) -> float:
        """Shortest beam above the reference's 1e-4 noise floor
        (lattice.py:955-973)."""
        L = self.edge_lengths
        valid = L > 0.0001
        return float(L[valid].min()) if valid.any() else float("inf")

    def node_energies(self, u: np.ndarray, device="cuda") -> np.ndarray:
        """Per-node strain energy: half of each incident beam's energy
        attributed to each endpoint (calculate_point_energy parity,
        point.py:398).  Computed on ``device`` in float64; the per-node sum
        runs in a fixed order (``fem.operator.SegmentSum``), so repeated
        calls give the same bits on the card too."""
        import torch
        from ..fem.elements import edge_strains
        from ..fem.operator import SegmentSum, build_operator
        from ..materials import MatProperties
        mat = MatProperties(self.config.material_name())
        op = build_operator(self.nodes, self.edges, self.radius,
                            mat.young_modulus, mat.poisson_ratio,
                            dtype=torch.float64, device=device)
        ut = torch.as_tensor(np.asarray(u), dtype=op.geom.L.dtype,
                             device=op.geom.L.device)
        n1, n2 = op.edges[:, 0], op.edges[:, 1]
        eps = edge_strains(ut[n1, :3], ut[n1, 3:], ut[n2, :3], ut[n2, 3:],
                           op.geom)
        e_edge = 0.5 * torch.sum(op.geom.L[:, None] * op.D * eps**2, dim=1)
        half = torch.cat([0.5 * e_edge, 0.5 * e_edge])
        seg = SegmentSum(torch.cat([n1, n2]), self.num_nodes)
        return seg(half).cpu().numpy()

    def print_statistics_lattice(self) -> None:
        print("Lattice name: ", self.name)
        print("Number of cells: ", self.num_cells)
        print("Number of beams: ", self.num_edges)
        print("Number of nodes: ", self.num_nodes)

    def __repr__(self) -> str:
        return (f"Lattice(name={self.name!r}, cells={self.num_cells}, "
                f"beams={self.num_edges}, nodes={self.num_nodes})")


# ======================================================================
# Builder
# ======================================================================

def _active_cells(cfg: LatticeConfig):
    """Grid positions/origins/sizes of non-erased cells in reference loop order
    (x outer, then y, then z — lattice.py:450-492)."""
    nx, ny, nz = cfg.num_cells
    gdim = gradient_factor_table(cfg.num_cells, cfg.grad_dim.rule,
                                 cfg.grad_dim.direction, cfg.grad_dim.parameters)
    csx, csy, csz = cfg.cell_size

    sizes_x = csx * gdim[:nx, 0]
    sizes_y = csy * gdim[:ny, 1]
    sizes_z = csz * gdim[:nz, 2]
    x_starts = np.concatenate([[0.0], np.cumsum(sizes_x[:-1])])
    y_starts = np.concatenate([[0.0], np.cumsum(sizes_y[:-1])])
    z_starts = np.concatenate([[0.0], np.cumsum(sizes_z[:-1])])

    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), kk.ravel()], axis=1)  # C order = i,j,k loops
    origin = np.stack([x_starts[pos[:, 0]], y_starts[pos[:, 1]], z_starts[pos[:, 2]]], axis=1)
    size = np.stack([sizes_x[pos[:, 0]], sizes_y[pos[:, 1]], sizes_z[pos[:, 2]]], axis=1)

    keep = np.ones(len(pos), dtype=bool)
    if cfg.eraser_blocks:
        for blk in cfg.eraser_blocks:
            start = np.array(blk[:3])
            dim = np.array(blk[3:])
            inside = np.all((origin >= start) & (origin <= start + dim), axis=1)
            keep &= ~inside
    pos, origin, size = pos[keep], origin[keep], size[keep]

    # symmetry: append mirrored duplicate cells across the requested plane,
    # translating each cell box (o' = 2 ref - (o + s)) while keeping the
    # template untransformed — exactly apply_symmetry (lattice.py:497-580)
    if cfg.symmetries:
        plane = (cfg.symmetries.get("sym_plane") or "").upper()
        ref = np.asarray(cfg.symmetries.get("sym_point", (0.0, 0.0, 0.0)))
        if plane not in {"XY", "XZ", "YZ", "X", "Y", "Z"}:
            raise ValueError(
                "Invalid symmetry plane. Choose from 'XY', 'XZ', 'YZ', 'X', 'Y', or 'Z'.")
        mirror_axes = {"YZ": [0], "X": [0], "XZ": [1], "Y": [1],
                       "XY": [2], "Z": [2]}[plane]
        m_origin = origin.copy()
        for ax in mirror_axes:
            m_origin[:, ax] = 2 * ref[ax] - (origin[:, ax] + size[:, ax])
        pos = np.concatenate([pos, pos])
        origin = np.concatenate([origin, m_origin])
        size = np.concatenate([size, size])
    return pos, origin, size


def _replay_rng(cfg: LatticeConfig, pos: np.ndarray, new_nodes_per_cell: np.ndarray,
                n_nodes: int):
    """Replay the reference's exact RNG consumption sequence.

    ``generate_lattice`` seeds ``random.seed(44)`` (lattice.py:426) and then,
    per non-erased cell in loop order: draws the random radii (lattice.py:
    455-465), then creates each *new* Point, which calls ``random.gauss(0,
    sd)`` three times (point.py:55-57) — advancing the RNG state even when
    sd == 0.  Returns (base radii [C,G], jitter [N,3]).
    """
    C = len(pos)
    G = cfg.n_geom
    base = np.tile(np.asarray(cfg.radii, dtype=np.float64), (C, 1))
    jitter = np.zeros((n_nodes, 3), dtype=np.float64)
    needs_rng = cfg.enable_randomness or cfg.uncertainty_node > 0
    if needs_rng:
        rng = random.Random()
        rng.seed(44)
        lo, hi = cfg.range_radius
        sd = cfg.uncertainty_node
        node_cursor = 0
        for c in range(C):
            if cfg.enable_randomness:
                if cfg.randomness_hybrid:
                    base[c] = [rng.uniform(lo, hi) for _ in range(G)]
                else:
                    base[c] = rng.uniform(lo, hi)
            for _ in range(int(new_nodes_per_cell[c])):
                jitter[node_cursor] = [rng.gauss(0, sd), rng.gauss(0, sd), rng.gauss(0, sd)]
                node_cursor += 1
    return base, jitter


def _cell_radii_factors(cfg: LatticeConfig, pos: np.ndarray) -> np.ndarray:
    """Per-cell gradient multiplier for the base radii (cell.py:393-413)."""
    grad = gradient_factor_table(cfg.num_cells, cfg.grad_radius.rule,
                                 cfg.grad_radius.direction, cfg.grad_radius.parameters)
    return grad[pos[:, 0], 0] * grad[pos[:, 1], 1] * grad[pos[:, 2], 2]


def _split_hybrid_collisions(nodes, edges, radius, etype, emat, ecell,
                             cell_node_of, tol: float = 1e-9):
    """Split beams that pass through interior nodes of their own cell.

    Vectorized equivalent of check_hybrid_collision (lattice.py:1111-1216):
    for every (edge, candidate node in same cell) pair, a node strictly
    interior to the segment (colinear, 0 < t < 1) splits the beam into
    segments that inherit radius/type/material.
    """
    # Candidate pairs: for each edge, nodes of its owner cell
    counts = np.array([len(cell_node_of[c]) for c in ecell])
    if counts.sum() == 0:
        return nodes, edges, radius, etype, emat, ecell
    e_rep = np.repeat(np.arange(len(edges)), counts)
    n_cand = np.concatenate([cell_node_of[c] for c in ecell]) if len(edges) else np.array([], int)

    p1 = nodes[edges[e_rep, 0]]
    p2 = nodes[edges[e_rep, 1]]
    pn = nodes[n_cand]
    v = p2 - p1
    w = pn - p1
    L2 = np.einsum("ij,ij->i", v, v)
    cross = np.cross(v, w)
    colinear = np.einsum("ij,ij->i", cross, cross) <= (tol * np.sqrt(np.maximum(L2, 1e-300)))**2
    t = np.einsum("ij,ij->i", w, v) / np.maximum(L2, 1e-300)
    interior = colinear & (t > 1e-12) & (t < 1.0 - 1e-12)
    not_endpoint = (n_cand != edges[e_rep, 0]) & (n_cand != edges[e_rep, 1])
    hit = interior & not_endpoint
    if not hit.any():
        return nodes, edges, radius, etype, emat, ecell

    # Build split chains per edge
    new_edges, new_radius, new_type, new_mat, new_cell = [], [], [], [], []
    hit_edges = {}
    for e, n, tt in zip(e_rep[hit], n_cand[hit], t[hit]):
        hit_edges.setdefault(int(e), []).append((tt, int(n)))

    keep_mask = np.ones(len(edges), dtype=bool)
    for e, tn in hit_edges.items():
        keep_mask[e] = False
        tn = sorted(set(tn))
        chain = [int(edges[e, 0])] + [n for _, n in tn] + [int(edges[e, 1])]
        for a, b in zip(chain[:-1], chain[1:]):
            new_edges.append((a, b))
            new_radius.append(radius[e])
            new_type.append(etype[e])
            new_mat.append(emat[e])
            new_cell.append(ecell[e])

    edges = np.concatenate([edges[keep_mask], np.array(new_edges, dtype=edges.dtype)])
    radius = np.concatenate([radius[keep_mask], np.array(new_radius)])
    etype = np.concatenate([etype[keep_mask], np.array(new_type, dtype=etype.dtype)])
    emat = np.concatenate([emat[keep_mask], np.array(new_mat, dtype=emat.dtype)])
    ecell = np.concatenate([ecell[keep_mask], np.array(new_cell, dtype=ecell.dtype)])

    # Dedup any segments that collapsed onto existing beams
    key = np.sort(edges, axis=1)
    _, first, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    order = np.sort(first)
    remap = {tuple(key[i]): rank for rank, i in enumerate(order)}
    sel = order
    return nodes, edges[sel], radius[sel], etype[sel], emat[sel], ecell[sel]


from ..utils.timing import timing


@timing.timeit(category="design")
def build_lattice(source: Union[str, dict, LatticeConfig], name: str = None,
                  mesh_trimmer=None, verbose: int = 0) -> Lattice:
    """Build the full lattice array set from a config."""
    cfg = source if isinstance(source, LatticeConfig) else load_config(source)
    pos, origin, size = _active_cells(cfg)
    if mesh_trimmer is not None:
        corners_keep = np.array([mesh_trimmer.is_cell_in_mesh_arrays(o, s)
                                 for o, s in zip(origin, size)])
        pos, origin, size = pos[corners_keep], origin[corners_keep], size[corners_keep]
    C = len(pos)
    if C == 0:
        raise ValueError("No cells remain after erasure/trimming.")

    mat3d = material_field(cfg.num_cells, cfg.grad_mat[0], cfg.grad_mat[1])
    # reference indexes grad_mat[z][y][x] (cell.py:386-391)
    cell_mat = mat3d[pos[:, 2], pos[:, 1], pos[:, 0]] if mat3d.size else np.zeros(C, int)

    # templates per geometry
    templates = [get_beam_structure(g) for g in cfg.geom_types]
    M = sum(len(t) for t in templates)

    # world endpoints for every (cell, geom, template beam) in the
    # reference's creation order (cell outer, geometry inner), emitted with
    # quantized int keys by the native fused kernel
    # (pylatticedso_tpu/native/dedup.cpp::replicate_cells_multi)
    pts, int_keys = _native.replicate_cells(templates, origin, size)
    typ_pattern = np.concatenate([np.full(len(t), g, dtype=np.int32)
                                  for g, t in enumerate(templates)])
    typ = np.tile(typ_pattern, C)
    cel = np.repeat(np.arange(C, dtype=np.int32), M)
    mat = np.repeat(cell_mat.astype(np.int32), M)

    # node dedup on 9-digit-rounded coords, first occurrence keeps its value.
    # np.round(x, 9) == round(x * 1e9) / 1e9, so the integer keys give the
    # same equivalence classes — hashed in O(N) natively.
    first_sorted, node_ids_flat = _native.dedup_rows3(int_keys)
    nodes = pts[first_sorted]  # coords of first occurrences, creation order

    # replay the reference RNG: radii randomness interleaved with per-new-Point
    # gauss draws (first occurrence position -> generated beam -> owning cell)
    node_birth_cell = cel[first_sorted // 2]
    new_nodes_per_cell = np.bincount(node_birth_cell, minlength=C)
    radii_base, jitter = _replay_rng(cfg, pos, new_nodes_per_cell, len(nodes))
    if cfg.uncertainty_node > 0:
        nodes = nodes + jitter
    radii_cg = radii_base * _cell_radii_factors(cfg, pos)[:, None]  # [C, G]
    rad = radii_cg[cel, typ]  # per generated beam

    gen_edges = node_ids_flat.reshape(-1, 2).astype(np.int32)

    # edge dedup: unordered pair, first occurrence keeps radius/type/material
    sel, edge_of_gen = _native.dedup_pairs(gen_edges[:, 0], gen_edges[:, 1])
    edges = gen_edges[sel]
    radius = rad[sel]
    etype = typ[sel]
    emat = mat[sel]
    ecell = cel[sel]

    # cell membership (before splitting; splitting preserves cell sets)
    ce_first, _ = _native.dedup_pairs(cel.astype(np.int64), edge_of_gen,
                                      ordered=True)
    ce_pairs = np.stack([cel[ce_first], edge_of_gen[ce_first]], axis=1)

    # per-cell node lists from member edges
    cn_all_c = np.concatenate([ce_pairs[:, 0], ce_pairs[:, 0]])
    cn_all_n = np.concatenate([edges[ce_pairs[:, 1], 0], edges[ce_pairs[:, 1], 1]])
    cn_first, _ = _native.dedup_pairs(cn_all_c, cn_all_n.astype(np.int64),
                                      ordered=True)
    cn_pairs = np.stack([cn_all_c[cn_first], cn_all_n[cn_first]], axis=1)

    # hybrid collision splitting
    if cfg.n_geom > 1:
        cell_node_of = [cn_pairs[cn_pairs[:, 0] == c, 1] for c in range(C)]
        nodes, edges, radius, etype, emat, ecell = _split_hybrid_collisions(
            nodes, edges, radius, etype, emat, ecell, cell_node_of)
        # rebuild cell->edge membership from owner cells + geometric overlap:
        # an edge belongs to every cell whose bbox contains both endpoints.
        ce_pairs = _membership_by_bbox(nodes, edges, origin, size)
        cn_pairs = np.unique(np.concatenate([
            np.stack([ce_pairs[:, 0], edges[ce_pairs[:, 1], 0]], axis=1),
            np.stack([ce_pairs[:, 0], edges[ce_pairs[:, 1], 1]], axis=1),
        ]), axis=0)

    # ------------------------------------------------------------------
    # deterministic final indexing (lattice.py:665-698)
    # ------------------------------------------------------------------
    node_order = _native.argsort_rows(nodes)
    node_newid = np.empty(len(nodes), dtype=np.int64)
    node_newid[node_order] = np.arange(len(nodes))
    nodes = nodes[node_order]
    edges = node_newid[edges].astype(np.int32)

    # orient each edge lo -> hi by endpoint coordinates
    c1, c2 = nodes[edges[:, 0]], nodes[edges[:, 1]]
    swap = _coord_greater(c1, c2)
    edges = np.where(swap[:, None], edges[:, ::-1], edges)
    c1, c2 = nodes[edges[:, 0]], nodes[edges[:, 1]]

    edge_order = _native.argsort_rows(
        np.concatenate([c1, c2, radius[:, None]], axis=1))
    edge_newid = np.empty(len(edges), dtype=np.int64)
    edge_newid[edge_order] = np.arange(len(edges))
    edges = edges[edge_order]
    radius = radius[edge_order]
    etype = etype[edge_order]
    emat = emat[edge_order]
    ecell = ecell[edge_order]

    # remap membership
    ce_pairs = np.stack([ce_pairs[:, 0], edge_newid[ce_pairs[:, 1]]], axis=1)
    cn_pairs = np.stack([cn_pairs[:, 0], node_newid[cn_pairs[:, 1]]], axis=1)

    cell_edge_ptr, cell_edge_idx = _pairs_to_csr(ce_pairs, C)
    cell_node_ptr, cell_node_idx = _pairs_to_csr(cn_pairs, C)

    # boundary tags: global bbox normally; with erased blocks the reference
    # tags each node against its cell's own box, last owner cell winning
    # (apply_tag_all_point, lattice.py:982-1000; get_relative_boundary_box
    # reduces to the cell bbox since same-index cells share extents)
    if cfg.eraser_blocks:
        node_tag = np.zeros(len(nodes), dtype=np.int32)
        for c in range(C):
            nids = cell_node_idx[cell_node_ptr[c]:cell_node_ptr[c + 1]]
            o, s = origin[c], size[c]
            bbox_c = [o[0], o[0] + s[0], o[1], o[1] + s[1], o[2], o[2] + s[2]]
            node_tag[nids] = tag_points(nodes[nids], bbox_c)
    else:
        mins, maxs = nodes.min(axis=0), nodes.max(axis=0)
        bbox = [mins[0], maxs[0], mins[1], maxs[1], mins[2], maxs[2]]
        node_tag = tag_points(nodes, bbox)

    lat = Lattice(
        config=cfg,
        nodes=nodes, node_tag=node_tag,
        edges=edges, radius=radius, edge_type=etype, edge_mat=emat,
        cell_pos=pos, cell_origin=origin, cell_size=size, cell_radii=radii_cg,
        cell_edge_ptr=cell_edge_ptr, cell_edge_idx=cell_edge_idx,
        cell_node_ptr=cell_node_ptr, cell_node_idx=cell_node_idx,
        edge_cell=ecell.astype(np.int32),
        name=name or "_".join(cfg.geom_types),
    )
    if verbose:
        lat.print_statistics_lattice()
    return lat


def _coord_greater(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Lexicographic c1 > c2 per row (for deterministic edge orientation)."""
    gt = np.zeros(len(c1), dtype=bool)
    decided = np.zeros(len(c1), dtype=bool)
    for ax in range(3):
        gt |= (~decided) & (c1[:, ax] > c2[:, ax])
        decided |= c1[:, ax] != c2[:, ax]
    return gt


def _membership_by_bbox(nodes, edges, origin, size, tol=1e-9):
    """(cell, edge) pairs where both endpoints are inside the cell bbox."""
    pairs = []
    mid = 0.5 * (nodes[edges[:, 0]] + nodes[edges[:, 1]])
    for c in range(len(origin)):
        lo = origin[c] - tol
        hi = origin[c] + size[c] + tol
        inside = np.all((nodes[edges[:, 0]] >= lo) & (nodes[edges[:, 0]] <= hi) &
                        (nodes[edges[:, 1]] >= lo) & (nodes[edges[:, 1]] <= hi) &
                        (mid >= lo) & (mid <= hi), axis=1)
        eids = np.nonzero(inside)[0]
        pairs.append(np.stack([np.full(len(eids), c), eids], axis=1))
    return np.concatenate(pairs) if pairs else np.zeros((0, 2), dtype=np.int64)


def _pairs_to_csr(pairs: np.ndarray, n_groups: int):
    """Sorted (group, item) pairs -> CSR (ptr, idx)."""
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    pairs = pairs[order]
    counts = np.bincount(pairs[:, 0], minlength=n_groups)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    return ptr.astype(np.int64), pairs[:, 1].astype(np.int32)
