"""Per-cell static condensation (Schur complements), batched on the device
(PyTorch).

The port of ``pylatticedso_tpu.ddm.schur``, which replaces the reference's
PETSc submatrix + multi-RHS LU condensation (schur_complement.py:75-146)
with a dense pipeline: assemble the cell stiffness K, split DOFs into
boundary B (the face-priority ordered boundary nodes x 6 DOFs) and
interior I, and form

    S = K_BB - K_BI  K_II^{-1}  K_IB

through a Cholesky factor (``torch.linalg.cholesky_ex``; a factor that
fails raises with the cell and its radii).  ``schur_batch`` and
``schur_batch_chained`` condense a [B, n_geom] batch of radius vectors in
one batched expression, where the JAX package ``vmap``s.  Every assembly
adds each entry's contributions in one fixed order (``SegmentSum``, no
atomics), so a condensation gives the same bits on every call.  The
discretizations and the penalized radius-grid path are host numpy, as in
the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..fem.elements import _strain_operator, edge_geometry, section_stiffness
from ..fem.operator import SegmentSum, assemble_dense
from ..sim.boundary_order import boundary_node_order
from ..sim.penalization import penalize_edges
from ..utils.timing import timing

__all__ = ["CellDiscretization", "discretize_cell", "schur_complement",
           "schur_batch", "ChainedCellDiscretization", "discretize_cell_chained",
           "schur_complement_chained", "schur_batch_chained",
           "schur_penalized_batch", "schur_fe2", "EntrySum",
           "element_entries"]


def _device(device) -> torch.device:
    from ..parallel.structured import _check_device
    return _check_device(device)


class CellDiscretization:
    """Static (radius-independent) discretization of one unit cell.

    Holds the subdivided + penalization-split mesh, per-element parent-beam
    map, penalty flags, and boundary/interior DOF indices, so that Schur
    computation over many radius vectors is a single batched dense kernel.
    ``cell_index`` names the cell in a failed factor's error.
    """

    def __init__(self, nodes, edges, parent_edge, penalized, boundary_dofs,
                 interior_dofs, edge_type, n_boundary_nodes, boundary_nodes,
                 weight=None, cell_index: Optional[int] = None):
        self.nodes = np.asarray(nodes)
        self.edges = np.asarray(edges, dtype=np.int32)
        self.parent_edge = np.asarray(parent_edge)
        self.penalized = np.asarray(penalized)
        self.edge_type = np.asarray(edge_type)
        self.boundary_dofs = np.asarray(boundary_dofs)
        self.interior_dofs = np.asarray(interior_dofs)
        self.n_boundary_nodes = n_boundary_nodes
        self.boundary_nodes = np.asarray(boundary_nodes)
        self.weight = np.ones(len(self.edges)) if weight is None else np.asarray(weight)
        self.cell_index = cell_index

    def element_radius(self, radii_per_type: torch.Tensor,
                       coefficient: float = 1.5) -> torch.Tensor:
        """Per-element radius ([..., n_elem]) from per-geometry base radii
        ([..., n_geom]) (+penalty x1.5)."""
        r = torch.as_tensor(radii_per_type)
        idx = torch.as_tensor(self.edge_type, dtype=torch.long,
                              device=r.device)
        r = r.index_select(-1, idx)
        pen = torch.as_tensor(self.penalized, dtype=torch.bool,
                              device=r.device)
        return torch.where(pen, r * coefficient, r)


def discretize_cell(lattice, cell_index: int = 0, target_h: Optional[float] = None,
                    penalization: bool = True,
                    periodicity: Optional[bool] = None,
                    l_zones: Optional[np.ndarray] = None,
                    share_weights: bool = False) -> CellDiscretization:
    """Build the condensation-ready discretization of one cell.

    ``target_h`` defaults to ``0.05 * cell_size_x`` as in the reference's
    gmsh meshing (lattice_generation.py:50-60).  ``l_zones`` may pass
    lattice-global penalization zones (the reference computes beam angles on
    the full lattice, so shared boundary nodes see neighbor-cell beams);
    default computes them from this cell's subgraph (exact for single-cell
    lattices).
    """
    from ..fem.subdivide import subdivide_edges

    c = cell_index
    eids = lattice.cell_edge_idx[lattice.cell_edge_ptr[c]:lattice.cell_edge_ptr[c + 1]]
    nids = lattice.cell_node_idx[lattice.cell_node_ptr[c]:lattice.cell_node_ptr[c + 1]]
    # compact node set of this cell
    remap = -np.ones(lattice.num_nodes, dtype=np.int64)
    remap[nids] = np.arange(len(nids))
    nodes = lattice.nodes[nids]
    edges = remap[lattice.edges[eids]].astype(np.int32)
    etype = lattice.edge_type[eids]
    radius = lattice.radius[eids]
    if share_weights:
        # partition of unity over cells: beams lying in a shared face are
        # weighted 1/multiplicity so per-cell Schur complements sum exactly
        # to the condensed global stiffness (the reference double-counts
        # such beams — a deviation we do not reproduce)
        mult = np.bincount(lattice.cell_edge_idx, minlength=lattice.num_edges)
        weight0 = 1.0 / mult[eids]
    else:
        weight0 = np.ones(len(eids))

    if periodicity is None:
        periodicity = bool((lattice.config.simulation or {}).get("periodicity", False))
    if target_h is None:
        target_h = 0.05 * lattice.config.cell_size[0]

    o = lattice.cell_origin[c]
    s = lattice.cell_size[c]
    bbox = [o[0], o[0] + s[0], o[1], o[1] + s[1], o[2], o[2] + s[2]]

    n_parent = len(edges)
    if penalization:
        lz = l_zones[eids] if l_zones is not None else None
        pen = penalize_edges(nodes, edges, radius, periodicity=periodicity,
                             l_zones=lz)
        nodes2, edges2 = pen.nodes, pen.edges
        parent = pen.parent_edge
        mod = pen.penalized
    else:
        nodes2, edges2 = nodes, edges
        parent = np.arange(n_parent)
        mod = np.zeros(n_parent, dtype=bool)

    nodes3, edges3, seg_parent = subdivide_edges(nodes2, edges2, target_h)[:3]
    parent3 = parent[seg_parent]
    mod3 = mod[seg_parent]
    etype3 = etype[parent3]
    weight3 = weight0[parent3]

    # boundary nodes of the ORIGINAL cell graph, in simulation order
    b_nodes = boundary_node_order(nodes, bbox)
    b_dofs = (b_nodes[:, None] * 6 + np.arange(6)).reshape(-1)
    all_dofs = np.arange(6 * len(nodes3))
    i_dofs = np.setdiff1d(all_dofs, b_dofs)

    return CellDiscretization(
        nodes=nodes3, edges=edges3, parent_edge=parent3, penalized=mod3,
        boundary_dofs=b_dofs, interior_dofs=i_dofs, edge_type=etype3,
        n_boundary_nodes=len(b_nodes), boundary_nodes=b_nodes, weight=weight3,
        cell_index=c,
    )


def _condense(K: torch.Tensor, B: np.ndarray, I: np.ndarray, what: str,
              radii: torch.Tensor) -> torch.Tensor:
    """S = K_BB - K_BI K_II^-1 K_IB of K [..., n, n]; raises when a
    factor of K_II fails (``what`` and ``radii`` name the cell)."""
    Bt = torch.as_tensor(B, dtype=torch.long, device=K.device)
    K_BB = K[..., Bt, :][..., Bt]
    if I.size == 0:
        return K_BB
    It = torch.as_tensor(I, dtype=torch.long, device=K.device)
    K_BI = K[..., Bt, :][..., It]
    K_II = K[..., It, :][..., It]
    L, info = torch.linalg.cholesky_ex(K_II)
    S = K_BB - K_BI @ torch.cholesky_solve(K_BI.transpose(-1, -2), L)
    # one check (one host sync) for a failed factor or a non-finite S
    bad = ((info != 0) | ~torch.isfinite(S).all(-1).all(-1)).reshape(-1)
    if bool(bad.any()):
        bad = torch.nonzero(bad).reshape(-1).tolist()
        raise ValueError(
            f"Schur condensation of {what}: the interior stiffness is not "
            f"positive definite (Cholesky info {info.reshape(-1)[bad].tolist()}"
            f") at radii {radii.reshape(-1, radii.shape[-1])[bad].tolist()}")
    return S


def schur_complement(disc: CellDiscretization, radii_per_type, E, nu,
                     dtype=torch.float64, device="cuda") -> torch.Tensor:
    """Dense Schur complement [n_b, n_b] for one radius vector, on
    ``device``."""
    dev = _device(device)
    radii = torch.as_tensor(np.asarray(radii_per_type, dtype=float)
                            if not isinstance(radii_per_type, torch.Tensor)
                            else radii_per_type, dtype=dtype, device=dev)
    r_elem = disc.element_radius(radii)
    K = assemble_dense(disc.nodes, disc.edges, r_elem, E, nu,
                       weight=disc.weight, dtype=dtype, device=dev)
    return _condense(K, disc.boundary_dofs, disc.interior_dofs,
                     f"cell {disc.cell_index}", radii)


class EntrySum:
    """Dense [..., n, n] assembly of values [..., M] added at the flat
    entries ``rows * n + cols``: each distinct entry's contributions added
    in ascending order (``SegmentSum`` over the distinct entries, no
    atomics), the bits of a sequential scatter-add such as
    ``K.at[rows, cols].add``, then written once each."""

    def __init__(self, rows: np.ndarray, cols: np.ndarray, n: int, device):
        flat = np.asarray(rows, dtype=np.int64) * n + np.asarray(cols)
        entry, inverse = np.unique(flat, return_inverse=True)
        self.n = n
        self.entry = torch.as_tensor(entry, device=device)
        self.sum = SegmentSum(torch.as_tensor(inverse, device=device),
                              len(entry))

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        lead = values.shape[:-1]
        K = values.new_zeros((*lead, self.n * self.n))
        K[..., self.entry] = self.sum(values, dim=len(lead))
        return K.reshape(*lead, self.n, self.n)


def element_entries(edges: np.ndarray, n_nodes: int, device) -> EntrySum:
    """The assembly of [..., E, 12, 12] element matrices (flattened to
    [..., E * 144]) on the graph ``edges`` into the [6N, 6N] stiffness:
    the JAX package's ``K.at[rows, cols].add`` order (element, row, col)."""
    e = np.asarray(edges, dtype=np.int64)
    dof = np.concatenate([e[:, :1] * 6 + np.arange(6),
                          e[:, 1:] * 6 + np.arange(6)], axis=1)   # [E, 12]
    rows = np.repeat(dof, 12, axis=1).reshape(-1)
    cols = np.tile(dof, (1, 12)).reshape(-1)
    return EntrySum(rows, cols, 6 * n_nodes, device)


def _element_stiffness_batch(nodes: torch.Tensor, edges: torch.Tensor,
                             radius: torch.Tensor, E, nu) -> torch.Tensor:
    """[B, E, 12, 12] element stiffness for radii [B, E] on one geometry
    (``element_stiffness_dense`` at each row of ``radius``)."""
    geom = edge_geometry(nodes, edges)
    D = section_stiffness(radius, E, nu).D                  # [B, E, 6]
    Bm = _strain_operator(geom)                             # [E, 6, 12]
    return torch.einsum("ekl,bek,ekm->belm", Bm, D * geom.L[:, None], Bm)


def schur_batch(disc: CellDiscretization, radii_batch, E, nu,
                dtype=torch.float64, device="cuda") -> torch.Tensor:
    """Condensation over a [n_samples, n_geom] radius batch, one batched
    expression: [n_samples, n_b, n_b]."""
    dev = _device(device)
    radii = torch.as_tensor(np.asarray(radii_batch, dtype=float),
                            dtype=dtype, device=dev)
    nodes = torch.as_tensor(disc.nodes, dtype=dtype, device=dev)
    edges = torch.as_tensor(disc.edges, dtype=torch.long, device=dev)
    Ke = _element_stiffness_batch(nodes, edges, disc.element_radius(radii),
                                  E, nu)
    Ke = Ke * torch.as_tensor(disc.weight, dtype=dtype,
                              device=dev)[:, None, None]
    K = element_entries(disc.edges, len(disc.nodes), dev)(
        Ke.reshape(Ke.shape[0], -1))
    return _condense(K, disc.boundary_dofs, disc.interior_dofs,
                     f"cell {disc.cell_index}", radii)


# ---------------------------------------------------------------------------
# Chained condensation: exploit that the reference's subdivision (gmsh rule,
# ceil(L/0.05) collinear segments per strut) only adds interior nodes along
# straight uniform chains.  Eliminating those chain nodes per beam FIRST is
# algebraically exact (Schur of a Schur is the Schur), reduces the final
# interior block from thousands of DOFs to the cell's junction nodes, and —
# because all segments of a beam are identical — costs O(log n) 6x6 solves
# per beam via binary doubling.  This makes dense radius-grid sweeps for the
# surrogate offline stage (lattice_sim.py:846-919) ~1000x cheaper with
# machine-precision agreement.
# ---------------------------------------------------------------------------
class ChainedCellDiscretization:
    """Parent-graph discretization with per-beam segment counts."""

    def __init__(self, nodes, edges, edge_type, weight, n_seg,
                 boundary_dofs, interior_dofs, n_boundary_nodes,
                 boundary_nodes, cell_index: Optional[int] = None):
        self.nodes = np.asarray(nodes)
        self.edges = np.asarray(edges, dtype=np.int32)
        self.edge_type = np.asarray(edge_type)
        self.weight = np.asarray(weight)
        self.n_seg = np.asarray(n_seg, dtype=np.int64)
        self.boundary_dofs = np.asarray(boundary_dofs)
        self.interior_dofs = np.asarray(interior_dofs)
        self.n_boundary_nodes = n_boundary_nodes
        self.boundary_nodes = np.asarray(boundary_nodes)
        self.cell_index = cell_index


def discretize_cell_chained(lattice, cell_index: int = 0,
                            target_h: Optional[float] = None,
                            periodicity: Optional[bool] = None,
                            share_weights: bool = False) -> ChainedCellDiscretization:
    """Chained-condensation twin of ``discretize_cell`` (penalization-free:
    a penalized beam's end zones break segment uniformity)."""
    from ..fem.subdivide import segment_counts

    c = cell_index
    eids = lattice.cell_edge_idx[lattice.cell_edge_ptr[c]:lattice.cell_edge_ptr[c + 1]]
    nids = lattice.cell_node_idx[lattice.cell_node_ptr[c]:lattice.cell_node_ptr[c + 1]]
    remap = -np.ones(lattice.num_nodes, dtype=np.int64)
    remap[nids] = np.arange(len(nids))
    nodes = lattice.nodes[nids]
    edges = remap[lattice.edges[eids]].astype(np.int32)
    etype = lattice.edge_type[eids]
    if share_weights:
        mult = np.bincount(lattice.cell_edge_idx, minlength=lattice.num_edges)
        weight = 1.0 / mult[eids]
    else:
        weight = np.ones(len(eids))
    if target_h is None:
        target_h = 0.05 * lattice.config.cell_size[0]
    lengths = np.linalg.norm(nodes[edges[:, 1]] - nodes[edges[:, 0]], axis=1)
    n_seg = segment_counts(lengths, target_h)

    o = lattice.cell_origin[c]
    s = lattice.cell_size[c]
    bbox = [o[0], o[0] + s[0], o[1], o[1] + s[1], o[2], o[2] + s[2]]
    b_nodes = boundary_node_order(nodes, bbox)
    b_dofs = (b_nodes[:, None] * 6 + np.arange(6)).reshape(-1)
    i_dofs = np.setdiff1d(np.arange(6 * len(nodes)), b_dofs)
    return ChainedCellDiscretization(nodes, edges, etype, weight, n_seg,
                                     b_dofs, i_dofs, len(b_nodes), b_nodes,
                                     cell_index=c)


def _chain_combine(KA: torch.Tensor, KB: torch.Tensor) -> torch.Tensor:
    """Concatenate two chain end-stiffness blocks [..., 12, 12], eliminating
    the shared middle node (6 DOF)."""
    M = KA[..., 6:, 6:] + KB[..., :6, :6]
    # a singular M (a zero radius) leaves non-finite values, which the
    # junction condensation reports with the cell and its radii
    XA = torch.linalg.solve_ex(M, KA[..., 6:, :6])[0]   # [..., 6, 6]
    XB = torch.linalg.solve_ex(M, KB[..., :6, 6:])[0]
    Kaa = KA[..., :6, :6] - KA[..., :6, 6:] @ XA
    Kab = -KA[..., :6, 6:] @ XB
    Kba = -KB[..., 6:, :6] @ XA
    Kbb = KB[..., 6:, 6:] - KB[..., 6:, :6] @ XB
    top = torch.cat([Kaa, Kab], dim=-1)
    bot = torch.cat([Kba, Kbb], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _chain_power(k_seg: torch.Tensor, n: int) -> torch.Tensor:
    """End-stiffness of n identical segments in series (binary doubling;
    chain concatenation is associative)."""
    result = None
    P = k_seg
    while n:
        if n & 1:
            result = P if result is None else _chain_combine(result, P)
        n >>= 1
        if n:
            P = _chain_combine(P, P)
    return result


@timing.timeit(category="ddm")
def schur_batch_chained(disc: ChainedCellDiscretization, radii_batch, E, nu,
                        dtype=torch.float64, device="cuda") -> torch.Tensor:
    """Chained condensation over a [n_samples, n_geom] radius batch, one
    batched expression: [n_samples, n_b, n_b].

    Matches ``schur_batch`` on the subdivided mesh to machine precision
    (same discretization, different — exact — elimination order), at
    O(junction DOFs) instead of O(subdivided DOFs) dense cost.
    """
    dev = _device(device)
    radii = torch.as_tensor(np.asarray(radii_batch, dtype=float)
                            if not isinstance(radii_batch, torch.Tensor)
                            else radii_batch, dtype=dtype, device=dev)
    nodes = torch.as_tensor(disc.nodes, dtype=dtype, device=dev)
    edges = torch.as_tensor(disc.edges, dtype=torch.long, device=dev)
    r_elem = radii.index_select(
        -1, torch.as_tensor(disc.edge_type, dtype=torch.long, device=dev))

    # per-parent segment element: endpoints at a and a + (b - a)/n
    pa = nodes[edges[:, 0]]
    pb = nodes[edges[:, 1]]
    n_seg = disc.n_seg
    seg_b = pa + (pb - pa) / torch.as_tensor(n_seg, dtype=dtype,
                                             device=dev)[:, None]
    seg_nodes = torch.cat([pa, seg_b], dim=0)
    P = edges.shape[0]
    ar = torch.arange(P, device=dev)
    seg_edges = torch.stack([ar, ar + P], dim=1)
    k_seg = _element_stiffness_batch(seg_nodes, seg_edges, r_elem, E, nu)

    # group parents by segment count -> one doubling per unique n
    K_eff = torch.zeros_like(k_seg)
    for n in np.unique(n_seg):
        idx = torch.as_tensor(np.nonzero(n_seg == n)[0], device=dev)
        K_eff[:, idx] = _chain_power(k_seg[:, idx], int(n))
    K_eff = K_eff * torch.as_tensor(disc.weight, dtype=dtype,
                                    device=dev)[:, None, None]

    # assemble the junction-level stiffness (an ordered sum per flat
    # entry rows * 6N + cols) and condense its interior
    K = element_entries(disc.edges, len(disc.nodes), dev)(
        K_eff.reshape(radii.shape[0], -1))
    return _condense(K, disc.boundary_dofs, disc.interior_dofs,
                     f"cell {disc.cell_index} (chained)", radii)


def schur_complement_chained(disc: ChainedCellDiscretization, radii_per_type,
                             E, nu, dtype=torch.float64,
                             device="cuda") -> torch.Tensor:
    """Schur complement [n_b, n_b] via per-beam chain condensation (the
    batch of one radius vector)."""
    r = radii_per_type
    r = r[None] if isinstance(r, torch.Tensor) \
        else np.asarray(r, dtype=float)[None]
    return schur_batch_chained(disc, r, E, nu, dtype=dtype, device=device)[0]


# ---------------------------------------------------------------------------
# Penalized radius-grid condensation (host, float64 numpy).
#
# The reference's Schur datasets are computed on PENALIZED cells: its
# dataset script re-applies set_penalized_beams for every radius sample
# (examples/simulation/construct_schur_complement_dataset.py +
# lattice_sim.py:1480-1500), so zone lengths L = r/tan(theta/2) — and hence
# the discretization — change per sample.  A penalized beam is still a
# straight chain (zone | core | zone, each uniformly subdivided), so the
# chained elimination applies piecewise: per-piece binary doubling, two
# 12x12 combines per beam, then the junction-level Schur.  Per-sample
# topology varies (ceil(L_piece/h)), so this path runs in plain numpy f64,
# as in the JAX package.
# ---------------------------------------------------------------------------
def _np_element_stiffness(vec: np.ndarray, radius: np.ndarray, E, nu,
                          kappa: float = 0.9) -> np.ndarray:
    """[P,12,12] Timoshenko element stiffness from edge vectors (numpy port
    of fem.elements.element_stiffness_dense)."""
    L = np.linalg.norm(vec, axis=1)
    t = vec / L[:, None]
    ez = np.array([0.0, 0.0, 1.0])
    ex = np.array([1.0, 0.0, 0.0])
    ref = np.where((np.abs(t @ ez) > 0.99)[:, None], ex, ez)
    a1 = np.cross(ref, t)
    a1 = a1 / np.linalg.norm(a1, axis=1)[:, None]
    a2 = np.cross(t, a1)
    G = E / (2.0 * (1.0 + nu))
    S = np.pi * radius**2
    I = np.pi * radius**4 / 4.0
    D = np.stack([E * S, kappa * G * S, kappa * G * S,
                  G * 2.0 * I, E * I, E * I], axis=-1)      # [P,6]
    invL = (1.0 / L)[:, None]
    z = np.zeros_like(t)
    rows = [
        np.concatenate([-t * invL, z, t * invL, z], axis=1),
        np.concatenate([-a1 * invL, -a2 * 0.5, a1 * invL, -a2 * 0.5], axis=1),
        np.concatenate([-a2 * invL, a1 * 0.5, a2 * invL, a1 * 0.5], axis=1),
        np.concatenate([z, -t * invL, z, t * invL], axis=1),
        np.concatenate([z, -a1 * invL, z, a1 * invL], axis=1),
        np.concatenate([z, -a2 * invL, z, a2 * invL], axis=1),
    ]
    B = np.stack(rows, axis=1)                               # [P,6,12]
    return np.einsum("pkl,pk,pkm->plm", B, D * L[:, None], B)


def _np_chain_combine(KA: np.ndarray, KB: np.ndarray) -> np.ndarray:
    """Batched chain concatenation (numpy twin of _chain_combine)."""
    M = KA[..., 6:, 6:] + KB[..., :6, :6]
    XA = np.linalg.solve(M, KA[..., 6:, :6])
    XB = np.linalg.solve(M, KB[..., :6, 6:])
    Kaa = KA[..., :6, :6] - KA[..., :6, 6:] @ XA
    Kab = -KA[..., :6, 6:] @ XB
    Kba = -KB[..., 6:, :6] @ XA
    Kbb = KB[..., 6:, 6:] - KB[..., 6:, :6] @ XB
    top = np.concatenate([Kaa, Kab], axis=-1)
    bot = np.concatenate([Kba, Kbb], axis=-1)
    return np.concatenate([top, bot], axis=-2)


def _np_chain_power(k: np.ndarray, n: int) -> np.ndarray:
    result = None
    P = k
    while n:
        if n & 1:
            result = P if result is None else _np_chain_combine(result, P)
        n >>= 1
        if n:
            P = _np_chain_combine(P, P)
    return result


@timing.timeit(category="ddm")
def schur_penalized_batch(lattice, radii_batch, E, nu, cell_index: int = 0,
                          target_h: Optional[float] = None,
                          periodicity: Optional[bool] = None,
                          share_weights: bool = True,
                          coefficient: float = 1.5) -> np.ndarray:
    """[B, m, m] penalized Schur complements over a radius grid.

    Reproduces the reference's dataset semantics: per sample, every beam is
    split into 1.5x-radius end zones of length L_zone(mu) and a core, each
    piece gmsh-subdivided (ceil(L/h)), then condensed to the cell boundary.
    Matches discretize_cell(penalization=True) + schur_complement to
    machine precision at ~1/1000 the cost per sample.
    """
    from ..sim.penalization import lzone_coefficients

    disc = discretize_cell_chained(lattice, cell_index, target_h=target_h,
                                   share_weights=share_weights)
    if periodicity is None:
        periodicity = bool((lattice.config.simulation or {}).get("periodicity",
                                                                 False))
    if target_h is None:
        target_h = 0.05 * lattice.config.cell_size[0]
    G = lattice.config.n_geom
    coefs, floor = lzone_coefficients(disc.nodes, disc.edges, disc.edge_type,
                                      G, periodicity=periodicity)

    nodes, edges, etype = disc.nodes, disc.edges, disc.edge_type
    P = len(edges)
    pa = nodes[edges[:, 0]]
    pb = nodes[edges[:, 1]]
    # reference zone placement uses the 4-decimal-rounded length direction
    len_round = np.round(np.linalg.norm(pb - pa, axis=1), 4)
    t_dir = (pb - pa) / len_round[:, None]

    B_n = nodes.shape[0]
    dof = np.concatenate([edges[:, :1] * 6 + np.arange(6),
                          edges[:, 1:] * 6 + np.arange(6)], axis=1)  # [P,12]
    rows = np.repeat(dof, 12, axis=1).reshape(-1)
    cols = np.tile(dof, (1, 12)).reshape(-1)
    Bd, Id = disc.boundary_dofs, disc.interior_dofs

    out = []
    for mu in np.asarray(radii_batch, dtype=np.float64):
        r_e = mu[etype]
        lz = np.maximum((coefs * mu[None, None, :]).max(axis=2), floor)
        # piece endpoints and radii (up to 3 per parent, penalize_edges
        # semantics: zone A | core | zone B)
        piece_vec, piece_r, piece_parent = [], [], []
        for e in range(P):
            L1, L2 = lz[e]
            r = r_e[e]
            a_pt, b_pt, td = pa[e], pb[e], t_dir[e]
            start = a_pt
            if L1 <= 0 and L2 <= 0:
                piece_vec.append(b_pt - a_pt); piece_r.append(r)
                piece_parent.append(e)
                continue
            if L1 > 0:
                m1 = a_pt + L1 * td
                piece_vec.append(m1 - a_pt); piece_r.append(r * coefficient)
                piece_parent.append(e)
                start = m1
            if L2 > 0:
                m2 = b_pt - L2 * td
                piece_vec.append(m2 - start); piece_r.append(r)
                piece_parent.append(e)
                piece_vec.append(b_pt - m2); piece_r.append(r * coefficient)
                piece_parent.append(e)
            else:
                piece_vec.append(b_pt - start); piece_r.append(r)
                piece_parent.append(e)
        piece_vec = np.asarray(piece_vec)
        piece_r = np.asarray(piece_r)
        piece_parent = np.asarray(piece_parent)
        plen = np.linalg.norm(piece_vec, axis=1)
        n_seg = np.maximum(1, np.ceil(plen / target_h)).astype(np.int64)

        k_seg = _np_element_stiffness(
            piece_vec / n_seg[:, None], piece_r, E, nu)
        # chain power grouped by segment count
        K_piece = np.empty_like(k_seg)
        for n in np.unique(n_seg):
            idx = np.nonzero(n_seg == n)[0]
            K_piece[idx] = _np_chain_power(k_seg[idx], int(n))
        # fold pieces per parent (in order: they were appended a->b)
        K_eff = np.empty((P, 12, 12))
        ptr = 0
        # pieces are contiguous per parent in construction order
        counts = np.bincount(piece_parent, minlength=P)
        for e in range(P):
            c = counts[e]
            Ke = K_piece[ptr]
            for j in range(1, c):
                Ke = _np_chain_combine(Ke, K_piece[ptr + j])
            K_eff[e] = Ke
            ptr += c
        K_eff = K_eff * disc.weight[:, None, None]

        K = np.zeros((6 * B_n, 6 * B_n))
        np.add.at(K, (rows, cols), K_eff.reshape(-1))
        K_BB = K[np.ix_(Bd, Bd)]
        if Id.size:
            K_BI = K[np.ix_(Bd, Id)]
            K_II = K[np.ix_(Id, Id)]
            S = K_BB - K_BI @ np.linalg.solve(K_II, K_BI.T)
        else:
            S = K_BB
        out.append(S)
    return np.stack(out)


def schur_fe2(lattice, cell_index: int, material, target_h: Optional[float] = None,
              tol: float = 1e-13, device="cuda") -> np.ndarray:
    """Cell Schur complement via inner FEM solves — the FE2 mode.

    The reference's ``schur_complement_computation.type = "FE2"``
    (lattice_sim.py:113,130,1238) applies the interface operator by solving
    the cell's full FEM subproblem under the current boundary displacements
    (solve_sub_problem -> solve_FEM_cell, utils_simulation.py:58-82) on
    EVERY CG iteration.  For a linear cell that operator IS a matrix, so
    it is assembled once per unique cell group: column j = boundary
    reactions under a unit displacement on boundary DOF j, computed through
    ``solve_fem_cell`` on ``device`` — a genuinely independent route from
    the algebraic condensation (no penalization, matching the reference's
    FE2 semantics: its set_penalized_beams runs only for type "exact",
    lattice_sim.py:119-123).
    """
    from ..sim.utils_simulation import solve_fem_cell

    c = cell_index
    nids = lattice.cell_node_idx[lattice.cell_node_ptr[c]:lattice.cell_node_ptr[c + 1]]
    o, s = lattice.cell_origin[c], lattice.cell_size[c]
    bbox = [o[0], o[0] + s[0], o[1], o[1] + s[1], o[2], o[2] + s[2]]
    b_local = boundary_node_order(lattice.nodes[nids], bbox)
    nb = len(b_local)
    m = 6 * nb
    S = np.zeros((m, m))
    for j in range(m):
        ub = np.zeros((nb, 6))
        ub[j // 6, j % 6] = 1.0
        res = solve_fem_cell(lattice, c, ub, material=material,
                             target_h=target_h, tol=tol, device=device)
        S[:, j] = np.asarray(res.reaction)[b_local].reshape(-1)
    return 0.5 * (S + S.T)
