"""Domain-decomposition (cell-wise Schur) interface solver (PyTorch).

The port of ``pylatticedso_tpu.ddm.solver``, the reference's flagship path
(stack 3.3 of SURVEY.md): interior DOFs of every cell are condensed away;
the global system lives on the interface (cell-boundary) DOFs and is solved
matrix-free with PCG, where one operator application is

    r = sum_cells  scatter( S_cell @ gather(u, boundary nodes of cell) )

(lattice_sim.py:1111-1252, conjugate_gradient_solver.py:15).  The per-cell
loop is a batched product per Schur group (``torch.matmul``) and a per-node
sum in a fixed order (``SegmentSum``, no atomics), so an application gives
the same bits on every call, on the card and on the CPU.

Schur matrices are computed once per unique cell group (mirroring the
reference's caching by radii tuple, lattice_sim.py:846-919) or supplied by
a surrogate.  The condensation runs in float64 on the system's device (the
card has native float64; the JAX package condenses on the host CPU because
a TPU emulates it); the operator's device copies are in ``dtype`` (default
float32 on a CUDA device, float64 on the CPU) and host float64 copies stay
for the refined solve's residuals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..design.lattice import Lattice
from ..materials import MatProperties
from ..fem.bc import BCArrays, apply_boundary_conditions
from ..fem.operator import SegmentSum
from ..fem.solve import pcg, refined_solve
from ..sim.boundary_order import boundary_node_order
from ..sim.penalization import compute_l_zones
from .schur import discretize_cell, schur_complement

__all__ = ["DDMSystem", "build_ddm_system", "solve_ddm", "DDMResult"]


@dataclass
class DDMResult:
    u: np.ndarray            # [N,6] interface displacements (0 at interior nodes)
    reaction: np.ndarray     # [N,6]
    compliance: float
    iterations: int
    residual: float


def _host(S) -> np.ndarray:
    """A Schur block (a tensor on any device, or an array) as numpy."""
    if isinstance(S, torch.Tensor):
        return S.detach().cpu().numpy()
    return np.asarray(S)


class DDMSystem:
    """Assembled interface operator data.

    S_np[g]: host copy of group g's Schur [m_g, m_g] (m_g = 6 * nb_g) at
    its source precision; S[g]: its device copy in ``dtype``.
    cells_of_group[g]: int array of cell ids.
    bn_list: per-cell boundary-node ids in simulation order — cells of
    different topologies (trimmed/bone-shaped hybrids,
    lattice_sim.py:1227-1252) may have different boundary-node counts; the
    operator batches per GROUP (``bn_groups[g]``: [C_g, nb_g]), so
    raggedness across groups costs nothing.
    """

    def __init__(self, lattice: Lattice, S_groups, cell_group, cell_bnodes,
                 bc: BCArrays, dtype=None, device="cuda"):
        from ..parallel.structured import _check_device
        dev = _check_device(device)
        self.lattice = lattice
        self.n_nodes = lattice.num_nodes
        # host copies at source precision (f64): the refined solve
        # rebuilds a high-precision operator from these for its residuals
        self.S_np = [_host(S) for S in S_groups]
        self.S = [torch.tensor(S, dtype=dtype, device=dev)
                  for S in self.S_np]
        self.cell_group = np.asarray(cell_group)
        self.cells_of_group = [np.nonzero(self.cell_group == g)[0]
                               for g in range(len(S_groups))]
        bn_list = [np.asarray(b) for b in cell_bnodes]
        #: per-cell boundary-node ids in simulation order (ragged) — the
        #: per-group surrogate optimizer regroups these by topology
        self.bn_list = bn_list
        nbs = {len(b) for b in bn_list}
        self.homogeneous = len(nbs) == 1
        if self.homogeneous:
            self.nb = nbs.pop()
            self.m = 6 * self.nb
            self.cell_bnodes = torch.as_tensor(np.stack(bn_list),
                                               dtype=torch.long, device=dev)
        else:
            self.nb = self.m = None
            self.cell_bnodes = None
        #: per-group [C_g, nb_g] boundary-node ids — the batched operator's
        #: gather/scatter maps, and their per-node sums in a fixed order
        self.bn_groups = [
            torch.as_tensor(np.stack([bn_list[c] for c in cells]),
                            dtype=torch.long, device=dev)
            for cells in self.cells_of_group]
        self.node_sums = [SegmentSum(bn.reshape(-1), self.n_nodes)
                          for bn in self.bn_groups]
        fdt = self.S[0].dtype

        interface = np.zeros(self.n_nodes, dtype=bool)
        interface[np.concatenate([b.reshape(-1) for b in bn_list])] = True
        self.interface_nodes = interface
        # the loads at source precision too: the refined solve's residuals
        # and its reactions take them unrounded (a float32-rounded load
        # moves u by ~5e-8 relative, above the solve's tolerance)
        self.u_imposed_np = np.asarray(bc.u_imposed, dtype=float)
        self.f_applied_np = np.asarray(bc.f_applied * interface[:, None],
                                       dtype=float)
        as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=float),
                                         dtype=fdt, device=dev)
        self.free = as_t(interface[:, None] & ~bc.fixed)
        self.u_imposed = as_t(self.u_imposed_np)
        self.f_applied = as_t(self.f_applied_np)

    # ------------------------------------------------------------------
    def matvec(self, u: torch.Tensor, S_list=None) -> torch.Tensor:
        """Assembled-Schur action K_interface @ u on [N,6] fields."""
        S_list = self.S if S_list is None else S_list
        out = torch.zeros((self.n_nodes, 6), dtype=u.dtype, device=u.device)
        for g, (bn, seg) in enumerate(zip(self.bn_groups, self.node_sums)):
            Cg, nbg = bn.shape
            Ub = seg.gather(u).reshape(Cg, 6 * nbg)          # [C_g, m_g]
            # [C_g, m_g] @ [m_g, m_g] (S symmetric)
            contrib = torch.matmul(Ub, S_list[g]).reshape(-1, 6)
            out = out + seg(contrib)
        return out

    def hi_operator(self, dtype=torch.float64) -> Tuple[Callable, torch.Tensor]:
        """(A_hi, b_hi): the masked interface operator and rhs rebuilt at
        high precision from the source (f64) Schur groups and loads — the
        residual oracle for the refined solve (fem.solve.refined_solve)."""
        dev = self.free.device
        S_hi = [torch.tensor(s, dtype=dtype, device=dev) for s in self.S_np]
        free = self.free.to(dtype)
        u_imp = torch.tensor(self.u_imposed_np, dtype=dtype, device=dev)
        f_app = torch.tensor(self.f_applied_np, dtype=dtype, device=dev)

        def A_hi(u):
            return free * self.matvec(free * u, S_hi) + (1.0 - free) * u

        b_hi = free * (f_app - self.matvec(u_imp, S_hi)) \
            + (1.0 - free) * u_imp
        return A_hi, b_hi

    def diagonal(self) -> torch.Tensor:
        """diag of the assembled interface operator, [N,6]."""
        S0 = self.S[0]
        out = torch.zeros((self.n_nodes, 6), dtype=S0.dtype, device=S0.device)
        for g, (bn, seg) in enumerate(zip(self.bn_groups, self.node_sums)):
            d = torch.diagonal(self.S[g]).reshape(-1, 6)      # [nb_g, 6]
            contrib = d.repeat(bn.shape[0], 1)
            out = out + seg(contrib)
        return out

    def node_blocks(self) -> torch.Tensor:
        """Assembled per-node 6x6 diagonal blocks, [N,6,6] (block-Jacobi data).

        The analogue of the reference's assembled B^T S B preconditioner
        (cell.py:754-827, lattice_sim.py:1351-1415): instead of a global
        sparse LU, invert the node-diagonal blocks.
        """
        S0 = self.S[0]
        out = torch.zeros((self.n_nodes, 6, 6), dtype=S0.dtype,
                          device=S0.device)
        for g, (bn, seg) in enumerate(zip(self.bn_groups, self.node_sums)):
            nbg = bn.shape[1]
            Sg = self.S[g].reshape(nbg, 6, nbg, 6)
            blocks = torch.diagonal(Sg, dim1=0, dim2=2).permute(2, 0, 1)
            contrib = blocks.repeat(bn.shape[0], 1, 1)
            out = out + seg(contrib)
        return out

    # ------------------------------------------------------------------
    def masked(self) -> Callable:
        fm = self.free
        return lambda u: fm * self.matvec(fm * u) + (1.0 - fm) * u

    def rhs(self) -> torch.Tensor:
        return self.free * (self.f_applied - self.matvec(self.u_imposed)) \
            + (1.0 - self.free) * self.u_imposed

    def preconditioner(self, kind: str = "block_jacobi") -> Callable:
        # the reference's config names map onto the assembled-block scheme:
        # "mean"/"nearest_reference" approximate per-cell Schur blocks before
        # assembling B^T S B (lattice_sim.py:1312-1415); our node-block
        # Jacobi assembles the exact blocks, strictly tighter than both
        if kind in ("mean", "nearest_reference", "exact", "LU", "ILU"):
            kind = "block_jacobi"
        if kind in (None, "none"):
            return lambda r: r
        if kind == "jacobi":
            d = self.free * self.diagonal() + (1.0 - self.free)
            d = torch.where(d == 0, torch.ones_like(d), d)
            return lambda r: r / d
        if kind == "block_jacobi":
            blocks = self.node_blocks()
            fm = self.free  # [N,6]
            # zero rows/cols of fixed dofs, identity there to stay SPD
            B = blocks * fm[:, :, None] * fm[:, None, :]
            eye = torch.eye(6, dtype=B.dtype, device=B.device)
            B = B + (1.0 - fm)[:, :, None] * eye[None] * (1.0 - fm)[:, None, :]
            # non-interface nodes: identity
            B = torch.where((torch.abs(B).sum((1, 2)) == 0)[:, None, None],
                            eye[None], B)
            # inverted on the host, one-time setup, as the JAX package does
            # (the same numpy inverse gives the same bits)
            Binv = torch.as_tensor(np.linalg.inv(B.cpu().numpy()),
                                   dtype=B.dtype, device=B.device)
            return lambda r: torch.einsum("nij,nj->ni", Binv, r)
        raise ValueError(f"unknown preconditioner {kind!r}")


def _schur_groups(lattice: Lattice, material: MatProperties,
                  penalization: bool, periodicity: bool,
                  target_h: Optional[float], device,
                  schur_provider: Optional[Callable] = None,
                  share_weights: bool = True, fe2: bool = False):
    """Compute one Schur complement per unique cell group.

    Group key: (radii, cell size) like the reference's cache
    (lattice_sim.py:853-861), PLUS the per-cell penalization L-zone and
    shared-beam-weight signatures.  The extra keys make the grouped DDM
    *algebraically exact* — boundary cells whose joints are penalized
    differently get their own condensation, where the reference reuses one
    representative per (geom, radii) and incurs an interface error.

    The condensation runs in float64 on ``device`` whatever the system's
    dtype: the refined interface solve's residual oracle
    (DDMSystem.hi_operator) is only as accurate as the source S.
    """
    compute_dtype = torch.float64

    l_zones = None
    if penalization:
        l_zones = compute_l_zones(lattice.nodes, lattice.edges, lattice.radius,
                                  periodicity=periodicity)
    mult = np.bincount(lattice.cell_edge_idx, minlength=lattice.num_edges)

    def cell_signature(c):
        eids = lattice.cell_edge_idx[lattice.cell_edge_ptr[c]:lattice.cell_edge_ptr[c + 1]]
        nids = lattice.cell_node_idx[lattice.cell_node_ptr[c]:lattice.cell_node_ptr[c + 1]]
        o, s = lattice.cell_origin[c], lattice.cell_size[c]
        # the full LOCAL subgraph, not just (radii, size): trimmed/hybrid
        # lattices have cells sharing radii and size but different beam
        # sets (lattice_sim.py:1227-1252 loops per cell; we group exactly)
        remap = np.zeros(lattice.num_nodes, dtype=np.int64)
        remap[nids] = np.arange(len(nids))
        local_edges = remap[lattice.edges[eids]]
        rel_nodes = np.round((lattice.nodes[nids] - o) / s, 9)
        sig = [tuple(np.round(lattice.cell_radii[c], 8)),
               tuple(np.round(lattice.cell_size[c], 9)),
               tuple(mult[eids]),
               rel_nodes.tobytes(), local_edges.tobytes(),
               np.round(lattice.radius[eids], 9).tobytes()]
        if l_zones is not None:
            sig.append(np.round(l_zones[eids], 9).tobytes())
        return tuple(sig)

    sig_to_group: Dict = {}
    group_of_cell = np.zeros(lattice.num_cells, dtype=np.int64)
    reps = []
    for c in range(lattice.num_cells):
        s = cell_signature(c)
        if s not in sig_to_group:
            sig_to_group[s] = len(reps)
            reps.append(c)
        group_of_cell[c] = sig_to_group[s]

    S_list = []
    for rep in reps:
        if schur_provider is not None:
            S = _host(schur_provider(lattice.cell_radii[rep]))
        elif fe2:
            # FE2 mode: the operator column-assembled by inner FEM solves
            # (schur.schur_fe2) — cached per group where the reference
            # re-solves the cell on every CG iteration (lattice_sim.py:1238)
            from .schur import schur_fe2
            S = schur_fe2(lattice, rep, material, target_h=target_h,
                          device=device)
        elif not penalization:
            # chained condensation (per-beam binary-doubling elimination of
            # the subdivision chain, then a junction-level Schur): equal to
            # the dense path to machine precision at ~1/1000 the cost —
            # penalized cells stay on the dense path because lattice-global
            # L-zones break per-beam segment uniformity
            from .schur import discretize_cell_chained, schur_complement_chained
            disc_c = discretize_cell_chained(
                lattice, rep, target_h=target_h, periodicity=periodicity,
                share_weights=share_weights)
            S = _host(schur_complement_chained(
                disc_c, lattice.cell_radii[rep],
                material.young_modulus, material.poisson_ratio,
                dtype=compute_dtype, device=device))
        else:
            disc = discretize_cell(lattice, rep, target_h=target_h,
                                   penalization=penalization,
                                   periodicity=periodicity, l_zones=l_zones,
                                   share_weights=share_weights)
            S = _host(schur_complement(
                disc, lattice.cell_radii[rep],
                material.young_modulus, material.poisson_ratio,
                dtype=compute_dtype, device=device))
        S_list.append(S)
    # per-cell boundary nodes: recompute ordering for every cell (cheap);
    # ragged across groups — trimmed/hybrid lattices have per-cell counts
    C = lattice.num_cells
    cell_bnodes = []
    for c in range(C):
        nids = lattice.cell_node_idx[lattice.cell_node_ptr[c]:lattice.cell_node_ptr[c + 1]]
        o, s = lattice.cell_origin[c], lattice.cell_size[c]
        bbox = [o[0], o[0] + s[0], o[1], o[1] + s[1], o[2], o[2] + s[2]]
        order = boundary_node_order(lattice.nodes[nids], bbox)
        nb_g = int(S_list[group_of_cell[c]].shape[0]) // 6
        if len(order) != nb_g:
            raise ValueError(
                f"cell {c} has {len(order)} boundary nodes but its Schur "
                f"group expects {nb_g} — inconsistent grouping signature")
        cell_bnodes.append(nids[order])
    return S_list, group_of_cell, cell_bnodes


def build_ddm_system(lattice: Lattice, material: Optional[MatProperties] = None,
                     bc: Optional[BCArrays] = None,
                     penalization: Optional[bool] = None,
                     periodicity: Optional[bool] = None,
                     target_h: Optional[float] = None,
                     schur_provider: Optional[Callable] = None,
                     share_weights: bool = True,
                     dtype=None, device="cuda") -> DDMSystem:
    """Assemble the interface system (exact Schur per unique cell group) on
    ``device``.

    ``schur_provider(radii) -> S`` plugs in surrogate reconstruction
    (reduced basis / RBF / nearest-neighbor) instead of exact condensation.

    ``share_weights=True`` weights face-shared beams by 1/multiplicity so the
    per-cell Schur complements assemble to exactly the global stiffness;
    ``False`` reproduces the reference's behavior of counting such beams
    once per owning cell (cell.py:293-380 dedups within a cell but every
    cell condenses its full beam set), which stiffens shared faces — needed
    when matching the reference's committed DDM optimization records.

    ``dtype`` defaults to float32 on a CUDA device (the JAX package's
    accelerator rule: a fast operator for the CG iterations, whose refined
    mode recovers float64 accuracy from the retained float64 copies) and
    float64 on the CPU.
    """
    from ..parallel.structured import _check_device
    dev = _check_device(device)
    mat = material or MatProperties(lattice.config.material_name())
    bc = bc or apply_boundary_conditions(lattice)
    if dtype is None:
        dtype = torch.float32 if dev.type == "cuda" else torch.float64
    sim = lattice.config.simulation or {}
    ddm_cfg = sim.get("DDM", {})
    schur_type = (ddm_cfg.get("schur_complement_computation", {}) or {}).get("type", "exact")
    if penalization is None:
        # reference applies penalization only for the exact Schur type
        # (lattice_sim.py:119-123)
        penalization = schur_type == "exact" and schur_provider is None
    if periodicity is None:
        periodicity = bool(sim.get("periodicity", False))
    fe2 = schur_type == "FE2" and schur_provider is None
    S_list, group_of_cell, cell_bnodes = _schur_groups(
        lattice, mat, penalization, periodicity, target_h, dev,
        schur_provider, share_weights=share_weights, fe2=fe2)
    return DDMSystem(lattice, S_list, group_of_cell, cell_bnodes, bc,
                     dtype=dtype, device=dev)


def solve_ddm(lattice: Lattice, material: Optional[MatProperties] = None,
              bc: Optional[BCArrays] = None, tol: float = 1e-10,
              maxiter: Optional[int] = None,
              preconditioner: Optional[str] = None,
              system: Optional[DDMSystem] = None,
              refined: Optional[bool] = None, device="cuda",
              **kwargs) -> DDMResult:
    """Solve interface equilibrium with PCG (solve_DDM parity,
    lattice_sim.py:1111-1176).

    ``refined``: mixed-precision iterative refinement — f32 CG iterations
    with f64 residual recomputation — so tolerances below the f32 rounding
    floor are reachable on an f32 operator.  Auto: ON when the assembled
    system is f32 and the requested ``tol`` is below the floor.
    ``device`` places a system built here (``system`` keeps its own).
    """
    bc = bc or apply_boundary_conditions(lattice)
    sys_ = system or build_ddm_system(lattice, material, bc, device=device,
                                      **kwargs)
    ddm_cfg = ((lattice.config.simulation or {}).get("DDM", {}) or {})
    if maxiter is None:
        maxiter = int(ddm_cfg.get("max_iterations", 10000))
    if preconditioner is None:
        if ddm_cfg.get("enable_preconditioner", True):
            preconditioner = ddm_cfg.get("preconditioner_type") or "block_jacobi"
        else:
            preconditioner = "none"
    A = sys_.masked()
    b = sys_.rhs()
    M = sys_.preconditioner(preconditioner)
    if refined is None:
        refined = sys_.S[0].dtype == torch.float32 and tol < 3e-7
    S_post, u_imp, f_applied = sys_.S, sys_.u_imposed, sys_.f_applied
    if refined:
        A_hi, b_hi = sys_.hi_operator()
        out = refined_solve(A, A_hi, b_hi, M=M, maxiter=maxiter, tol=tol,
                            inner_tol=max(tol, 1e-4))
        # post-process (reactions, compliance) at the refined precision
        hi = dict(dtype=out.x.dtype, device=out.x.device)
        S_post = [torch.tensor(s, **hi) for s in sys_.S_np]
        u_imp = torch.tensor(sys_.u_imposed_np, **hi)
        f_applied = torch.tensor(sys_.f_applied_np, **hi)
    else:
        out = pcg(A, b, M=M, maxiter=maxiter, tol=tol)
    dt_post = out.x.dtype
    free = sys_.free.to(dt_post)
    u = free * out.x + (1.0 - free) * u_imp
    Ku = sys_.matvec(u, S_post)
    fixed = (1.0 - free) * torch.as_tensor(
        sys_.interface_nodes[:, None], dtype=dt_post, device=u.device)
    reaction = fixed * (Ku - f_applied)
    f_total = f_applied + reaction
    compliance = torch.sum(f_total * u)
    return DDMResult(
        u=u.cpu().numpy(), reaction=reaction.cpu().numpy(),
        compliance=float(compliance),
        iterations=int(out.iterations), residual=float(out.residual_norm),
    )
