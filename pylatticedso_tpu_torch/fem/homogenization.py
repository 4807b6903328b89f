"""Unit-cell homogenization with periodic DOF folding (PyTorch).

The port of ``pylatticedso_tpu.fem.homogenization``.  Every slave boundary
node (non-master face/edge/corner) is folded onto its periodic master in
the assembly index map, so the periodic constraint costs nothing at solve
time.  The dense stiffness is assembled on ``device`` (``assemble_dense``,
its node blocks summed in a fixed order); the fold, the affine fields and
the macro stress stay numpy, as in the JAX module; the six affine strain
cases (homogenization_cell.py:112-147) are one batched multi-RHS Cholesky
solve on ``device`` (``torch.linalg.cholesky`` / ``torch.cholesky_solve``,
where JAX calls ``cho_factor`` / ``cho_solve``).  The macro stress is the
boundary-reaction moment sum  sigma = sum_i f_i (x) r_i
(homogenization_cell.py:309-331), and the 6x6 matrix is symmetrized and
reduced to orthotropic constants (homogenization_cell.py:454-511).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..design.lattice import Lattice
from ..materials import MatProperties
from .operator import assemble_dense
from .subdivide import subdivide_edges

__all__ = ["HomogenizationResult", "homogenize_cell", "orthotropic_constants",
           "directional_modulus"]


@dataclass
class HomogenizationResult:
    C: np.ndarray               # 6x6 homogenized stiffness (Voigt, tensor shear)
    C_raw: np.ndarray           # before symmetrization
    symmetry_error: float
    orthotropic: dict           # Ex, Ey, Ez, Gxy, Gxz, Gyz, nu_xy, nu_xz, nu_yz
    u_fluct: np.ndarray         # [6, N, 6] fluctuation fields per strain case


# affine strain case -> displacement field w(x) (homogenization_cell.py:131-145)
def _affine_fields(coords: np.ndarray) -> np.ndarray:
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    zero = np.zeros_like(x)
    W = np.stack([
        np.stack([x, zero, zero], 1),
        np.stack([zero, y, zero], 1),
        np.stack([zero, zero, z], 1),
        np.stack([y, x, zero], 1),
        np.stack([z, zero, x], 1),
        np.stack([zero, z, y], 1),
    ])                                            # [6, N, 3]
    return W


def _periodic_master_map(coords: np.ndarray, bbox, tol: float = 1e-9) -> np.ndarray:
    """master[i] = index of the periodic master of node i (wrap max->min).

    Mirrors the MPC master/slave tag pairing (homogenization_cell.py:210-252):
    faces fold across the cell, edges fold onto one representative edge,
    corners onto one corner.
    """
    x0, x1, y0, y1, z0, z1 = bbox
    wrapped = coords.copy()
    for ax, (lo, hi) in enumerate([(x0, x1), (y0, y1), (z0, z1)]):
        on_hi = np.abs(coords[:, ax] - hi) <= tol
        wrapped[on_hi, ax] = lo
    keys = np.round(wrapped / tol).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    # representative per group = lowest node index
    rep = np.full(len(uniq), -1, dtype=np.int64)
    for i in range(len(coords)):
        g = inv[i]
        if rep[g] < 0:
            rep[g] = i
    return rep[inv]


def homogenize_cell(lattice: Lattice, material: Optional[MatProperties] = None,
                    cell_index: int = 0, target_h: Optional[float] = None,
                    penalization: bool = False, dtype=torch.float64,
                    device="cuda") -> HomogenizationResult:
    """Homogenized 6x6 stiffness of one unit cell (volume-normalized).

    Requires a single-cell lattice or an explicit ``cell_index``
    (utils_simulation.py:83-121 asserts one cell).
    """
    mat = material or MatProperties(lattice.config.material_name())
    c = cell_index
    eids = lattice.cell_edge_idx[lattice.cell_edge_ptr[c]:lattice.cell_edge_ptr[c + 1]]
    nids = lattice.cell_node_idx[lattice.cell_node_ptr[c]:lattice.cell_node_ptr[c + 1]]
    remap = -np.ones(lattice.num_nodes, dtype=np.int64)
    remap[nids] = np.arange(len(nids))
    nodes = lattice.nodes[nids]
    edges = remap[lattice.edges[eids]].astype(np.int32)
    radius = lattice.radius[eids]
    if target_h is None:
        target_h = 0.05 * lattice.config.cell_size[0]
    if penalization:
        from ..sim.penalization import penalize_edges
        pen = penalize_edges(nodes, edges, radius, periodicity=True)
        nodes, edges, radius = pen.nodes, pen.edges, pen.radius
    nodes, edges, parent, radius = subdivide_edges(nodes, edges, target_h,
                                                   edge_data=(radius,))
    N = len(nodes)
    o, s = lattice.cell_origin[c], lattice.cell_size[c]
    bbox = [o[0], o[0] + s[0], o[1], o[1] + s[1], o[2], o[2] + s[2]]
    volume = float(np.prod(s))

    K = assemble_dense(nodes, edges, radius, mat.young_modulus,
                       mat.poisson_ratio, dtype=dtype, device=device)
    dev = K.device
    K = K.cpu().numpy()

    # periodic folding: global unknowns = master-node DOFs
    master = _periodic_master_map(nodes, bbox)
    n_master = len(np.unique(master))
    # dense fold via index maps on the 6N dof space
    dof_master = (master[:, None] * 6 + np.arange(6)).reshape(-1)
    uniq_dofs, fold = np.unique(dof_master, return_inverse=True)
    P = np.zeros((6 * N, len(uniq_dofs)))
    P[np.arange(6 * N), fold] = 1.0
    K_red = P.T @ K @ P

    # pin the node nearest the mesh centroid (apply_dirichlet_for_homogenization)
    centroid = nodes.mean(axis=0)
    pin_node = int(np.argmin(np.linalg.norm(nodes - centroid, axis=1)))
    pin_dofs = fold[pin_node * 6 + np.arange(6)]
    free = np.setdiff1d(np.arange(K_red.shape[0]), pin_dofs)

    # affine RHS, all 6 cases at once: b = -P^T K u_aff
    W = _affine_fields(nodes)                       # [6, N, 3]
    U_aff = np.concatenate([W, np.zeros_like(W)], axis=2).reshape(6, -1)  # [6, 6N]
    B = -(U_aff @ K) @ P                            # [6, n_red]

    Kff = torch.as_tensor(K_red[np.ix_(free, free)], dtype=dtype, device=dev)
    Bf = torch.as_tensor(B[:, free], dtype=dtype, device=dev)
    chol = torch.linalg.cholesky(Kff)
    Uf = torch.cholesky_solve(Bf.T, chol).T         # [6, n_free]
    u_red = np.zeros((6, K_red.shape[0]))
    u_red[:, free] = Uf.cpu().numpy()

    # unfold + total field
    u_fluct = u_red[:, fold].reshape(6, N, 6)
    u_tot = u_fluct + np.concatenate([W, np.zeros_like(W)], axis=2)

    # residual (reactions) and macro stress sigma = (1/V) sum f_i (x) r_i
    R = (u_tot.reshape(6, -1) @ K).reshape(6, N, 6)[:, :, :3]   # forces only
    C_cols = []
    for case in range(6):
        sig = np.einsum("ni,nj->ij", R[case], nodes) / volume
        C_cols.append([sig[0, 0], sig[1, 1], sig[2, 2],
                       sig[1, 0], sig[2, 0], sig[2, 1]])
    C_raw = np.column_stack(C_cols)
    sym_err = float(np.abs(C_raw - C_raw.T).max() / max(np.abs(C_raw).max(), 1e-300))
    C = 0.5 * (C_raw + C_raw.T)
    ortho = orthotropic_constants(C)
    return HomogenizationResult(C=C, C_raw=C_raw, symmetry_error=sym_err,
                                orthotropic=ortho, u_fluct=u_fluct)


def orthotropic_constants(C: np.ndarray) -> dict:
    """Engineering constants from the homogenized matrix
    (convert_to_orthotropic_form, homogenization_cell.py:454-487)."""
    Hinv = np.linalg.inv(C)
    Ex, Ey, Ez = 1 / Hinv[0, 0], 1 / Hinv[1, 1], 1 / Hinv[2, 2]
    return {
        "Ex": Ex, "Ey": Ey, "Ez": Ez,
        "Gxy": 1 / (2 * Hinv[3, 3]),
        "Gxz": 1 / (2 * Hinv[4, 4]),
        "Gyz": 1 / (2 * Hinv[5, 5]),
        "nu_xy": -Hinv[0, 1] * Ey,
        "nu_xz": -Hinv[0, 2] * Ez,
        "nu_yz": -Hinv[1, 2] * Ez,
    }


def directional_modulus(C: np.ndarray, theta: np.ndarray, phi: np.ndarray) -> np.ndarray:
    """Directional Young's modulus E(theta, phi) by compliance contraction
    (utils.py:35-73 of pyLatticeSim): E = 1 / (d_i d_j d_k d_l S_ijkl)."""
    S = np.linalg.inv(C)
    # Voigt (tensor-shear) compliance -> 4th order tensor contraction for
    # direction d: 1/E = S11 d1^4 + ... standard formula with factors
    d = np.stack([np.sin(theta) * np.cos(phi),
                  np.sin(theta) * np.sin(phi),
                  np.cos(theta)], axis=-1)
    d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2]
    inv_E = (S[0, 0] * d1**4 + S[1, 1] * d2**4 + S[2, 2] * d3**4
             + (2 * S[0, 1] + 4 * S[3, 3]) * d1**2 * d2**2
             + (2 * S[0, 2] + 4 * S[4, 4]) * d1**2 * d3**2
             + (2 * S[1, 2] + 4 * S[5, 5]) * d2**2 * d3**2)
    return 1.0 / inv_E
