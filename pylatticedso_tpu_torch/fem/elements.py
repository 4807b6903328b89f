"""Batched Timoshenko beam element kernels (PyTorch).

The port of ``pylatticedso_tpu.fem.elements``, the closed form the
reference's dolfinx/UFL pipeline (simulation_base.py:116-225,
beam_model.py:197-216, material_definition.py:142-156) compiles to: a
2-node linear Timoshenko element with 1-point reduced quadrature on the
shear terms.

Generalized strains (simulation_base.py:141-156), for local frame (t, a1, a2)
and element length L, with du = u2-u1, dth = th2-th1, ths = th1+th2:

    e0 = du.t / L                      axial           stiffness ES
    e1 = du.a1 / L - ths.a2 / 2        shear 1 (1-pt)  stiffness kappa G S
    e2 = du.a2 / L + ths.a1 / 2        shear 2 (1-pt)  stiffness kappa G S
    e3 = dth.t / L                     torsion         stiffness G J
    e4 = dth.a1 / L                    bending 1       stiffness E I
    e5 = dth.a2 / L                    bending 2       stiffness E I

The element energy is L * sum_k D_k e_k^2 / 2 (constant strains, midpoint
shear), so K_e = L * B^T D B with the constant 6x12 strain operator B.
Section properties: S = pi r^2, I = pi r^4 / 4, J = 2 I, kappa = 0.9
(material_definition.py:45,142-156).

Every function takes and returns tensors, batched over edges, in the
operations and order of the JAX module, and is differentiable by autograd.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import torch

__all__ = [
    "SectionStiffness", "EdgeGeometry", "section_stiffness", "edge_geometry",
    "element_stiffness_dense", "edge_strains", "edge_forces", "edge_dof_diag",
    "section_stiffness_gradient", "KAPPA",
]

KAPPA = 0.9  # shear area correction (material_definition.py:45)


class SectionStiffness(NamedTuple):
    """Per-edge generalized stiffness diagonal D = (ES, kGS, kGS, GJ, EI, EI)."""
    D: torch.Tensor  # [E, 6]


class EdgeGeometry(NamedTuple):
    """Per-edge local frame and length."""
    t: torch.Tensor   # [E, 3] unit tangent
    a1: torch.Tensor  # [E, 3] first transverse axis
    a2: torch.Tensor  # [E, 3] second transverse axis
    L: torch.Tensor   # [E] length


def section_stiffness(radius: torch.Tensor, E: Union[float, torch.Tensor],
                      nu: Union[float, torch.Tensor],
                      kappa: float = KAPPA) -> SectionStiffness:
    """Generalized section stiffness per edge for circular cross-sections."""
    radius = torch.as_tensor(radius)
    G = E / (2.0 * (1.0 + nu))
    S = math.pi * radius**2
    I = math.pi * radius**4 / 4.0
    J = 2.0 * I
    ES = E * S
    kGS = kappa * G * S
    GJ = G * J
    EI = E * I
    D = torch.stack([ES, kGS, kGS, GJ, EI, EI], dim=-1)
    return SectionStiffness(D=D)


def section_stiffness_gradient(radius, E, nu,
                               kappa: float = KAPPA) -> torch.Tensor:
    """dD/dr per edge — the analytic property derivatives the reference builds
    in material_definition.compute_gradient (dS/dr = 2 pi r, dI/dr = pi r^3)."""
    radius = torch.as_tensor(radius)
    G = E / (2.0 * (1.0 + nu))
    dS = 2.0 * math.pi * radius
    dI = math.pi * radius**3
    return torch.stack([E * dS, kappa * G * dS, kappa * G * dS,
                        G * 2.0 * dI, E * dI, E * dI], dim=-1)


def edge_geometry(nodes: torch.Tensor, edges: torch.Tensor) -> EdgeGeometry:
    """Local orthonormal frame per edge.

    Transverse axes via the same branchless reference-axis selection as
    beam_model.calculate_local_coordinate_system (beam_model.py:197-216):
    use ez unless the tangent is nearly parallel to it, else ex.  For the
    circular sections used throughout, K is invariant to the choice.
    """
    p1 = nodes[edges[:, 0]]
    p2 = nodes[edges[:, 1]]
    d = p2 - p1
    L = torch.linalg.norm(d, dim=1)
    t = d / L[:, None]
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=nodes.dtype, device=nodes.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=nodes.dtype, device=nodes.device)
    near_z = torch.abs(t @ ez) > 0.99
    ref = torch.where(near_z[:, None], ex, ez)
    a1 = torch.linalg.cross(ref, t, dim=1)
    a1 = a1 / torch.linalg.norm(a1, dim=1)[:, None]
    a2 = torch.linalg.cross(t, a1, dim=1)
    return EdgeGeometry(t=t, a1=a1, a2=a2, L=L)


def _strain_operator(geom: EdgeGeometry) -> torch.Tensor:
    """Dense B [E,6,12] for element-matrix assembly (condensation paths)."""
    t, a1, a2, L = geom
    invL = (1.0 / L)[:, None]
    z = torch.zeros_like(t)
    half = 0.5
    # columns: [u1(3), th1(3), u2(3), th2(3)]
    rows = [
        torch.cat([-t * invL, z, t * invL, z], dim=1),
        torch.cat([-a1 * invL, -a2 * half, a1 * invL, -a2 * half], dim=1),
        torch.cat([-a2 * invL, a1 * half, a2 * invL, a1 * half], dim=1),
        torch.cat([z, -t * invL, z, t * invL], dim=1),
        torch.cat([z, -a1 * invL, z, a1 * invL], dim=1),
        torch.cat([z, -a2 * invL, z, a2 * invL], dim=1),
    ]
    return torch.stack(rows, dim=1)


def element_stiffness_dense(nodes, edges, radius, E, nu,
                            kappa: float = KAPPA) -> torch.Tensor:
    """Batched [E,12,12] element stiffness in global coordinates."""
    geom = edge_geometry(nodes, edges)
    D = section_stiffness(radius, E, nu, kappa).D
    B = _strain_operator(geom)
    return torch.einsum("ekl,ek,ekm->elm", B, D * geom.L[:, None], B)


def edge_strains(u1, th1, u2, th2, geom: EdgeGeometry) -> torch.Tensor:
    """Generalized strains [E,6] from endpoint displacements/rotations."""
    t, a1, a2, L = geom
    invL = (1.0 / L)
    du = u2 - u1
    dth = th2 - th1
    ths = th1 + th2

    def dot(x, y):
        return torch.sum(x * y, dim=1)

    return torch.stack([
        dot(du, t) * invL,
        dot(du, a1) * invL - dot(ths, a2) * 0.5,
        dot(du, a2) * invL + dot(ths, a1) * 0.5,
        dot(dth, t) * invL,
        dot(dth, a1) * invL,
        dot(dth, a2) * invL,
    ], dim=1)


def edge_forces(sig: torch.Tensor,
                geom: EdgeGeometry) -> Tuple[torch.Tensor, ...]:
    """Nodal force/moment contributions f = L * B^T sig, factored.

    Returns (f_u1, f_m1, f_u2, f_m2), each [E,3].
    """
    t, a1, a2, L = geom
    s = sig
    # translational resultant (membrane+shear), already includes 1/L * L = 1
    fu = s[:, 0:1] * t + s[:, 1:2] * a1 + s[:, 2:3] * a2
    # rotational: midpoint shear couples (L * sig/2) + moment difference terms
    m_shear = (L * 0.5)[:, None] * (-s[:, 1:2] * a2 + s[:, 2:3] * a1)
    m_diff = s[:, 3:4] * t + s[:, 4:5] * a1 + s[:, 5:6] * a2
    return -fu, m_shear - m_diff, fu, m_shear + m_diff


def edge_dof_diag(geom: EdgeGeometry, D: torch.Tensor) -> torch.Tensor:
    """Diagonal of K_e per edge, [E,12] — for Jacobi preconditioning.

    Factored form of diag(L * B^T D B) — avoids materializing B, so the
    large-scale path stays bandwidth-light (9 + 6 floats per edge).
    Both endpoints share the same diagonal by symmetry of B's columns.
    """
    t2, a12, a22 = geom.t**2, geom.a1**2, geom.a2**2
    invL = (1.0 / geom.L)[:, None]
    L4 = (geom.L / 4.0)[:, None]
    d_u = (D[:, 0:1] * t2 + D[:, 1:2] * a12 + D[:, 2:3] * a22) * invL
    d_th = (D[:, 1:2] * a22 + D[:, 2:3] * a12) * L4 \
        + (D[:, 3:4] * t2 + D[:, 4:5] * a12 + D[:, 5:6] * a22) * invL
    half = torch.cat([d_u, d_th], dim=1)
    return torch.cat([half, half], dim=1)
