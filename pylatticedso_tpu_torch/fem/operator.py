"""Matrix-free global stiffness operator + assembly helpers (PyTorch).

The port of ``pylatticedso_tpu.fem.operator``: gather -> per-edge
strain/stress -> per-node sum, the matrix-free action of the lattice
stiffness.  The JAX module sums per node with ``jax.ops.segment_sum``; an
``index_add_`` on a CUDA tensor adds in the order its atomics land, so
repeated calls would differ in their last bits.  ``SegmentSum`` instead
adds each node's contributions in one fixed order (ascending contribution
index, the order of a sequential scatter-add) through a gather table built
once per operator, with no atomics: the same bits on every call, on the
card and on the CPU.  Its transpose, ``SegmentSum.gather``, is the
endpoint gather whose gradient is that same ordered sum.  Dense assembly is
provided for small systems (oracles, per-cell condensation).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .elements import (EdgeGeometry, edge_dof_diag, edge_forces,
                       edge_geometry, edge_strains, element_stiffness_dense,
                       section_stiffness, KAPPA)

__all__ = ["BeamOperator", "SegmentSum", "build_operator", "assemble_dense",
           "masked_operator"]


class SegmentSum:
    """Per-segment sums of ``values[i]`` over every i with ``idx[i] == s``,
    each segment's terms added in ascending i.

    ``table[k, s]`` is the k-th contribution index of segment s (``M``, a
    zero row appended to the values, past its count), so the sum is ``K``
    gathers and adds of whole columns, ``K`` the largest segment.  The
    table is built with a stable sort on ``idx``'s device.  ``self(values)``
    is differentiable (its gradient is the gather ``g[idx]``), and so is
    ``self.gather(x)`` = ``x[idx]`` (its gradient is this ordered sum).
    ``dim=1`` sums the columns of ``[k, M]`` values instead (the column
    layout of ``parallel.sharding``): the same terms in the same order.
    """

    def __init__(self, idx: torch.Tensor, num_segments: int):
        idx = idx.reshape(-1).long()
        M = idx.numel()
        self.idx, self.num_segments, self.size = idx, int(num_segments), M
        counts = torch.bincount(idx, minlength=self.num_segments)
        width = int(counts.max()) if M else 0
        order = torch.sort(idx, stable=True).indices
        sidx = idx[order]
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(M, device=idx.device) - starts[sidx]
        table = torch.full((width, self.num_segments), M, dtype=torch.long,
                           device=idx.device)
        table[rank, sidx] = order
        self.table = table

    def _sum(self, values: torch.Tensor, dim: int = 0) -> torch.Tensor:
        shape = list(values.shape)
        shape[dim] = 1
        vp = torch.cat([values, values.new_zeros(shape)], dim=dim)
        if self.table.shape[0] == 0:
            shape[dim] = self.num_segments
            return values.new_zeros(shape)
        out = vp.index_select(dim, self.table[0])
        for k in range(1, self.table.shape[0]):
            out = out + vp.index_select(dim, self.table[k])
        return out

    def __call__(self, values: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return _OrderedSum.apply(values, self, dim)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return _OrderedGather.apply(x, self, dim)


class _OrderedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, seg, dim):
        ctx.seg, ctx.dim = seg, dim
        return seg._sum(values, dim)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(ctx.dim, ctx.seg.idx), None, None


class _OrderedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg, dim):
        ctx.seg, ctx.dim = seg, dim
        return x.index_select(dim, seg.idx)

    @staticmethod
    def backward(ctx, g):
        return ctx.seg._sum(g, ctx.dim), None, None


class BeamOperator(NamedTuple):
    """Static data of the global stiffness action K.u on [N,6] fields;
    ``ends`` sums over both endpoints of every edge (``cat([n1, n2])``)."""
    edges: torch.Tensor      # [E,2] int64
    geom: EdgeGeometry       # per-edge frame/length
    D: torch.Tensor          # [E,6] section stiffness diagonal
    n_nodes: int
    ends: SegmentSum

    def _end_strains(self, u: torch.Tensor) -> torch.Tensor:
        ue = self.ends.gather(u)                      # [2E, 6]: n1 then n2
        E = self.edges.shape[0]
        return edge_strains(ue[:E, :3], ue[:E, 3:], ue[E:, :3], ue[E:, 3:],
                            self.geom)

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u with u of shape [N,6]; returns [N,6]."""
        sig = self.D * self._end_strains(u)
        f_u1, f_m1, f_u2, f_m2 = edge_forces(sig, self.geom)
        contrib = torch.cat([
            torch.cat([f_u1, f_m1], dim=1),
            torch.cat([f_u2, f_m2], dim=1),
        ], dim=0)                                     # [2E, 6]
        return self.ends(contrib)

    def diagonal(self) -> torch.Tensor:
        """diag(K) as [N,6] — Jacobi preconditioner data."""
        d = edge_dof_diag(self.geom, self.D)          # [E,12]
        return self.ends(torch.cat([d[:, :6], d[:, 6:]], dim=0))

    def strain_energy(self, u: torch.Tensor) -> torch.Tensor:
        """1/2 u^T K u via per-edge energies (calculate_strain_energy parity,
        simulation_base.py:741-755)."""
        eps = self._end_strains(u)
        return 0.5 * torch.sum(self.geom.L[:, None] * self.D * eps**2)


def _tensors(nodes, edges, dtype, device):
    from ..parallel.structured import _check_device
    dev = _check_device(device)
    return (torch.as_tensor(nodes, dtype=dtype, device=dev),
            torch.as_tensor(edges, dtype=torch.long, device=dev))


def build_operator(nodes, edges, radius, E, nu, kappa: float = KAPPA,
                   dtype=torch.float64, device="cuda") -> BeamOperator:
    """The operator of a lattice's arrays on ``device`` in ``dtype``."""
    nodes, edges = _tensors(nodes, edges, dtype, device)
    radius = torch.as_tensor(radius, dtype=dtype, device=nodes.device)
    geom = edge_geometry(nodes, edges)
    D = section_stiffness(radius, E, nu, kappa).D
    ends = SegmentSum(torch.cat([edges[:, 0], edges[:, 1]]), nodes.shape[0])
    return BeamOperator(edges=edges, geom=geom, D=D, n_nodes=nodes.shape[0],
                        ends=ends)


def assemble_dense(nodes, edges, radius, E, nu, kappa: float = KAPPA,
                   weight=None, dtype=torch.float64,
                   device="cuda") -> torch.Tensor:
    """Dense [6N, 6N] global stiffness (small systems / condensation only).

    ``weight`` scales each element's contribution — used as a partition of
    unity (1/multiplicity) for beams shared by several cells in the DDM
    condensation, so per-cell Schur complements assemble to exactly the
    global stiffness.  The diagonal node blocks are summed in the fixed
    order of ``SegmentSum``; each edge owns its two off-diagonal blocks.
    """
    nodes, edges = _tensors(nodes, edges, dtype, device)
    Ke = element_stiffness_dense(
        nodes, edges, torch.as_tensor(radius, dtype=dtype,
                                      device=nodes.device), E, nu, kappa)
    if weight is not None:
        Ke = Ke * torch.as_tensor(weight, dtype=Ke.dtype,
                                  device=Ke.device)[:, None, None]
    N = nodes.shape[0]
    n1, n2 = edges[:, 0], edges[:, 1]
    ends = SegmentSum(torch.cat([n1, n2]), N)
    K4 = Ke.new_zeros((N, N, 6, 6))
    ar = torch.arange(N, device=Ke.device)
    K4[ar, ar] = ends(torch.cat([Ke[:, :6, :6], Ke[:, 6:, 6:]]))
    K4.index_put_((n1, n2), Ke[:, :6, 6:], accumulate=True)
    K4.index_put_((n2, n1), Ke[:, 6:, :6], accumulate=True)
    return K4.permute(0, 2, 1, 3).reshape(6 * N, 6 * N)


def masked_operator(op: BeamOperator, free_mask: torch.Tensor):
    """SPD-preserving Dirichlet mask: identity on fixed dofs, K on free.

    ``free_mask`` is [N,6] (1 = free).  Returns a matvec over [N,6] fields:
    A(u) = mask * K(mask * u) + (1 - mask) * u.
    """
    fm = free_mask

    def apply(u):
        return fm * op.matvec(fm * u) + (1.0 - fm) * u

    return apply
