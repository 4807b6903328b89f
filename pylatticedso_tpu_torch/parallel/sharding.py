"""The edge-sharded compliance step on a device mesh (PyTorch).

The port of ``pylatticedso_tpu.parallel.sharding``, the full-lattice
(general-graph) path of ``bench.py``'s second mode.  JAX partitions the
edges over the mesh axis ``"shard"`` (``P(None, "shard")``) and the design
candidates over ``"dp"`` (``P("dp")``), with the nodal fields replicated,
so a CG iteration needs one all-reduce.  The port does the same on a
``parallel.mesh.Mesh`` with one controlling process: ``pad_edges`` pads
the edges to a multiple of ``n_shard``, shard k holds the contiguous edge
chunk ``[k E / n, (k + 1) E / n)``, and every nodal field is a replicated
``parallel.mesh.Sharded`` (a copy on each shard of the row).  Each shard
sums its chunk's half-edge contributions per node through its own
``SegmentSum`` table (JAX's ELL order inside the chunk: a stable sort by
node of the positions in ``cat([e0, e1])``), and ``all_reduce_sum`` adds
the shards' partials in rank order: the same bits on every shard and on
every call, with no atomics.  Block Jacobi follows JAX's unrolled per-node
Cholesky term by term on ``[N]`` lanes, on every shard's copy.  The
gradient is taken per shard (autograd of the shard's partial only), so no
graph crosses devices.  Everything is plain torch: this path reaches no
Pallas kernel in the JAX package.  On a one-device mesh it is the
one-device step, bit for bit.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..fem.elements import EdgeGeometry, section_stiffness
from ..fem.operator import BeamOperator, SegmentSum
from ..fem.solve import pcg
from ..utils.timing import timing
from .mesh import (OPS, Mesh, Sharded, _copy, all_reduce_sum, broadcast,
                   make_mesh)

__all__ = ["Mesh", "make_mesh", "pad_edges", "ShardedLattice",
           "make_compliance_step"]


def pad_edges(edges: np.ndarray, per_edge: Sequence[np.ndarray], n_shard: int):
    """Pad the edge dimension to a multiple of n_shard with zero-stiffness
    self-loops on node 0 (harmless contributions)."""
    E = len(edges)
    Epad = -(-E // n_shard) * n_shard
    if Epad == E:
        return edges, list(per_edge), E
    pad = Epad - E
    edges2 = np.concatenate([edges, np.zeros((pad, 2), dtype=edges.dtype)])
    out = []
    for arr in per_edge:
        z = np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)
        out.append(np.concatenate([arr, z]))
    return edges2, out, E


class _Chunk:
    """Shard k's edge chunk on its device: endpoints [2, C], frames [C, 3],
    lengths, validity, and the chunk's per-node ``SegmentSum``."""

    def __init__(self, shl: "ShardedLattice", k: int, device: torch.device):
        C = shl.chunk
        sl = slice(k * C, (k + 1) * C)
        cp = lambda t: _copy(t[sl], device)
        self.device = device
        self.edges = _copy(shl.edges[:, sl], device)
        self.valid = cp(shl.valid[0])
        self.t, self.a1, self.a2, self.L = (cp(shl.t), cp(shl.a1),
                                            cp(shl.a2), cp(shl.L))
        self.ends = SegmentSum(self.edges.reshape(-1), shl.n_nodes)

    def geom(self) -> EdgeGeometry:
        return EdgeGeometry(t=self.t, a1=self.a1, a2=self.a2, L=self.L)


class ShardedLattice:
    """Edge-sharded matrix-free operator over a device mesh.

    ``radius`` enters as an argument (not baked in) so one operator serves
    the whole optimization trajectory and candidate batches.  ``edges`` is
    ``[2, Epad]`` int64, the frames ``[Epad, 3]`` and ``L`` ``[Epad]`` in
    ``dtype`` on the mesh's first device, computed with JAX's operations in
    JAX's order; ``chunks(row)`` are the shards' chunks on the devices of
    mesh row ``row`` (built at first use).  ``matvec``, ``diagonal`` and
    ``node_blocks`` take and return whole fields on the mesh's first
    device: each shard of row 0 computes its chunk's per-node partial, and
    ``all_reduce_sum`` adds them in rank order.
    """

    def __init__(self, mesh: Mesh, nodes: np.ndarray, edges: np.ndarray,
                 E_mod: float, nu: float, valid_mask: Optional[np.ndarray] = None,
                 dtype=torch.float32):
        self.mesh = mesh
        dev = self.device = mesh.device
        self.n_shard = mesh.shape["shard"]
        edges_p, (vm,), self.n_real = pad_edges(
            edges, [np.ones(len(edges)) if valid_mask is None else valid_mask],
            self.n_shard)
        self.n_nodes = len(nodes)
        self.E_mod, self.nu = E_mod, nu
        self.dtype = dtype

        self.edges = torch.as_tensor(edges_p.T.astype(np.int64), device=dev)
        self.valid = torch.as_tensor(vm[None, :], dtype=dtype, device=dev)
        self.chunk = self.edges.shape[1] // self.n_shard
        nodes_t = torch.as_tensor(nodes, dtype=dtype, device=dev)
        p1 = nodes_t[self.edges[0]]
        p2 = nodes_t[self.edges[1]]
        d = p2 - p1
        L = torch.linalg.norm(d, dim=1)
        L = torch.where(L == 0, torch.ones_like(L), L)
        t = d / L[:, None]
        ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
        ex = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev)
        ref = torch.where((torch.abs(t @ ez) > 0.99)[:, None], ex, ez)
        a1 = torch.linalg.cross(ref, t, dim=1)
        # a padded self-loop has t = 0, so a1 = 0: its frame stays zero
        # (JAX's is 0 / 0 = NaN, which its ELL sums skip but its block
        # factors would not), and its contributions are exactly zero
        n1 = torch.linalg.norm(a1, dim=1)
        a1 = a1 / torch.where(n1 == 0, torch.ones_like(n1), n1)[:, None]
        a2 = torch.linalg.cross(t, a1, dim=1)
        self.t, self.a1, self.a2, self.L = t, a1, a2, L
        self._chunks = {}

    def chunks(self, row: int = 0) -> List[_Chunk]:
        if row not in self._chunks:
            self._chunks[row] = [_Chunk(self, k, d) for k, d in
                                 enumerate(self.mesh.devices[row])]
        return self._chunks[row]

    @property
    def width(self) -> int:
        """The widest per-node sum of any shard's ``SegmentSum``."""
        return max(int(c.ends.table.shape[0]) for c in self.chunks(0))

    # ------------------------------------------------------------------
    def _split(self, x: torch.Tensor, row: int = 0) -> List[torch.Tensor]:
        """A per-edge [Epad, ...] tensor cut into the row's chunks."""
        C = self.chunk
        return [_copy(x[k * C:(k + 1) * C], c.device)
                for k, c in enumerate(self.chunks(row))]

    def _reduce(self, parts: List[torch.Tensor]) -> torch.Tensor:
        return all_reduce_sum(parts)[0]

    def section_D(self, radius: torch.Tensor) -> torch.Tensor:
        """[Epad, 6] stiffness diagonal (zero on padding)."""
        D = section_stiffness(radius, self.E_mod, self.nu).D
        return D * self.valid[0][:, None]

    def _operators(self, D: torch.Tensor) -> List[BeamOperator]:
        return [BeamOperator(edges=c.edges.T, geom=c.geom(), D=Dk,
                             n_nodes=self.n_nodes, ends=c.ends)
                for c, Dk in zip(self.chunks(0), self._split(D))]

    def matvec(self, u: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
        """K.u for u [N,6]: each shard's partial, added in rank order."""
        return self._reduce([op.matvec(_copy(u, op.edges.device))
                             for op in self._operators(D)])

    def radius_padded(self, radius) -> torch.Tensor:
        r = torch.zeros(self.edges.shape[1], dtype=self.dtype,
                        device=self.device)
        r[: self.n_real] = torch.as_tensor(np.asarray(radius),
                                           dtype=self.dtype,
                                           device=self.device)
        return r

    def diagonal(self, D: torch.Tensor) -> torch.Tensor:
        """diag(K) [N,6] from the factored per-edge diagonal."""
        return self._reduce([op.diagonal() for op in self._operators(D)])

    def node_blocks(self, D: torch.Tensor) -> torch.Tensor:
        """Assembled per-node 6x6 diagonal blocks [N,6,6] (block Jacobi).

        Each endpoint's self-block of K_e is L B_n^T D B_n with B_n the
        6x6 column block of the strain operator; endpoint 2's is S blk S
        with S = diag(I3, -I3).
        """
        return self._reduce([self._blocks(c, Dk) for c, Dk in
                             zip(self.chunks(0), self._split(D))])

    @staticmethod
    def _blocks(c: _Chunk, D: torch.Tensor) -> torch.Tensor:
        t, a1, a2, L = c.t, c.a1, c.a2, c.L
        invL = (1.0 / L)
        z = torch.zeros_like(t)
        Bu = torch.stack([
            -t * invL[:, None], -a1 * invL[:, None], -a2 * invL[:, None],
            z, z, z], dim=1)                                    # [E,6,3]
        Bth = torch.stack([
            z, -a2 * 0.5, a1 * 0.5,
            -t * invL[:, None], -a1 * invL[:, None], -a2 * invL[:, None]],
            dim=1)                                              # [E,6,3]
        B = torch.cat([Bu, Bth], dim=2)                         # [E,6,6]
        DL = D * L[:, None]
        blk = torch.einsum("eki,ek,ekj->eij", B, DL, B)         # [E,6,6]
        sgn = torch.tensor([1.0, 1.0, 1.0, -1.0, -1.0, -1.0], dtype=t.dtype,
                           device=t.device)
        blk2 = blk * sgn[None, :, None] * sgn[None, None, :]
        return c.ends(torch.cat([blk, blk2], dim=0))


_TRI6 = [(i, j) for i in range(6) for j in range(i + 1)]   # 21 lower entries
_IX66 = [[_TRI6.index((max(i, j), min(i, j))) for j in range(6)]
         for i in range(6)]


def _block_jacobi_inverse(A):
    """Explicit inverse of a symmetric-positive 6x6 block given as a python
    6x6 list of same-shape tensors (one lane per node): JAX's unrolled
    vector Cholesky, each operation in its order.

    Returns the 21 lower-triangle entries of B^-1 in _TRI6 order.
    """
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        s = A[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp_min(s, 1e-30))
        for i in range(j + 1, 6):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    Li = [[None] * 6 for _ in range(6)]          # L^-1 (lower)
    for j in range(6):
        Li[j][j] = 1.0 / L[j][j]
        for i in range(j + 1, 6):
            s = L[i][j] * Li[j][j]
            for k in range(j + 1, i):
                s = s + L[i][k] * Li[k][j]
            Li[i][j] = -s / L[i][i]
    out = []
    for i, j in _TRI6:                           # B^-1 = L^-T L^-1
        s = None
        for k in range(i, 6):                    # k >= i >= j
            term = Li[k][i] * Li[k][j]
            s = term if s is None else s + term
        out.append(s)
    return out


def _block_full(Binv21: torch.Tensor) -> torch.Tensor:
    """The [21, N] inverse-block entries as the full symmetric [6, 6, N]."""
    return Binv21[torch.tensor(_IX66, device=Binv21.device)]


def _block_apply(Bfull: torch.Tensor, r6: torch.Tensor) -> torch.Tensor:
    """M^-1 r for the [6, 6, N] inverse blocks and a [6, N] column field:
    each row i is JAX's sum B[i,0] r0 + B[i,1] r1 + ... + B[i,5] r5 in that
    order, the six rows at once (11 launches where JAX's lanes take 36
    multiply-adds)."""
    s = Bfull[:, 0] * r6[0]
    for j in range(1, 6):
        s = s + Bfull[:, j] * r6[j]
    return s


class _ShardStep:
    """The compliance step's per-edge work on one shard's chunk: sections,
    strains, the chunk's per-node partial of K.u, of the block-Jacobi
    blocks and of the Jacobi diagonal, and the per-edge gradients; every
    tensor on the chunk's device."""

    def __init__(self, c: _Chunk, E_mod: float, nu: float):
        self.device = c.device
        self.E_mod, self.G_mod = E_mod, E_mod / (2.0 * (1.0 + nu))
        self.kappa = 0.9
        self.tT = c.t.T.contiguous()            # [3, C]
        self.a1T = c.a1.T.contiguous()
        self.a2T = c.a2.T.contiguous()
        self.Lv = c.L                           # [C]
        self.validv = c.valid                   # [C]
        self.invL = 1.0 / self.Lv
        self.Lhalf = self.Lv * 0.5
        self.ends = c.ends                      # JAX's ELL order in the chunk
        self.E = int(self.Lv.shape[0])

    def sections(self, radius):
        E_mod, G_mod = self.E_mod, self.G_mod
        r2 = radius * radius
        S = math.pi * r2 * self.validv
        I = math.pi * r2 * r2 / 4.0
        return (E_mod * S, self.kappa * G_mod * S,
                G_mod * 2.0 * I * self.validv, E_mod * I * self.validv)

    def strains(self, u6):
        tT, a1T, a2T, invL, E = self.tT, self.a1T, self.a2T, self.invL, self.E
        g = self.ends.gather(u6, dim=1)                   # [6, 2C]
        g1, g2 = g[:, :E], g[:, E:]
        du = g2[:3] - g1[:3]                              # [3, C]
        ths = g1[3:] + g2[3:]
        dth = g2[3:] - g1[3:]
        dot = lambda A, B: torch.sum(A * B, dim=0)        # [C]
        return (dot(du, tT) * invL,
                dot(du, a1T) * invL - dot(ths, a2T) * 0.5,
                dot(du, a2T) * invL + dot(ths, a1T) * 0.5,
                dot(dth, tT) * invL,
                dot(dth, a1T) * invL,
                dot(dth, a2T) * invL)

    def partial(self, u6, sec):
        """The chunk's per-node sum of K.u [6, N]."""
        tT, a1T, a2T = self.tT, self.a1T, self.a2T
        ES, kGS, GJ, EI = sec
        e0, e1, e2, e3, e4, e5 = self.strains(u6)
        s0, s1, s2 = ES * e0, kGS * e1, kGS * e2
        s3, s4, s5 = GJ * e3, EI * e4, EI * e5
        fu = s0 * tT + s1 * a1T + s2 * a2T                # [3, C]
        msh = self.Lhalf * (-s1 * a2T + s2 * a1T)
        mdf = s3 * tT + s4 * a1T + s5 * a2T
        c1 = torch.cat([-fu, msh - mdf])                  # [6, C]
        c2 = torch.cat([fu, msh + mdf])
        return self.ends(torch.cat([c1, c2], dim=1), dim=1)

    def blocks(self, radius):
        """The chunk's per-node sums of the 21 self-block entries [21, N]."""
        tT, a1T, a2T, invL, Lv = self.tT, self.a1T, self.a2T, self.invL, \
            self.Lv
        ES, kGS, GJ, EI = self.sections(radius)
        DL = [d * Lv for d in (ES, kGS, kGS, GJ, EI, EI)]
        z = torch.zeros_like(Lv)
        # strain rows x dof cols, endpoint-1 column block (see node_blocks)
        B = [
            [-tT[0] * invL, -tT[1] * invL, -tT[2] * invL, z, z, z],
            [-a1T[0] * invL, -a1T[1] * invL, -a1T[2] * invL,
             -a2T[0] * 0.5, -a2T[1] * 0.5, -a2T[2] * 0.5],
            [-a2T[0] * invL, -a2T[1] * invL, -a2T[2] * invL,
             a1T[0] * 0.5, a1T[1] * 0.5, a1T[2] * 0.5],
            [z, z, z, -tT[0] * invL, -tT[1] * invL, -tT[2] * invL],
            [z, z, z, -a1T[0] * invL, -a1T[1] * invL, -a1T[2] * invL],
            [z, z, z, -a2T[0] * invL, -a2T[1] * invL, -a2T[2] * invL],
        ]
        sgn = [1.0, 1.0, 1.0, -1.0, -1.0, -1.0]
        V1, V2 = [], []
        for i, j in _TRI6:
            s = DL[0] * B[0][i] * B[0][j]
            for k in range(1, 6):
                s = s + DL[k] * B[k][i] * B[k][j]
            V1.append(s)
            V2.append((sgn[i] * sgn[j]) * s)     # endpoint-2 self-block
        return self.ends(torch.cat([torch.stack(V1), torch.stack(V2)],
                                   dim=1), dim=1)

    def diag(self, sec):
        """The chunk's per-node sums of the scalar Jacobi diagonal [6, N]."""
        tT, a1T, a2T, invL, Lv = self.tT, self.a1T, self.a2T, self.invL, \
            self.Lv
        ES, kGS, GJ, EI = sec
        t2, a12, a22 = tT * tT, a1T * a1T, a2T * a2T
        d_u = (ES * t2 + kGS * (a12 + a22)) * invL        # [3, C]
        d_th = (kGS * (a22 + a12)) * (Lv * 0.25) \
            + (GJ * t2 + EI * (a12 + a22)) * invL
        dvec = torch.cat([d_u, d_th])                     # [6, C]
        return self.ends(torch.cat([dvec, dvec], dim=1), dim=1)

    def grad_partial(self, radius, u6, g6):
        """d/dr of <g6, partial(u6, sections(r))> on this chunk's edges."""
        r = radius.detach().requires_grad_(True)
        with torch.enable_grad():
            out = self.partial(u6, self.sections(r))
            (g,) = torch.autograd.grad(out, r, grad_outputs=g6)
        return g

    def grad_q(self, radius, uf):
        """-d/dr of the chunk's strain energy u.K.u at u = uf."""
        e = self.strains(uf)
        r = radius.detach().requires_grad_(True)
        with torch.enable_grad():
            ES, kGS, GJ, EI = self.sections(r)
            # strain-energy form: u.K.u = sum_e (ES e0^2 + kGS (e1^2+e2^2)
            # + GJ e3^2 + EI (e4^2+e5^2)) L  -- no per-node sum needed
            q = torch.sum((ES * e[0] * e[0]
                           + kGS * (e[1] * e[1] + e[2] * e[2])
                           + GJ * e[3] * e[3]
                           + EI * (e[4] * e[4] + e[5] * e[5])) * self.Lv)
            (g,) = torch.autograd.grad(q, r)
        return -g


def make_compliance_step(shl: ShardedLattice, free_mask: np.ndarray,
                         f_ext: np.ndarray, tol: float = 1e-6,
                         maxiter: int = 4000,
                         preconditioner: str = "block_jacobi") -> Callable:
    """Value and gradient of the compliance in the per-edge radii, on the
    mesh of ``shl``.

    ``step(r) -> (c, g)``: one preconditioned CG solve and its adjoint
    (JAX's ``custom_linear_solve``: one more CG solve against f), the
    gradient ``-lambda . dK/dr u`` taken per shard by autograd of the
    shard's own partial, the block factors from the radii as JAX's
    ``stop_gradient``.  Radii and gradients are whole ``[Epad]`` tensors on
    the mesh's first device; the solve runs on mesh row 0.
    ``step.batch`` splits the candidates over the ``dp`` rows as JAX's
    ``P("dp")`` does (row k takes ``[k B / n_dp, (k + 1) B / n_dp)``, each
    in turn on its row), ``step.descent_loop`` and ``step.chunked`` are
    JAX's other forms; ``u`` is ``[6, N]``; ``step.preconditioner(r)``
    builds the preconditioner's apply (of a ``[6, N]`` field on the mesh's
    first device).  The preconditioner is block Jacobi unless
    ``preconditioner`` or ``PLDSO_UNSTRUCTURED_PRECOND`` (read here) asks
    for scalar Jacobi.
    """
    dev, dt = shl.device, shl.dtype
    n_nodes = shl.n_nodes
    mesh = shl.mesh
    free = torch.as_tensor(np.asarray(free_mask), dtype=dt, device=dev)
    f = torch.as_tensor(np.asarray(f_ext), dtype=dt, device=dev)
    freeT0 = free.reshape(n_nodes, 6).T.contiguous()          # [6, N]
    fT0 = f.reshape(n_nodes, 6).T.contiguous()

    use_block = (preconditioner == "block_jacobi"
                 and os.environ.get("PLDSO_UNSTRUCTURED_PRECOND",
                                    "block_jacobi") == "block_jacobi")
    rows = {}

    class _Row:
        """Mesh row ``j``: its shards' steps and the replicated fields."""

        def __init__(self, j: int):
            self.j = j
            self.devices = mesh.devices[j]
            self.shards = [_ShardStep(c, shl.E_mod, shl.nu)
                           for c in shl.chunks(j)]
            self.freeT = broadcast(freeT0, self.devices)
            self.fixedT = 1.0 - self.freeT
            self.fT = broadcast(fT0, self.devices)
            self.b = self.freeT * self.fT

        def split(self, radius):
            return shl._split(radius, self.j)

        def sections(self, rs):
            return [sh.sections(r) for sh, r in zip(self.shards, rs)]

        def matvec(self, u6: Sharded, secs) -> Sharded:
            return Sharded(all_reduce_sum([
                sh.partial(u, sec) for sh, u, sec
                in zip(self.shards, u6.parts, secs)]))

        def operator(self, secs):
            freeT, fixedT = self.freeT, self.fixedT
            return lambda u6: freeT * self.matvec(freeT * u6, secs) \
                + fixedT * u6

        def preconditioner(self, rs, secs):
            """M^-1 on the row: the node blocks (or the diagonal) summed
            over the shards in rank order, each shard inverting its copy."""
            freeT = self.freeT
            with torch.no_grad():
                if use_block:
                    NB = all_reduce_sum([sh.blocks(r.detach()) for sh, r
                                         in zip(self.shards, rs)])
                    Bfull = Sharded([
                        _block_full(torch.stack(_block_jacobi_inverse(
                            _blocks_of(fr, nb))))
                        for fr, nb in zip(freeT.parts, NB)])
                    return lambda r_: _block_apply(Bfull, r_)
                diag = Sharded(all_reduce_sum([
                    sh.diag(tuple(x.detach() for x in sec))
                    for sh, sec in zip(self.shards, secs)]))
                diag = freeT * diag + (1.0 - freeT)
                diag = torch.where(diag == 0, torch.ones_like(diag), diag)
                return lambda r_: r_ / diag

        def gather(self, parts) -> torch.Tensor:
            return torch.cat([_copy(p, dev) for p in parts])

        def step(self, radius_padded):
            """(c, g) on this row: the forward solve, the adjoint solve
            against f (A is symmetric), then each shard's gradient of
            -lambda . K(r) u from its own partial."""
            with torch.no_grad():
                rs = self.split(radius_padded.detach())
                secs = self.sections(rs)
                M = self.preconditioner(rs, secs)
                A = self.operator(secs)
                x = pcg(A, self.b, M=M, maxiter=maxiter, tol=tol, ops=OPS).x
                c = torch.sum(self.fT * x)
                lam = pcg(A, self.fT, M=M, maxiter=maxiter, tol=tol,
                          ops=OPS).x
                g6 = (-lam) * self.freeT
                ux = self.freeT * x
            g = [sh.grad_partial(r, u, g_) for sh, r, u, g_ in zip(
                self.shards, rs, ux.parts, g6.parts)]
            return _copy(c.parts[0], dev), self.gather(g)

    def row(j: int = 0) -> _Row:
        if j not in rows:
            rows[j] = _Row(j)
        return rows[j]

    def step(radius_padded):
        """(compliance, gradient) at the padded radii."""
        return row(0).step(radius_padded)

    def step_batch(radius_batch):
        """The candidate population [B, Epad] split over the ``dp`` rows in
        contiguous blocks (JAX's ``P("dp")``), each candidate in turn on
        its row (JAX vmaps them; each converges as its single step does);
        the results in candidate order on the mesh's first device."""
        n_dp = mesh.shape["dp"]
        B = int(radius_batch.shape[0])
        if B % n_dp:
            raise ValueError(f"step.batch: {B} candidates do not divide "
                             f"over dp={n_dp}")
        per = B // n_dp
        out = [row(k // per).step(_copy(radius_batch[k],
                                        mesh.devices[k // per][0]))
               for k in range(B)]
        return (torch.stack([c for c, _ in out]),
                torch.stack([g for _, g in out]))

    step.batch = step_batch

    def precond_apply(radius):
        rw = row(0)
        rs = rw.split(radius.detach())
        M = rw.preconditioner(rs, rw.sections(rs))
        return lambda r_: M(broadcast(r_, rw.devices)).parts[0]

    step.preconditioner = precond_apply

    def descent_loop(radius0, n_steps: int, lr: float = 1e-4,
                     r_min: float = 0.01, r_max: float = 0.1):
        """n_steps solve+gradient+update iterations of projected gradient
        descent, a host loop: (radii after the last update, the compliance
        at the radii before it)."""
        keep = (radius0 > 0).to(radius0.dtype)
        r, c = radius0, torch.zeros((), dtype=radius0.dtype,
                                    device=radius0.device)
        for _ in range(n_steps):
            c, g = step(r)
            r = torch.clamp(r - lr * g, r_min, r_max) * keep
        return r, c

    step.descent_loop = descent_loop

    # ------------------------------------------------------------------
    # chunked drive: every pcg call is bounded to `chunk` CG iterations
    # (the host checks convergence between them, warm-starting each from
    # the last u) and the gradient comes from the compliance self-adjoint
    # identity dc/dr = -u.(dA/dr).u: one differentiated strain-energy pass
    # per shard instead of a second solve.  The radii are the same in
    # every chunk, so the sections and block factors are built once per
    # call.
    @timing.spanned("step")
    def step_chunked(radius_padded, u0=None, chunk: int = 256,
                     max_chunks: int = 64, on_fail: str = "raise"):
        """(compliance, grad, u, n_iters): warm-startable chunked solve +
        self-adjoint gradient, on mesh row 0.  ``u0``/returned ``u`` are
        [6, N] column fields on the mesh's first device; ``n_iters``
        counts ``chunk`` per pcg call, as JAX's, and
        ``step.chunked.last_iterations`` the CG iterations taken.

        Non-convergence within ``max_chunks * chunk`` iterations RAISES by
        default -- a gradient from an unconverged field silently poisons an
        optimization loop; ``on_fail="warn"`` warns (RuntimeWarning) and
        returns the best-effort gradient.
        """
        rw = row(0)
        with torch.no_grad():
            rs = rw.split(radius_padded.detach())
            secs = rw.sections(rs)
            M = rw.preconditioner(rs, secs)
            A = rw.operator(secs)
            u = rw.freeT.map(torch.zeros_like) if u0 is None \
                else broadcast(u0, rw.devices)
            iters = cg = 0
            converged, res = False, None
            for _ in range(max_chunks):
                out = pcg(A, rw.b, M=M, x0=u, maxiter=chunk, tol=tol,
                          ops=OPS)
                u, converged, res = out.x, out.converged, out.residual_norm
                iters += chunk
                cg += out.iterations
                if converged:
                    break
        if res is not None:
            res = timing.timed("sync.step", float)(res)
        if not converged:
            msg = (f"step.chunked: CG did not converge within "
                   f"{max_chunks * chunk} iterations (residual "
                   f"{res:.3e}, tol {tol:g})")
            if on_fail != "warn":
                raise RuntimeError(
                    msg + "; raise max_chunks/chunk, loosen tol, or pass "
                          "on_fail='warn' to accept the unconverged field.")
            warnings.warn(
                msg + "; the returned gradient is computed from the "
                      "unconverged displacement field.",
                RuntimeWarning, stacklevel=2)
        step_chunked.last_converged = converged
        step_chunked.last_residual = res
        step_chunked.last_iterations = cg
        c = torch.sum(rw.fT * u)
        uf = rw.freeT * u
        g = rw.gather([sh.grad_q(r, x) for sh, r, x
                       in zip(rw.shards, rs, uf.parts)])
        return _copy(c.parts[0], dev), g, _copy(u.parts[0], dev), iters

    step.chunked = step_chunked
    return step


def _blocks_of(freeT: torch.Tensor, NB: torch.Tensor):
    """The free-masked node blocks as JAX's python 6x6 list of [N] lanes
    (orphan nodes' diagonal 1)."""
    A = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(6):
            a = freeT[i] * freeT[j] * NB[_IX66[i][j]]
            if i == j:
                a = a + (1.0 - freeT[i])
                a = torch.where(a == 0, torch.ones_like(a), a)
            A[i][j] = a
    return A
