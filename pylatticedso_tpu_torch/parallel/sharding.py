"""The edge-sharded compliance step on one device (PyTorch).

The port of ``pylatticedso_tpu.parallel.sharding``, the full-lattice
(general-graph) path of ``bench.py``'s second mode.  JAX partitions the
edges over a ``jax.sharding.Mesh`` axis ``"shard"`` and the design
candidates over ``"dp"``; the card is one H100, so ``make_mesh`` returns a
one-device record and refuses more, and ``pad_edges`` never pads.

The operator keeps the JAX step's column layout: nodal fields are
``[6, N]``, per-edge work runs on ``[k, E]`` rows.  Where JAX sums each
node's half-edge contributions through its ELL table (a stable sort by
node of the positions in ``cat([e0, e1])``, :297-320) or a scatter-add,
the port sums through ``SegmentSum(cat([e0, e1]), N)``: the same table,
so the same terms in JAX's ELL order, with no atomics, and the same bits
on every call on the card.  Block Jacobi follows JAX's unrolled per-node
Cholesky term by term on ``[N]`` lanes.  Everything is plain torch: this
path reaches no Pallas kernel in the JAX package.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..fem.elements import EdgeGeometry, section_stiffness
from ..fem.operator import BeamOperator, SegmentSum
from ..fem.solve import linear_solve, pcg
from .structured import _check_device

__all__ = ["Mesh", "make_mesh", "pad_edges", "ShardedLattice",
           "make_compliance_step"]


class Mesh(NamedTuple):
    """A one-device mesh: JAX's axis names with size 1, and the device."""
    shape: dict
    device: torch.device


def make_mesh(n_shard: Optional[int] = None, n_dp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of ``n_dp x n_shard`` devices, which must be one: the
    port runs on one card (``devices`` defaults to ``["cuda"]``)."""
    devices = list(devices if devices is not None else ["cuda"])
    if n_shard is None:
        n_shard = len(devices) // n_dp
    if n_dp * n_shard != 1:
        raise ValueError(f"make_mesh: {n_dp} x {n_shard} devices requested; "
                         "the port runs on one device (n_dp = n_shard = 1)")
    return Mesh(shape={"dp": 1, "shard": 1},
                device=_check_device(devices[0]))


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


class ShardedLattice:
    """Edge-parallel matrix-free operator on the mesh's device.

    ``radius`` enters as an argument (not baked in) so one operator serves
    the whole optimization trajectory and candidate batches.  ``edges`` is
    ``[2, E]`` int64, the frames ``[E, 3]`` and ``L`` ``[E]`` in
    ``dtype``, computed with JAX's operations in JAX's order.
    """

    def __init__(self, mesh: Mesh, nodes: np.ndarray, edges: np.ndarray,
                 E_mod: float, nu: float, valid_mask: Optional[np.ndarray] = None,
                 dtype=torch.float32):
        self.mesh = mesh
        dev = self.device = mesh.device
        edges_p, (vm,), self.n_real = pad_edges(
            edges, [np.ones(len(edges)) if valid_mask is None else valid_mask],
            mesh.shape["shard"])
        self.n_nodes = len(nodes)
        self.E_mod, self.nu = E_mod, nu
        self.dtype = dtype

        self.edges = torch.as_tensor(edges_p.T.astype(np.int64), device=dev)
        self.valid = torch.as_tensor(vm[None, :], dtype=dtype, device=dev)
        self.ends = SegmentSum(self.edges.reshape(-1), self.n_nodes)
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
        a1 = a1 / torch.linalg.norm(a1, dim=1)[:, None]
        a2 = torch.linalg.cross(t, a1, dim=1)
        self.t, self.a1, self.a2, self.L = t, a1, a2, L

    # ------------------------------------------------------------------
    def section_D(self, radius: torch.Tensor) -> torch.Tensor:
        """[Epad, 6] stiffness diagonal (zero on padding)."""
        D = section_stiffness(radius, self.E_mod, self.nu).D
        return D * self.valid[0][:, None]

    def _operator(self, D: torch.Tensor) -> BeamOperator:
        return BeamOperator(edges=self.edges.T, geom=self._geom(), D=D,
                            n_nodes=self.n_nodes, ends=self.ends)

    def matvec(self, u: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
        """K.u for u [N,6]; the per-node sums in a fixed order."""
        return self._operator(D).matvec(u)

    def radius_padded(self, radius) -> torch.Tensor:
        r = torch.zeros(self.edges.shape[1], dtype=self.dtype,
                        device=self.device)
        r[: self.n_real] = torch.as_tensor(np.asarray(radius),
                                           dtype=self.dtype,
                                           device=self.device)
        return r

    def _geom(self) -> EdgeGeometry:
        return EdgeGeometry(t=self.t, a1=self.a1, a2=self.a2, L=self.L)

    def diagonal(self, D: torch.Tensor) -> torch.Tensor:
        """diag(K) [N,6] from the factored per-edge diagonal."""
        return self._operator(D).diagonal()

    def node_blocks(self, D: torch.Tensor) -> torch.Tensor:
        """Assembled per-node 6x6 diagonal blocks [N,6,6] (block Jacobi).

        Each endpoint's self-block of K_e is L B_n^T D B_n with B_n the
        6x6 column block of the strain operator; endpoint 2's is S blk S
        with S = diag(I3, -I3).
        """
        t, a1, a2, L = self.t, self.a1, self.a2, self.L
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
        return self.ends(torch.cat([blk, blk2], dim=0))


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


def make_compliance_step(shl: ShardedLattice, free_mask: np.ndarray,
                         f_ext: np.ndarray, tol: float = 1e-6,
                         maxiter: int = 4000,
                         preconditioner: str = "block_jacobi") -> Callable:
    """Value and gradient of the compliance in the per-edge radii.

    ``step(r) -> (c, g)``: one preconditioned CG solve through
    ``linear_solve`` and its adjoint (autograd through
    ``custom_linear_solve``), the block factors under ``no_grad`` as JAX's
    ``stop_gradient``.  ``step.batch``, ``step.descent_loop`` and
    ``step.chunked`` are JAX's other forms; ``u`` is ``[6, N]``;
    ``step.preconditioner(r)`` builds the preconditioner's apply.  The
    preconditioner is block Jacobi unless ``preconditioner`` or
    ``PLDSO_UNSTRUCTURED_PRECOND`` (read here) asks for scalar Jacobi.
    """
    dev, dt = shl.device, shl.dtype
    n_nodes = shl.n_nodes
    E_mod, nu = shl.E_mod, shl.nu
    G_mod = E_mod / (2.0 * (1.0 + nu))
    kappa = 0.9
    free = torch.as_tensor(np.asarray(free_mask), dtype=dt, device=dev)
    f = torch.as_tensor(np.asarray(f_ext), dtype=dt, device=dev)
    freeT = free.reshape(n_nodes, 6).T.contiguous()          # [6, N]
    fixedT = 1.0 - freeT
    fT = f.reshape(n_nodes, 6).T.contiguous()
    b = freeT * fT

    tT = shl.t.T.contiguous()            # [3, E]
    a1T = shl.a1.T.contiguous()
    a2T = shl.a2.T.contiguous()
    Lv = shl.L                           # [E]
    validv = shl.valid[0]                # [E]
    invL = 1.0 / Lv
    Lhalf = Lv * 0.5
    ends = shl.ends                      # JAX's ELL order over cat([e0, e1])
    E = int(Lv.shape[0])

    use_block = (preconditioner == "block_jacobi"
                 and os.environ.get("PLDSO_UNSTRUCTURED_PRECOND",
                                    "block_jacobi") == "block_jacobi")

    def sections(radius):
        r2 = radius * radius
        S = math.pi * r2 * validv
        I = math.pi * r2 * r2 / 4.0
        return (E_mod * S, kappa * G_mod * S, G_mod * 2.0 * I * validv,
                E_mod * I * validv)

    def strains(u6):
        g = ends.gather(u6, dim=1)                        # [6, 2E]
        g1, g2 = g[:, :E], g[:, E:]
        du = g2[:3] - g1[:3]                              # [3, E]
        ths = g1[3:] + g2[3:]
        dth = g2[3:] - g1[3:]
        dot = lambda A, B: torch.sum(A * B, dim=0)        # [E]
        return (dot(du, tT) * invL,
                dot(du, a1T) * invL - dot(ths, a2T) * 0.5,
                dot(du, a2T) * invL + dot(ths, a1T) * 0.5,
                dot(dth, tT) * invL,
                dot(dth, a1T) * invL,
                dot(dth, a2T) * invL)

    def matvec(u6, sec):                                  # [6, N]
        ES, kGS, GJ, EI = sec
        e0, e1, e2, e3, e4, e5 = strains(u6)
        s0, s1, s2 = ES * e0, kGS * e1, kGS * e2
        s3, s4, s5 = GJ * e3, EI * e4, EI * e5
        fu = s0 * tT + s1 * a1T + s2 * a2T                # [3, E]
        msh = Lhalf * (-s1 * a2T + s2 * a1T)
        mdf = s3 * tT + s4 * a1T + s5 * a2T
        c1 = torch.cat([-fu, msh - mdf])                  # [6, E]
        c2 = torch.cat([fu, msh + mdf])
        return ends(torch.cat([c1, c2], dim=1), dim=1)

    def operator(sec):
        return lambda u6: freeT * matvec(freeT * u6, sec) + fixedT * u6

    def block_factors(radius):
        """The [6, 6, N] inverse node blocks of the free-masked operator:
        each node's 21 self-block entries summed in a fixed order, then
        JAX's unrolled Cholesky on [N] lanes."""
        ES, kGS, GJ, EI = sections(radius)
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
        NB = ends(torch.cat([torch.stack(V1), torch.stack(V2)], dim=1),
                  dim=1)                         # [21, N]
        A = [[None] * 6 for _ in range(6)]
        for i in range(6):
            for j in range(6):
                a = freeT[i] * freeT[j] * NB[_IX66[i][j]]
                if i == j:
                    a = a + (1.0 - freeT[i])
                    a = torch.where(a == 0, torch.ones_like(a), a)
                A[i][j] = a
        return _block_full(torch.stack(_block_jacobi_inverse(A)))

    def preconditioner_of(radius, sec):
        with torch.no_grad():
            if use_block:
                Bfull = block_factors(radius.detach())
                return lambda r_: _block_apply(Bfull, r_)
            ES, kGS, GJ, EI = (s.detach() for s in sec)
            t2, a12, a22 = tT * tT, a1T * a1T, a2T * a2T
            d_u = (ES * t2 + kGS * (a12 + a22)) * invL        # [3, E]
            d_th = (kGS * (a22 + a12)) * (Lv * 0.25) \
                + (GJ * t2 + EI * (a12 + a22)) * invL
            dvec = torch.cat([d_u, d_th])                     # [6, E]
            diag = ends(torch.cat([dvec, dvec], dim=1), dim=1)
            diag = freeT * diag + (1.0 - freeT)
            diag = torch.where(diag == 0, torch.ones_like(diag), diag)
            return lambda r_: r_ / diag

    def compliance(radius):
        sec = sections(radius)
        M = preconditioner_of(radius, sec)
        u = linear_solve(operator(sec), b, M=M, maxiter=maxiter, tol=tol)
        return torch.sum(fT * u)

    def step(radius_padded):
        """(compliance, gradient) at the padded radii."""
        r = radius_padded.detach().requires_grad_(True)
        with torch.enable_grad():
            c = compliance(r)
            g, = torch.autograd.grad(c, r)
        return c.detach(), g

    def step_batch(radius_batch):
        """The candidate population [B, E] one candidate after another
        (JAX vmaps them; each converges as its single step does)."""
        out = [step(r) for r in radius_batch]
        return (torch.stack([c for c, _ in out]),
                torch.stack([g for _, g in out]))

    step.batch = step_batch
    step.preconditioner = lambda radius: preconditioner_of(
        radius, sections(radius.detach()))

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
    # instead of a second solve.  The radii are the same in every chunk,
    # so the sections and block factors are built once per call.
    def grad_q(radius, u6):
        e = strains(freeT * u6)

        def q(r):
            ES, kGS, GJ, EI = sections(r)
            # strain-energy form: u.K.u = sum_e (ES e0^2 + kGS (e1^2+e2^2)
            # + GJ e3^2 + EI (e4^2+e5^2)) L  -- no per-node sum needed
            return torch.sum((ES * e[0] * e[0] + kGS * (e[1] * e[1] + e[2] * e[2])
                              + GJ * e[3] * e[3] + EI * (e[4] * e[4] + e[5] * e[5]))
                             * Lv)

        r = radius.detach().requires_grad_(True)
        with torch.enable_grad():
            g, = torch.autograd.grad(q(r), r)
        return -g

    def step_chunked(radius_padded, u0=None, chunk: int = 256,
                     max_chunks: int = 64, on_fail: str = "raise"):
        """(compliance, grad, u, n_iters): warm-startable chunked solve +
        self-adjoint gradient.  ``u0``/returned ``u`` are [6, N] column
        fields; ``n_iters`` counts ``chunk`` per pcg call, as JAX's, and
        ``step.chunked.last_iterations`` the CG iterations taken.

        Non-convergence within ``max_chunks * chunk`` iterations RAISES by
        default -- a gradient from an unconverged field silently poisons an
        optimization loop; ``on_fail="warn"`` warns (RuntimeWarning) and
        returns the best-effort gradient.
        """
        with torch.no_grad():
            sec = sections(radius_padded)
            M = preconditioner_of(radius_padded, sec)
            A = operator(sec)
            u = torch.zeros((6, n_nodes), dtype=dt, device=dev) \
                if u0 is None else u0
            iters = cg = 0
            converged, res = False, None
            for _ in range(max_chunks):
                out = pcg(A, b, M=M, x0=u, maxiter=chunk, tol=tol)
                u, converged, res = out.x, out.converged, out.residual_norm
                iters += chunk
                cg += out.iterations
                if converged:
                    break
        if not converged:
            msg = (f"step.chunked: CG did not converge within "
                   f"{max_chunks * chunk} iterations (residual "
                   f"{float(res):.3e}, tol {tol:g})")
            if on_fail != "warn":
                raise RuntimeError(
                    msg + "; raise max_chunks/chunk, loosen tol, or pass "
                          "on_fail='warn' to accept the unconverged field.")
            warnings.warn(
                msg + "; the returned gradient is computed from the "
                      "unconverged displacement field.",
                RuntimeWarning, stacklevel=2)
        step_chunked.last_converged = converged
        step_chunked.last_residual = float(res) if res is not None else None
        step_chunked.last_iterations = cg
        c = torch.sum(fT * u)
        g = grad_q(radius_padded, u)
        return c, g, u, iters

    step.chunked = step_chunked
    return step
