"""Plain reference of the benchmark's lattices: an n^3 Octet beam lattice
of 2-node Timoshenko beams, clamped on z = 0 and loaded in -z on z = n.

It is written from the published description alone and imports nothing of
the program under test:

* Octet truss: in a unit cell, every pair of its 8 corners and 6 face
  centers at distance sqrt(2)/2 is a strut (24 face-center-to-corner
  struts, 12 octahedron edges).  Struts on a face are shared by the two
  cells beside it and exist once.
* Beam: circular section of radius r, S = pi r^2, I = pi r^4 / 4, J = 2 I,
  shear factor kappa, G = E / (2 (1 + nu)).  Generalized strains, with du,
  dth the end differences and ths the end sum of the rotations, in a local
  frame (t, a1, a2) of length L:
      e0 = du.t / L, e1 = du.a1 / L - ths.a2 / 2, e2 = du.a2 / L + ths.a1 / 2,
      e3 = dth.t / L, e4 = dth.a1 / L, e5 = dth.a2 / L
  and energy L/2 sum_k D_k e_k^2 with D = (ES, kGS, kGS, GJ, EI, EI).
  The stiffness of a circular section does not depend on the choice of
  a1 and a2, so the frame here is built by its own rule.
* Compliance c = f.u with K(r) u = f on the free DOFs and u = 0 on the
  clamped ones; dc/dr of a strut = -L sum_k dD_k/dr e_k^2 at the solution.
  A per-cell radius sets every strut the cell creates; a shared strut takes
  the radius of the lower-indexed of its two cells.

Nodes are keyed by their doubled coordinates (integers in [0, 2n]) and
numbered in the order of the key (x slowest).  Every array is a torch
tensor on ``device``; the operator and the gradient run over the struts in
blocks, so that 100^3 (24,120,000 struts) fits beside nothing else.
"""

from __future__ import annotations

import math

import torch

__all__ = ["OctetLattice", "template", "node_classes", "strut_types"]

BLOCK = 1 << 22                 # struts per block of the operator


def template() -> torch.Tensor:
    """The unit cell's struts as doubled endpoint coordinates [36, 2, 3]."""
    pts = [(x, y, z) for x in (0, 2) for y in (0, 2) for z in (0, 2)]
    for ax in range(3):
        for side in (0, 2):
            p = [1, 1, 1]
            p[ax] = side
            pts.append(tuple(p))
    beams = []
    for i in range(len(pts)):
        for j in range(i + 1, len(pts)):
            d2 = sum((a - b) ** 2 for a, b in zip(pts[i], pts[j]))
            if d2 == 2:                     # (sqrt(2)/2)^2, doubled
                beams.append((pts[i], pts[j]))
    return torch.tensor(beams, dtype=torch.int64)


def node_classes() -> torch.Tensor:
    """The distinct node positions of a cell modulo the lattice period, as
    doubled offsets in [0, 1]^3, sorted: [4, 3] for the Octet."""
    t = template().reshape(-1, 3) % 2
    return torch.unique(t, dim=0)


def strut_types() -> int:
    """The cell's struts modulo the lattice period (a strut on a face and
    its translate on the opposite face are one type): 24 for the Octet."""
    seen = set()
    for a, b in template().tolist():
        a, b = sorted((tuple(a), tuple(b)))
        s = tuple(2 * (x // 2) for x in a)
        seen.add((tuple(x - o for x, o in zip(a, s)),
                  tuple(x - o for x, o in zip(b, s))))
    return len(seen)


class OctetLattice:
    """The n^3 Octet lattice, its loads and its beam operator in plain torch.

    ``load`` is the total force on the top face (-z), split evenly over its
    nodes.
    """

    def __init__(self, n: int, E: float, nu: float, kappa: float,
                 load: float, device="cpu"):
        self.n, self.E, self.nu, self.kappa = n, float(E), float(nu), \
            float(kappa)
        self.device = torch.device(device)
        dev = self.device
        w = 2 * n + 1
        self.width = w
        # nodes: doubled coordinates with 0 or 2 odd entries (corners and
        # face centers), numbered by key
        g = torch.arange(w, device=dev)
        gx, gy, gz = torch.meshgrid(g, g, g, indexing="ij")
        odd = (gx % 2) + (gy % 2) + (gz % 2)
        is_node = ((odd == 0) | (odd == 2)).reshape(-1)
        self.node_of_key = torch.full((w ** 3,), -1, dtype=torch.int64,
                                      device=dev)
        self.n_nodes = int(is_node.sum())
        self.node_of_key[is_node] = torch.arange(self.n_nodes, device=dev)
        keys = torch.nonzero(is_node).reshape(-1)
        self.doubled = torch.stack([keys // (w * w), (keys // w) % w,
                                    keys % w], dim=1)          # [N, 3]
        self.pos = self.doubled.to(torch.float64) * 0.5

        # struts: every cell's 36, deduplicated by their node pair; the
        # owner is the smallest creating cell (C order)
        T = template().to(dev)                                  # [36, 2, 3]
        c = torch.arange(n, device=dev)
        cx, cy, cz = torch.meshgrid(c, c, c, indexing="ij")
        cells = torch.stack([cx, cy, cz], dim=-1).reshape(-1, 1, 1, 3)
        ends = 2 * cells + T[None]                              # [C,36,2,3]
        kk = (ends[..., 0] * w + ends[..., 1]) * w + ends[..., 2]
        del ends
        nid = self.node_of_key[kk]                              # [C, 36, 2]
        del kk
        lo = torch.minimum(nid[..., 0], nid[..., 1]).reshape(-1)
        hi = torch.maximum(nid[..., 0], nid[..., 1]).reshape(-1)
        del nid
        pair = lo * self.n_nodes + hi
        del lo, hi
        uniq, inv = torch.unique(pair, return_inverse=True)
        del pair
        self.n_beams = int(uniq.numel())
        self.beams = torch.stack([uniq // self.n_nodes,
                                  uniq % self.n_nodes], dim=1)  # [E, 2]
        del uniq
        cell_of = torch.arange(n ** 3, device=dev).repeat_interleave(
            T.shape[0])
        self.owner = torch.full((self.n_beams,), n ** 3, dtype=torch.int64,
                                device=dev).scatter_reduce(
            0, inv, cell_of, reduce="amin")
        del inv, cell_of

        z2 = self.doubled[:, 2]
        self.fixed = z2 == 0                                    # [N]
        top = z2 == 2 * n
        self.f = torch.zeros((self.n_nodes, 6), dtype=torch.float64,
                             device=dev)
        self.f[top, 2] = -float(load) / int(top.sum())

    # ------------------------------------------------------------------
    def node_index(self, doubled: torch.Tensor) -> torch.Tensor:
        """Node numbers of doubled coordinates [..., 3] (-1: no node)."""
        d = doubled.to(torch.int64)
        w = self.width
        inside = ((d >= 0) & (d < w)).all(-1)
        k = (d[..., 0] * w + d[..., 1]) * w + d[..., 2]
        out = self.node_of_key[k.clamp(0, w ** 3 - 1)]
        return torch.where(inside, out, torch.full_like(out, -1))

    def beam_index(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Strut numbers of node pairs (either order; -1: no strut)."""
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        key = lo * self.n_nodes + hi
        mine = self.beams[:, 0] * self.n_nodes + self.beams[:, 1]
        at = torch.searchsorted(mine, key).clamp(max=self.n_beams - 1)
        return torch.where(mine[at] == key, at, torch.full_like(at, -1))

    def beam_radius(self, cell_radius: torch.Tensor) -> torch.Tensor:
        """Per-strut radius from a per-cell field [n, n, n]."""
        return cell_radius.reshape(-1)[self.owner]

    def per_cell(self, per_beam: torch.Tensor) -> torch.Tensor:
        """Sum of a per-strut quantity over each cell's owned struts."""
        out = torch.zeros(self.n ** 3, dtype=per_beam.dtype,
                          device=per_beam.device)
        out.index_add_(0, self.owner, per_beam)
        return out.reshape(self.n, self.n, self.n)

    # ------------------------------------------------------------------
    def _block(self, s: int, e: int, u: torch.Tensor, r: torch.Tensor,
               dt: torch.dtype):
        """Ends, length, frame, section stiffness and strains of struts
        [s, e), computed in ``dt``."""
        ia, ib = self.beams[s:e, 0], self.beams[s:e, 1]
        d = self.pos[ib] - self.pos[ia]
        L = torch.linalg.vector_norm(d, dim=1)
        t = d / L[:, None]
        ex = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64,
                          device=d.device)
        ey = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64,
                          device=d.device)
        h = torch.where((t[:, 0].abs() < 0.9)[:, None], ex, ey)
        a1 = h - (h * t).sum(1, keepdim=True) * t
        a1 = a1 / torch.linalg.vector_norm(a1, dim=1, keepdim=True)
        a2 = torch.linalg.cross(t, a1, dim=1)
        t, a1, a2, L = (x.to(dt) for x in (t, a1, a2, L))
        rr = r[s:e].to(dt)
        G = self.E / (2.0 * (1.0 + self.nu))
        S = math.pi * rr * rr
        I = math.pi * rr ** 4 / 4.0
        D = (self.E * S, self.kappa * G * S, self.kappa * G * S,
             G * 2.0 * I, self.E * I, self.E * I)
        ua, ub = u[ia].to(dt), u[ib].to(dt)
        du, dth = ub[:, :3] - ua[:, :3], ub[:, 3:] - ua[:, 3:]
        ths = ua[:, 3:] + ub[:, 3:]
        dot = lambda x, y: (x * y).sum(1)
        e = (dot(du, t) / L,
             dot(du, a1) / L - dot(ths, a2) * 0.5,
             dot(du, a2) / L + dot(ths, a1) * 0.5,
             dot(dth, t) / L, dot(dth, a1) / L, dot(dth, a2) / L)
        return ia, ib, L, (t, a1, a2), rr, D, e

    def apply(self, u: torch.Tensor, r: torch.Tensor,
              dt: torch.dtype = torch.float64) -> torch.Tensor:
        """K(r) u over every strut, [N, 6] in ``dt`` (no boundary
        conditions): the gradient of the strain energy in u."""
        out = torch.zeros((self.n_nodes, 6), dtype=dt, device=u.device)
        for s in range(0, self.n_beams, BLOCK):
            e_ = min(s + BLOCK, self.n_beams)
            ia, ib, L, (t, a1, a2), _r, D, e = self._block(s, e_, u, r, dt)
            sk = [Dk * ek for Dk, ek in zip(D, e)]
            col = lambda x: x[:, None]
            fu = col(sk[0]) * t + col(sk[1]) * a1 + col(sk[2]) * a2
            msh = col(L * 0.5) * (col(sk[2]) * a1 - col(sk[1]) * a2)
            mb = col(sk[3]) * t + col(sk[4]) * a1 + col(sk[5]) * a2
            out.index_add_(0, ia, torch.cat([-fu, msh - mb], dim=1))
            out.index_add_(0, ib, torch.cat([fu, msh + mb], dim=1))
        return out

    def dc_dr(self, u: torch.Tensor, r: torch.Tensor,
              dt: torch.dtype = torch.float64) -> torch.Tensor:
        """Per-strut compliance gradient -L sum_k dD_k/dr e_k^2 at u."""
        out = torch.empty(self.n_beams, dtype=dt, device=u.device)
        G = self.E / (2.0 * (1.0 + self.nu))
        for s in range(0, self.n_beams, BLOCK):
            e_ = min(s + BLOCK, self.n_beams)
            _a, _b, L, _f, rr, _D, e = self._block(s, e_, u, r, dt)
            dS = 2.0 * math.pi * rr
            dI = math.pi * rr ** 3
            dD = (self.E * dS, self.kappa * G * dS, self.kappa * G * dS,
                  G * 2.0 * dI, self.E * dI, self.E * dI)
            acc = sum(dk * ek * ek for dk, ek in zip(dD, e))
            out[s:e_] = -L * acc
        return out

    def residual(self, u: torch.Tensor, r: torch.Tensor,
                 dt: torch.dtype = torch.float64) -> float:
        """Relative residual of u as the solution: the free DOFs' f - K u
        and the clamped DOFs' u, over |f|."""
        fixed = self.fixed[:, None].to(torch.float64)
        uf = u.to(torch.float64) * (1.0 - fixed)
        Ku = self.apply(uf, r, dt).to(torch.float64)
        res = (self.f - Ku) * (1.0 - fixed)
        num = torch.sqrt((res * res).sum()
                         + ((u.to(torch.float64) * fixed) ** 2).sum())
        return float(num / torch.linalg.vector_norm(self.f))

    def compliance(self, u: torch.Tensor) -> float:
        return float((self.f * u.to(torch.float64)).sum())

