"""Design parameterizations: theta -> per-cell radii (differentiable).

The port of ``pylatticedso_tpu.opti.parameterization``: the reference's
three modes (lattice_opti.py:284-560):

* ``constant``   — one radius for every cell (or one per geometry with
  ``hybrid: true``),
* ``unit_cell``  — independent radii per cell x geometry,
* ``linear`` / ``poly2`` — a parametric field over normalized cell-center
  coordinates: r = d + span * (a x^ + b y^ + c z^ [+ quadratic terms]),
  clamped to [min_radius, max_radius].

Every map takes a tensor ``theta`` and is differentiable by autograd.  The
field modes clamp with ``minimum(maximum(r, lo), hi)``, whose gradient at a
tie is split in half as JAX's clip splits it; the normalized map clamps
straight-through (``_denorm``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

__all__ = ["Parameterization", "make_parameterization"]

_TERM_EXPONENTS = {
    "x": (1, 0, 0), "y": (0, 1, 0), "z": (0, 0, 1),
    "x2": (2, 0, 0), "y2": (0, 2, 0), "z2": (0, 0, 2),
    "xy": (1, 1, 0), "xz": (1, 0, 1), "yz": (0, 1, 1),
}


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


@dataclass
class Parameterization:
    kind: str
    n_params: int
    n_cells: int
    n_geom: int
    min_radius: float
    max_radius: float
    normalized: bool
    lower: np.ndarray
    upper: np.ndarray
    x0: np.ndarray
    _terms: Optional[List[str]] = None
    _cell_hat: Optional[np.ndarray] = None   # [C,3] normalized cell centers

    @property
    def span(self) -> float:
        return self.max_radius - self.min_radius

    def _denorm(self, v):
        if not self.normalized:
            return v
        r = v * self.span + self.min_radius
        rc = _clip(r, self.min_radius, self.max_radius)
        # straight-through clip: value clamped, gradient = span.  theta is
        # already bound-constrained to [0,1] by the optimizer, so the clip
        # only guards roundoff — but a HARD clip zeroes d(radius)/d(theta)
        # whenever the affine map lands EXACTLY on a bound (min/max ties
        # route the derivative to the constant).  That is platform-
        # dependent: under f32 arithmetic 1.0*0.09 + 0.01 == 0.1 exactly,
        # under f64 it is one ulp below — so on an f32 device every
        # bound-active parameter's gradient silently became 0.0 while an
        # f64 CPU run kept the true one-sided value (measured with the JAX
        # package: 66 of 750 components zeroed at the three-point-bending
        # solution, and SLSQP converged to visibly worse designs).
        return r + (rc - r).detach()

    def cell_radii(self, theta: torch.Tensor) -> torch.Tensor:
        """[C, G] physical radii from the parameter vector."""
        C, G = self.n_cells, self.n_geom
        theta = torch.as_tensor(theta)
        if self.kind == "constant":
            r = self._denorm(theta[0])
            return r.expand(C, G)
        if self.kind == "constant_hybrid":
            r = self._denorm(theta)
            return r[None, :].expand(C, G)
        if self.kind == "unit_cell":
            return self._denorm(theta.reshape(C, G))
        if self.kind in ("linear", "poly2"):
            coeffs = theta[:-1]
            d_phys = self._denorm(theta[-1]) if self.normalized else theta[-1]
            hat = torch.as_tensor(self._cell_hat, dtype=theta.dtype,
                                  device=theta.device)
            basis = []
            for t in self._terms:
                ex, ey, ez = _TERM_EXPONENTS[t]
                basis.append(hat[:, 0]**ex * hat[:, 1]**ey * hat[:, 2]**ez)
            s = torch.stack(basis, dim=1) @ coeffs
            r = _clip(d_phys + self.span * s, self.min_radius,
                      self.max_radius)
            return r[:, None].expand(C, G)
        raise ValueError(f"unknown parameterization {self.kind!r}")

    def edge_radius(self, theta: torch.Tensor, edge_cell: np.ndarray,
                    edge_type: np.ndarray) -> torch.Tensor:
        """Per-edge radius (primary-owner-cell assignment)."""
        cr = self.cell_radii(theta)
        ec = torch.as_tensor(edge_cell, dtype=torch.long, device=cr.device)
        et = torch.as_tensor(edge_type, dtype=torch.long, device=cr.device)
        return cr[ec, et]


def make_parameterization(lattice, opt_params: dict,
                          min_radius: float = 0.01, max_radius: float = 0.1,
                          normalized: bool = True) -> Parameterization:
    kind = opt_params.get("type", "constant")
    C, G = lattice.num_cells, lattice.config.n_geom
    mean_r0 = float(np.mean(lattice.config.radii))
    t0 = (mean_r0 - min_radius) / (max_radius - min_radius) if normalized else mean_r0
    lo_r, hi_r = (0.0, 1.0) if normalized else (min_radius, max_radius)

    if kind == "constant" and opt_params.get("hybrid", False):
        r0 = np.asarray(lattice.config.radii, dtype=float)
        x0 = (r0 - min_radius) / (max_radius - min_radius) if normalized else r0
        return Parameterization("constant_hybrid", G, C, G, min_radius, max_radius,
                                normalized, np.full(G, lo_r), np.full(G, hi_r), x0)
    if kind == "constant":
        return Parameterization("constant", 1, C, G, min_radius, max_radius,
                                normalized, np.array([lo_r]), np.array([hi_r]),
                                np.array([t0]))
    if kind == "unit_cell":
        n = C * G
        return Parameterization("unit_cell", n, C, G, min_radius, max_radius,
                                normalized, np.full(n, lo_r), np.full(n, hi_r),
                                np.full(n, t0))
    if kind in ("linear", "poly2"):
        terms = (opt_params.get("direction", ["x", "y", "z"]) if kind == "linear"
                 else opt_params.get("terms", ["x", "y", "z"]))
        terms = [t.lower() for t in terms]
        bad = [t for t in terms if t not in _TERM_EXPONENTS]
        if bad:
            raise ValueError(f"Invalid field terms {bad}")
        n = len(terms) + 1
        centers = lattice.cell_origin + 0.5 * lattice.cell_size
        mins = centers.min(axis=0)
        spans = np.maximum(centers.max(axis=0) - mins, 1e-16)
        hat = (centers - mins) / spans
        lo = np.concatenate([np.full(n - 1, -1.0), [lo_r]])
        hi = np.concatenate([np.full(n - 1, 1.0), [hi_r]])
        x0 = np.concatenate([np.zeros(n - 1), [t0]])
        return Parameterization(kind, n, C, G, min_radius, max_radius,
                                normalized, lo, hi, x0, _terms=terms,
                                _cell_hat=hat)
    raise ValueError(f"Invalid optimization parameters type {kind!r}")
