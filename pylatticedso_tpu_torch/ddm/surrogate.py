"""Reduced-basis + interpolation surrogates for cell Schur complements
(PyTorch).

The port of ``pylatticedso_tpu.ddm.surrogate``.  Offline: a greedy
orthonormal basis over vectorized Schur matrices (Fortran-order ravel),
the reference's algorithm and npz artifact schema (greedy_algorithm.py:
35-233: keys ``basis_reduced_ortho`` [n_b^2, m], ``alpha_ortho``
[m, n_samples], ``list_elements`` [n_samples, d]).  The greedy pass and the
npz files are numpy, as in the JAX package: both packages give the same
basis bytes for the same Schur dict, and load each other's files.

Online: interpolate the reduced coordinates alpha(mu) over the sampled
radii by nearest-neighbor, (multi)linear, or thin-plate-spline RBF
(utils_rbf.py:13-144) and reconstruct S(mu) = unravel(basis @ alpha(mu)).
The TPS-RBF fit is a host solve; its evaluation is torch on the query's
device, differentiable by autograd (dS/dr flows through it).  The
Fortran-order unravel of a vector is the transpose of its row-major
reshape.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.timing import timing

__all__ = ["reduce_basis_greedy", "save_reduced_basis", "load_reduced_basis",
           "ThinPlateSplineRBF", "SchurSurrogate"]


@timing.timeit(category="ddm")
def reduce_basis_greedy(schur_dict: Dict[tuple, np.ndarray], tol: float,
                        verbose: int = 0):
    """Greedy orthonormal basis over normalized vectorized Schur matrices.

    Returns (basis [n^2, m], alpha [m, n_samples], list_elements
    [n_samples, d]).  Selection: repeatedly take the residual column with the
    largest inf-norm, normalize, deflate — stopping at
    ``tol * ||fields||_inf`` (greedy_algorithm.py:100-128).

    The JAX package's numpy arithmetic, operation for operation (the same
    bytes for the same dict), with one [n^2, n_samples] scratch buffer in
    place of the temporaries of ``np.linalg.norm`` and ``np.outer``: |resid|
    is formed once a step, for the stopping test and the next selection.
    """
    keys = sorted(schur_dict.keys())
    list_elements = np.array([list(k) for k in keys], dtype=float)
    fields = np.stack([np.ravel(schur_dict[k], order="F") for k in keys], axis=1)
    norms = np.linalg.norm(fields, axis=0)
    normalized = fields / norms[None, :]

    resid = normalized.copy()
    absr = np.abs(resid)                 # |resid|, then the scratch buffer

    def inf_norm_of_transpose():
        # np.linalg.norm(resid.T, np.inf): the largest column sum of |resid|
        return np.add.reduce(absr.T, axis=1).max(axis=0)

    atol = tol * inf_norm_of_transpose()
    basis = []
    n_samples = fields.shape[1]
    for _ in range(n_samples):
        col_norms = absr.max(axis=0)     # np.linalg.norm(resid, inf, axis=0)
        s = int(np.argmax(col_norms))
        v = resid[:, s]
        nv = np.linalg.norm(v)
        if nv == 0:
            break
        v = v / nv
        if basis:  # re-orthogonalize against drift of classical deflation
            Bp = np.column_stack(basis)
            v = v - Bp @ (Bp.T @ v)
            v = v / np.linalg.norm(v)
        # resid -= np.outer(v, v @ resid)
        np.multiply(v[:, None], (v @ resid)[None, :], out=absr)
        resid -= absr
        basis.append(v)
        np.abs(resid, out=absr)
        if inf_norm_of_transpose() < atol:
            break
    B = np.column_stack(basis)
    # exact reduced coordinates of the *unnormalized* fields
    alpha = B.T @ fields
    if verbose:
        print(f"reduced basis: {B.shape[1]} vectors for {n_samples} samples")
    return B, alpha, list_elements


def save_reduced_basis(path, basis, alpha, list_elements) -> None:
    np.savez(path, basis_reduced_ortho=basis, alpha_ortho=alpha,
             list_elements=list_elements)


def load_reduced_basis(path) -> dict:
    d = np.load(path)
    return {k: d[k] for k in ("basis_reduced_ortho", "alpha_ortho", "list_elements")}


def _on(cache: dict, fields: Dict[str, np.ndarray], like: torch.Tensor):
    """The numpy ``fields`` as tensors on ``like``'s device and dtype, moved
    once per (device, dtype) and kept in ``cache``."""
    key = (like.device, like.dtype)
    t = cache.get(key)
    if t is None:
        t = cache[key] = {k: torch.as_tensor(v, dtype=like.dtype,
                                             device=like.device)
                          for k, v in fields.items()}
    return t


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)``: piecewise-linear over the sorted ``xp``,
    ``fp[0]`` left of ``xp[0]`` and ``fp[-1]`` right of ``xp[-1]``;
    ``fp``'s leading dimensions are interpolated alike ([..., n])."""
    n = xp.shape[0]
    x = torch.as_tensor(x, dtype=xp.dtype, device=xp.device)
    i = torch.clamp(torch.searchsorted(xp, x.reshape(1), right=True),
                    1, n - 1)[0]
    df = fp[..., i] - fp[..., i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float64 if xp.dtype == torch.float64
                                    else np.float32).eps))
    dx0 = torch.abs(dx) <= eps       # no NaN gradient for a repeated xp
    one = torch.ones_like(dx)
    f = torch.where(dx0, fp[..., i - 1],
                    fp[..., i - 1] + (delta / torch.where(dx0, one, dx)) * df)
    f = torch.where(x < xp[0], fp[..., 0], f)
    return torch.where(x > xp[-1], fp[..., -1], f)


class ThinPlateSplineRBF:
    """TPS RBF interpolator phi(r) = r^2 log r + linear tail.

    Fit on the host (dense solve of the bordered system, numpy float64);
    evaluate and differentiate in torch on the query's device and dtype.
    """

    def __init__(self, x_train, y_train, reg: float = 0.0):
        pts = np.asarray(x_train, dtype=float)
        targets = np.asarray(y_train, dtype=float)
        if targets.ndim == 1:
            targets = targets[:, None]
        n_pts, d = pts.shape
        # kernel matrix via the same r=0-safe form the device eval uses:
        # r^2 log r = 0.5 * r^2 log r^2
        sq = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=2)
        kmat = 0.5 * sq * np.log(np.where(sq > 0, sq, 1.0))
        if reg > 0:
            kmat += reg * np.eye(n_pts)
        poly = np.hstack([np.ones((n_pts, 1)), pts])
        # bordered system enforcing polynomial reproduction / orthogonality
        npoly = d + 1
        bordered = np.zeros((n_pts + npoly, n_pts + npoly))
        bordered[:n_pts, :n_pts] = kmat
        bordered[:n_pts, n_pts:] = poly
        bordered[n_pts:, :n_pts] = poly.T
        rhs = np.zeros((n_pts + npoly, targets.shape[1]))
        rhs[:n_pts] = targets
        coeffs = np.linalg.solve(bordered, rhs)
        self.x_train = pts
        self.W = coeffs[:n_pts]       # RBF weights
        self.CP = coeffs[n_pts:]      # polynomial-tail weights
        self.d = d
        self.m = targets.shape[1]
        self._cache: dict = {}

    def _t(self, x: torch.Tensor):
        return _on(self._cache, {"x_train": self.x_train, "W": self.W,
                                 "CP": self.CP}, x)

    def evaluate_batch(self, X: torch.Tensor) -> torch.Tensor:
        """f(x) for queries [B, d] -> [B, m] in one expression;
        autograd-safe at r = 0."""
        t = self._t(X)
        diff = X[:, None, :] - t["x_train"][None]
        r2 = torch.sum(diff**2, dim=2)
        # r^2 log r = 0.5 * r^2 log r^2; safe log at 0
        phi = 0.5 * r2 * torch.log(torch.where(r2 > 0, r2,
                                               torch.ones_like(r2)))
        tail = torch.cat([torch.ones_like(X[:, :1]), X], dim=1)
        return phi @ t["W"] + tail @ t["CP"]

    def evaluate(self, x: torch.Tensor) -> torch.Tensor:
        """f(x) for a single query [d] -> [m]."""
        return self.evaluate_batch(x[None])[0]

    __call__ = evaluate

    def gradient(self, x: torch.Tensor) -> torch.Tensor:
        """Closed-form [d, m] gradient (utils_rbf.py:108-144)."""
        t = self._t(x)
        diff = x[None, :] - t["x_train"]
        r2 = torch.sum(diff**2, dim=1)
        pos = r2 > 0
        fac = torch.where(pos, torch.log(torch.where(pos, r2,
                                                     torch.ones_like(r2)))
                          + 1.0, torch.zeros_like(r2))
        G = torch.einsum("n,nd,nm->dm", fac, diff, t["W"])
        return G + t["CP"][1:]


@dataclass
class SchurSurrogate:
    """S(mu) reconstruction from a reduced basis + alpha interpolator.

    kind: "nearest_neighbor" | "linear" | "RBF" (lattice_sim.py:921-1018).
    The fields are numpy; a query that is a tensor is answered on its
    device, any other on ``device`` (default ``"cuda"``), in float64.
    """

    basis: np.ndarray          # [n^2, m]
    alpha: np.ndarray          # [m, n_samples]
    samples: np.ndarray        # [n_samples, d]
    kind: str = "RBF"
    device: str = "cuda"
    _rbf: Optional[ThinPlateSplineRBF] = field(default=None, repr=False)
    _lin: object = field(default=None, init=False, repr=False)
    _cache: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    def __post_init__(self):
        if self.kind == "RBF":
            self._rbf = ThinPlateSplineRBF(self.samples, self.alpha.T)
        elif self.kind == "linear" and self.samples.shape[1] > 1:
            from scipy.interpolate import LinearNDInterpolator
            self._lin = LinearNDInterpolator(self.samples, self.alpha.T)

    @classmethod
    def from_npz(cls, path, kind: str = "RBF",
                 device="cuda") -> "SchurSurrogate":
        d = load_reduced_basis(path)
        return cls(basis=d["basis_reduced_ortho"], alpha=d["alpha_ortho"],
                   samples=d["list_elements"], kind=kind, device=device)

    @property
    def n_boundary(self) -> int:
        return int(np.sqrt(self.basis.shape[0]))

    def _mu(self, mu) -> torch.Tensor:
        if isinstance(mu, torch.Tensor):
            return torch.atleast_1d(mu.to(torch.float64))
        from ..parallel.structured import _check_device
        return torch.atleast_1d(torch.as_tensor(
            np.asarray(mu, dtype=float), device=_check_device(self.device)))

    def _t(self, like: torch.Tensor):
        return _on(self._cache, {"basis": self.basis, "alpha": self.alpha,
                                 "samples": self.samples}, like)

    def alpha_of(self, mu) -> torch.Tensor:
        mu = self._mu(mu)
        if self.kind == "RBF":
            return self._rbf.evaluate(mu)
        t = self._t(mu)
        if self.kind == "nearest_neighbor":
            d2 = torch.sum((t["samples"] - mu[None, :])**2, dim=1)
            return t["alpha"][:, torch.argmin(d2)]
        if self.kind == "linear":
            if self._lin is not None:
                out = np.asarray(self._lin(mu.detach().cpu().numpy()[None]))[0]
                if np.isnan(out).any():
                    raise ValueError(f"query {mu} outside interpolation hull")
                return torch.as_tensor(out, dtype=mu.dtype, device=mu.device)
            # 1-D: piecewise-linear on the sorted grid
            xs = t["samples"][:, 0]
            order = torch.argsort(xs)
            return _interp(mu[0], xs[order], t["alpha"][:, order])
        raise ValueError(f"unknown surrogate kind {self.kind!r}")

    def reconstruct(self, mu) -> torch.Tensor:
        """S(mu): [n_b, n_b] (Fortran-order unravel of basis @ alpha)."""
        n = self.n_boundary
        a = self.alpha_of(mu)
        vec = self._t(a)["basis"] @ a
        return vec.reshape(n, n).T

    def reconstruct_batch(self, mus) -> torch.Tensor:
        """Batched reconstruction — one GEMM over all queries
        (get_schur_complement_from_reduced_basis_batch, lattice_sim.py:921-978)."""
        mus = self._mu(mus)
        if self.kind == "RBF":
            A = self._rbf.evaluate_batch(mus).T
        else:
            A = torch.stack([self.alpha_of(m) for m in mus], dim=1)
        n = self.n_boundary
        V = self._t(A)["basis"] @ A                 # [n^2, q]
        return V.reshape(n, n, -1).permute(2, 1, 0)

    def gradient(self, mu) -> torch.Tensor:
        """dS/dmu: [d, n_b, n_b] via the differentiable alpha path."""
        n = self.n_boundary
        if self.kind == "RBF":
            mu = self._mu(mu)
            dA = self._rbf.gradient(mu)                          # [d, m]
            V = torch.einsum("nm,dm->dn", self._t(mu)["basis"], dA)
            return V.reshape(-1, n, n).permute(0, 2, 1)
        raise NotImplementedError("analytic dS only for the RBF surrogate")
