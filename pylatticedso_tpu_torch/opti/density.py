"""Relative density: analytic, voxel-exact (device), and GPR surrogate.

The port of ``pylatticedso_tpu.opti.density``.  The reference computes
"exact" cell relative densities with gmsh CAD boolean unions
(surrogate_model_relative_densities.py:102-177) and interpolates them with
a scikit-learn GPR pipeline whose mean (and hand-derived exact gradient,
:878-987) feed the optimizer's density constraint.  Here:

* ``density_analytic``   — sum of pi r^2 L / V (the design layer's
  Cell.relative_density, cell.py:169-176),
* ``density_voxel``      — union-of-cylinders volume fraction by dense grid
  quadrature on the device: vectorized point-segment distance over a
  supersampled grid clipped to the cell box.
* ``KrigingDensity``     — GPR (StandardScaler -> RBF GPR, normalize_y) whose
  *fit* runs on the host with scikit-learn (the reference pipeline,
  :522-671; imported only inside ``fit``, so a host without scikit-learn
  raises ImportError there) and whose mean evaluates in closed form in
  torch, so the density constraint is differentiable by autograd.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["density_analytic", "density_voxel", "density_dataset",
           "filter_outliers", "KrigingDensity"]

_FIELDS = ("X_train_scaled", "alpha", "length_scale", "const", "y_mean",
           "y_std", "scaler_mean", "scaler_scale")


def density_analytic(lattice, radii_per_type: Optional[np.ndarray] = None) -> float:
    """Mean of per-cell beam-volume sums (no overlap correction)."""
    if radii_per_type is None:
        return lattice.get_relative_density()
    scale = np.asarray(radii_per_type)[lattice.edge_type] / np.maximum(lattice.radius, 1e-300)
    vols = np.pi * (lattice.radius * scale) ** 2 * lattice.edge_lengths_rounded
    per_cell = np.add.reduceat(vols[lattice.cell_edge_idx], lattice.cell_edge_ptr[:-1])
    per_cell = np.where(np.diff(lattice.cell_edge_ptr) > 0, per_cell, 0.0)
    return float((per_cell / np.prod(lattice.cell_size, axis=1)).mean())


def _segment_distance_sq(points: torch.Tensor, p1: torch.Tensor,
                         p2: torch.Tensor) -> torch.Tensor:
    """Squared distance from each point to each segment: [P, E]."""
    d = p2 - p1                                   # [E,3]
    L2 = torch.clamp_min(torch.sum(d * d, dim=1), 1e-30)
    w = points[:, None, :] - p1[None, :, :]       # [P,E,3]
    t = torch.clamp(torch.einsum("pei,ei->pe", w, d) / L2, 0.0, 1.0)
    proj = p1[None] + t[..., None] * d[None]
    diff = points[:, None, :] - proj
    return torch.einsum("pei,pei->pe", diff, diff)


def _grid_points(n: int) -> np.ndarray:
    axis = (np.arange(n) + 0.5) / n
    X, Y, Z = np.meshgrid(axis, axis, axis, indexing="ij")
    return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1).astype(np.float32)


def _device(device) -> torch.device:
    from ..parallel.structured import _check_device
    return _check_device(device)


def density_voxel(frac_beams: np.ndarray, radii: np.ndarray,
                  resolution: int = 64, batch: int = 65536,
                  device="cuda") -> float:
    """Volume fraction of the union of cylinders inside the unit cube.

    ``frac_beams``: [E,6] fractional beam coordinates (catalog format);
    ``radii``: per-beam radius in cell units.  Midpoint quadrature on a
    resolution^3 grid in float32 on ``device`` — O(h^2) accurate for smooth
    unions; resolution 64 matches the committed CAD dataset to ~1e-3, 128
    to ~3e-4.
    """
    dev = _device(device)
    f32 = torch.float32
    p1 = torch.as_tensor(np.asarray(frac_beams)[:, :3], dtype=f32, device=dev)
    p2 = torch.as_tensor(np.asarray(frac_beams)[:, 3:], dtype=f32, device=dev)
    r2 = torch.as_tensor(np.asarray(radii, dtype=np.float32) ** 2, device=dev)
    n = resolution
    pts = _grid_points(n)
    total = 0
    for s in range(0, len(pts), batch):
        chunk = torch.as_tensor(pts[s:s + batch], device=dev)
        d2 = _segment_distance_sq(chunk, p1, p2)
        total += int(torch.sum(torch.any(d2 <= r2[None, :], dim=1)))
    return total / float(n**3)


def density_dataset(geom_types: Sequence[str], radius_grid: Sequence[float],
                    resolution: int = 96, resume_path=None,
                    save_every: int = 10,
                    device="cuda") -> Dict[Tuple[float, ...], float]:
    """Exact-density dataset over a radius grid.

    Mirrors compute_relative_densities_dataset
    (surrogate_model_relative_densities.py:102-177) with voxel quadrature in
    place of gmsh CAD booleans.  ``resume_path`` enables the reference's
    crash-safe incremental generation: existing entries are reloaded, only
    missing combos are computed, and progress is checkpointed atomically
    every ``save_every`` samples.  The quadrature runs on ``device``.
    """
    import pickle
    from itertools import product
    from pathlib import Path

    from ..catalog import get_beam_structure

    out: Dict[Tuple[float, ...], float] = {}
    if resume_path is not None and Path(resume_path).exists():
        with open(resume_path, "rb") as fh:
            out = pickle.load(fh)

    def checkpoint():
        if resume_path is None:
            return
        import os
        import tempfile
        p = Path(resume_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=p.parent)
        with os.fdopen(fd, "wb") as fh:
            pickle.dump(out, fh)
        os.replace(tmp, p)

    tpls = [get_beam_structure(g) for g in geom_types]
    G = len(geom_types)
    grid = np.asarray(list(radius_grid), dtype=np.float64)
    missing = [tuple(round(float(c), 6) for c in combo)
               for combo in product(radius_grid, repeat=G)
               if sum(combo) > 0.003]
    if all(k in out for k in missing):
        return out

    # The point-to-segment distance field is radius-independent, so the
    # whole grid shares one quadrature pass: per point keep the min squared
    # distance to each geometry's beams, bucket it against the grid of r^2
    # thresholds, and a 3-D suffix-sum histogram answers every combo in O(1)
    # (point inside union <=> min_g dmin_g <= r_g^2).  This is exact w.r.t.
    # the per-combo quadrature and turns 10^G device sweeps into one.
    dev = _device(device)
    f32 = torch.float32
    pts = _grid_points(resolution)
    p1s = [torch.as_tensor(t[:, :3], dtype=f32, device=dev) for t in tpls]
    p2s = [torch.as_tensor(t[:, 3:], dtype=f32, device=dev) for t in tpls]

    batch = 1 << 17
    buckets = np.empty((len(pts), G), dtype=np.int64)
    thresholds = (grid.astype(np.float32) ** 2).astype(np.float32)
    for s0 in range(0, len(pts), batch):
        chunk = torch.as_tensor(pts[s0:s0 + batch], device=dev)
        dm = torch.stack([_segment_distance_sq(chunk, p1, p2).min(dim=1).values
                          for p1, p2 in zip(p1s, p2s)], dim=1)   # [B, G]
        # bucket b = number of thresholds strictly below dmin
        buckets[s0:s0 + batch] = np.searchsorted(thresholds, dm.cpu().numpy(),
                                                 side="left")

    m = len(grid) + 1
    flat = np.ravel_multi_index([buckets[:, g] for g in range(G)], (m,) * G)
    H = np.bincount(flat, minlength=m**G).reshape((m,) * G).astype(np.int64)
    # suffix sum: Hs[i0..] = #points with bucket_g >= i_g for all g
    Hs = H.copy()
    for g in range(G):
        Hs = np.flip(np.cumsum(np.flip(Hs, axis=g), axis=g), axis=g)

    total = float(len(pts))
    for combo in product(range(len(grid)), repeat=G):
        key = tuple(round(float(grid[i]), 6) for i in combo)
        if key not in missing or key in out:
            continue
        idx = tuple(i + 1 for i in combo)
        outside = Hs[idx]            # bucket_g > i_g for all g -> outside
        out[key] = (total - float(outside)) / total
    checkpoint()
    return out


def filter_outliers(dataset: Dict[Tuple[float, ...], float],
                    n_neighbors: int = 4, max_rel_variation: float = 2.0
                    ) -> Dict[Tuple[float, ...], float]:
    """Drop samples whose value deviates wildly from their neighbors' median
    (remove_large_volume_variations_dict parity,
    surrogate_model_relative_densities.py:465-520) — guards the GPR fit
    against corrupt entries like the reference's CSV artifacts."""
    keys = np.array([list(k) for k in dataset.keys()], dtype=float)
    vals = np.array(list(dataset.values()), dtype=float)
    if len(keys) <= n_neighbors + 1:
        return dict(dataset)
    d2 = np.sum((keys[:, None, :] - keys[None, :, :])**2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    nn = np.argsort(d2, axis=1)[:, :n_neighbors]
    med = np.median(vals[nn], axis=1)
    keep = np.abs(vals - med) <= max_rel_variation * np.maximum(np.abs(med), 1e-9)
    return {k: v for (k, v), ok in zip(dataset.items(), keep) if ok}


@dataclass
class KrigingDensity:
    """GPR density surrogate: sklearn-fitted, torch-evaluated.

    mean(x) = y_mean + y_std * k(x_s, X_s) @ alpha  with x_s the
    StandardScaler transform; gradient by autograd (replacing the
    hand-derived chain rule of gp_mean_gradient_rbf_pipeline,
    surrogate_model_relative_densities.py:878-987).  The fields are numpy;
    ``mean`` moves them once to each (device, dtype) it is called with.
    """

    X_train_scaled: np.ndarray
    alpha: np.ndarray
    length_scale: np.ndarray
    const: float
    y_mean: float
    y_std: float
    scaler_mean: np.ndarray
    scaler_scale: np.ndarray
    _on: dict = field(default_factory=dict, init=False, repr=False,
                      compare=False)

    @classmethod
    def fit(cls, dataset: Dict[Tuple[float, ...], float],
            random_state: int = 42) -> "KrigingDensity":
        from sklearn.gaussian_process import GaussianProcessRegressor
        from sklearn.gaussian_process.kernels import RBF, ConstantKernel
        from sklearn.pipeline import Pipeline
        from sklearn.preprocessing import StandardScaler

        X = np.array([list(k) for k in dataset.keys()], dtype=float)
        y = np.array(list(dataset.values()), dtype=float)
        pipe = Pipeline([
            ("x_scaler", StandardScaler()),
            ("gpr", GaussianProcessRegressor(
                kernel=ConstantKernel() * RBF(
                    length_scale=np.ones(X.shape[1]),
                    length_scale_bounds=(1e-1, 1e3)),
                # nugget absorbs the voxel-quadrature noise so the fit stays
                # smooth instead of collapsing to a tiny length scale
                alpha=1e-8,
                normalize_y=True, n_restarts_optimizer=10,
                random_state=random_state)),
        ])
        pipe.fit(X, y)
        return cls.from_sklearn(pipe)

    @classmethod
    def from_sklearn(cls, pipe) -> "KrigingDensity":
        scaler = pipe.named_steps["x_scaler"]
        gpr = pipe.named_steps["gpr"]
        k = gpr.kernel_
        const = float(k.k1.constant_value)
        ls = np.atleast_1d(np.asarray(k.k2.length_scale, dtype=float))
        return cls(
            X_train_scaled=np.asarray(gpr.X_train_, dtype=float),
            alpha=np.asarray(gpr.alpha_, dtype=float).reshape(-1),
            length_scale=ls,
            const=const,
            y_mean=float(np.atleast_1d(gpr._y_train_mean)[0]),
            y_std=float(np.atleast_1d(gpr._y_train_std)[0]),
            scaler_mean=np.asarray(scaler.mean_, dtype=float),
            scaler_scale=np.asarray(scaler.scale_, dtype=float),
        )

    # torch evaluation -------------------------------------------------
    def _tensors(self, x: torch.Tensor):
        key = (x.device, x.dtype)
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = tuple(
                torch.as_tensor(np.asarray(getattr(self, f)), dtype=x.dtype,
                                device=x.device)
                for f in ("X_train_scaled", "alpha", "length_scale",
                          "scaler_mean", "scaler_scale"))
        return t

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """GPR posterior mean for inputs [..., d] (one value per input
        row; differentiable)."""
        X, alpha, ls, smean, sscale = self._tensors(x)
        xs = (x - smean) / sscale
        diff = (xs[..., None, :] - X) / ls
        kvec = self.const * torch.exp(-0.5 * torch.sum(diff**2, dim=-1))
        return self.y_mean + (self.y_std * kvec) @ alpha

    def mean_and_grad(self, x, device="cuda"):
        """(mean, d mean / dx) of one input [d], in float64 on ``device``."""
        from ..parallel.structured import _check_device
        xt = torch.as_tensor(np.asarray(x), dtype=torch.float64,
                             device=_check_device(device)).requires_grad_(True)
        with torch.enable_grad():
            m = self.mean(xt)
            (g,) = torch.autograd.grad(m, xt)
        return m.detach(), g

    def save(self, path) -> None:
        np.savez(path, **{f: getattr(self, f) for f in _FIELDS})

    @classmethod
    def load(cls, path) -> "KrigingDensity":
        d = np.load(path)
        return cls(**{k: (float(d[k]) if d[k].ndim == 0 else d[k])
                      for k in d.files})
