"""The one generator of design streams.  A traffic file holds its
parameters; every input is drawn from the run's seed.

A design is a radius per point (a cell center or a strut midpoint): a
smooth field of cosine modes over the lattice, centered, scaled to
``r_mean +- r_amp`` and projected onto the mean r^2 ``mean_r2`` within
``[r_min, r_max]``.  The modes' wave numbers (``waves``, in half periods
over the lattice) and amplitudes (``amps``) are the mix's; a pool of
``pool`` base designs draws the phases, a permutation of the axes and
their signs from ``pool_seed``.  The run's seed draws the order in which
the stream visits the pool and, for each design, whether x and y are
exchanged: the symmetry that keeps the lattice, the clamp on z = 0, the
load on z = n and the rule that a shared strut takes the lower cell's
radius (a reflection would hand it the upper cell's, a different problem
that took 7% more CG iterations at 100^3).  So every seed sends the same
designs up to that symmetry, in another order, and the work does not move
with the seed.

The stream is a sequence of optimisation runs, each of at most
``run_length`` evaluations (a closed loop: the next design waits for the
previous evaluation's compliance and gradient).  Run j starts from base
design j of the stream, cold (no previous solution, a fresh per-design
state); each later evaluation of the run follows the projected-gradient
rule of the program's users' driver (``optimize_projected`` in the
program's ``opti/optimizer.py``), copied here so that the yardstick does
not move with the program:

* the parameters are the radii normalised to ``[0, 1]`` over
  ``[r_min, r_max]`` (the driver's default ``normalized``), and the
  gradient is taken in them;
* the first trial steps ``step0 / ||g||`` along -g; every trial is
  projected onto the budget and the bounds;
* a trial whose compliance is above the last accepted one is rejected:
  the step is multiplied by ``shrink`` and the trial is made again from the
  last accepted design and gradient (the run ends once the step is under
  1e-12);
* an accepted trial becomes the design and the gradient of the run, and
  multiplies the step by ``grow``; the run ends early where the accepted
  compliance moved by no more than ``ftol`` of itself.

``run_length`` 1 makes every evaluation a new design, solved cold
(``explore``).  Within a run, ``warm_start`` starts each solve from the
previous evaluation's solution, and a system with a per-design state (a
multigrid hierarchy's smoother bounds) rebuilds it every ``refresh``
evaluations, counted from the run's first.

The projection runs on the device: ``halvings`` bisection steps on the
shift of every radius, with no read back to the host.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["Stream"]


class Stream:
    def __init__(self, params: Dict, points: torch.Tensor, extent: float,
                 seed: int, dtype: torch.dtype = torch.float32):
        self.p = params
        self.points = points.to(torch.float64)
        self.extent = float(extent)
        self.seed = int(seed)
        self.dtype = dtype
        self.span = float(params["r_max"] - params["r_min"])
        self.run = 0            # the optimisation run under way
        self.i = 0              # evaluations made in it
        self._x: Optional[torch.Tensor] = None   # accepted radii (f64)
        self._g: Optional[torch.Tensor] = None   # their gradient in theta
        self._v: Optional[float] = None          # their compliance
        self._step: Optional[torch.Tensor] = None

    def design(self, k: int) -> torch.Tensor:
        """Base design ``k`` of the stream, on the budget."""
        p = self.p
        order = np.random.default_rng([self.seed, 0]).permutation(p["pool"])
        swap = bool(np.random.default_rng([self.seed, 1, k]).integers(2))
        rng = np.random.default_rng([p["pool_seed"], int(order[k % p["pool"]])])
        waves = np.asarray(p["waves"], dtype=np.float64)
        waves = waves[:, rng.permutation(3)] * rng.choice([-1.0, 1.0], 3)
        amp = np.asarray(p["amps"], dtype=np.float64)
        phase = rng.uniform(0.0, 2.0 * math.pi, len(amp))
        dev = self.points.device
        kx = torch.as_tensor(waves, dtype=torch.float64, device=dev) \
            * (math.pi / self.extent)
        q = self.points[:, [1, 0, 2]] if swap else self.points
        arg = q @ kx.T + torch.as_tensor(phase, device=dev)
        f = (torch.cos(arg) * torch.as_tensor(amp, device=dev)).sum(1)
        f = f - f.mean()
        f = f / f.abs().max()
        return self.project(p["r_mean"] + p["r_amp"] * f)

    def project(self, r: torch.Tensor) -> torch.Tensor:
        """r + lam clipped to the bounds, lam by bisection so that the
        mean r^2 is the budget; returned in the stream's dtype."""
        p = self.p
        r = r.to(torch.float64)
        lo, hi = p["r_min"] - r.max(), p["r_max"] - r.min()
        for _ in range(p["halvings"]):
            mid = 0.5 * (lo + hi)
            m = (torch.clamp(r + mid, p["r_min"], p["r_max"]) ** 2).mean()
            low = m < p["mean_r2"]
            lo = torch.where(low, mid, lo)
            hi = torch.where(low, hi, mid)
        lam = 0.5 * (lo + hi)
        return torch.clamp(r + lam, p["r_min"], p["r_max"]).to(self.dtype)

    def first(self) -> torch.Tensor:
        """The stream's first design (run 0, evaluation 0)."""
        return self.design(0)

    @property
    def starts_run(self) -> bool:
        """Whether the next evaluation is the first of a run (cold)."""
        return self.i == 0

    def refresh_due(self) -> bool:
        """Whether the next evaluation rebuilds the per-design state."""
        return self.i % self.p["refresh"] == 0

    @property
    def warm(self) -> bool:
        return bool(self.p["warm_start"])

    def _trial(self) -> torch.Tensor:
        """The accepted design moved by the step along -g, projected."""
        # theta = (r - r_min) / span, so a step d(theta) is span d(r)
        return self.project(self._x - self.span * self._step * self._g)

    def _new_run(self) -> torch.Tensor:
        self.run += 1
        self.i = 0
        self._x = self._g = self._v = self._step = None
        return self.design(self.run)

    def next(self, r: torch.Tensor, c: float, g: torch.Tensor
             ) -> torch.Tensor:
        """The next design to evaluate, after the evaluation at ``r`` gave
        compliance ``c`` and gradient ``g`` (dc/dr)."""
        p = self.p
        self.i += 1
        if self.i >= p["run_length"]:
            return self._new_run()
        gt = self.span * g.to(torch.float64)
        if self.i == 1:
            self._x, self._g, self._v = r.to(torch.float64), gt, float(c)
            self._step = p["step0"] / (torch.linalg.vector_norm(gt) + 1e-12)
            return self._trial()
        if c > self._v:
            self._step = self._step * p["shrink"]
            if float(self._step) < 1e-12:
                return self._new_run()
            return self._trial()
        done = abs(self._v - float(c)) <= p["ftol"] * max(abs(self._v),
                                                          1e-30)
        self._x, self._g, self._v = r.to(torch.float64), gt, float(c)
        if done:
            return self._new_run()
        self._step = self._step * p["grow"]
        return self._trial()
