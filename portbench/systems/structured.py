"""The port's structured compliance step
(``parallel/structured.py`` ``make_structured_compliance_step``) on a
``StructuredLattice``: one radius per cell, the class-grid stencil K.u
(kernel B1 on the card) and the multigrid-preconditioned CG of
``fem/solve.py``, the analytic compliance gradient.

The configuration's ``lattice`` gives the cells per side, its ``material``
E, nu and the shear factor, its ``solver`` the CG tolerance, iteration cap
and the multigrid's options.  The benchmark makes the step's inputs itself:
the clamp on z = 0 and the total load on z = n, split evenly over the top
nodes, on the program's class grid.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pylatticedso_tpu_torch.kernels.build import SOURCES
from pylatticedso_tpu_torch.parallel.structured import (
    StructuredLattice, make_structured_compliance_step)

__all__ = ["System", "KERNEL_SOURCES"]

KERNEL_SOURCES = SOURCES


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class System:
    has_state = True

    def __init__(self, cfg: Dict, device: torch.device):
        lat, mat, sol = cfg["lattice"], cfg["material"], cfg["solver"]
        n = self.n = lat["cells"]
        self.device = device
        t = time.perf_counter()
        sl = StructuredLattice(lat["geometry"], (n, n, n), (1.0, 1.0, 1.0),
                               mat["E"], mat["nu"], kappa=mat["kappa"],
                               dtype=torch.float32, device=device)
        t_lat = time.perf_counter() - t
        # the output's layout: class c holds the nodes at grid point
        # (i, j, k) + key_c; doubled keys are integers
        self.offsets = np.rint(np.asarray(sl.class_keys) * 2).astype(np.int64)
        X = n + 1
        g = np.stack(np.meshgrid(*(np.arange(X),) * 3, indexing="ij"))
        pos2 = 2 * g[None] + self.offsets[:, :, None, None, None]
        valid = (pos2 <= 2 * n).all(1)                     # [nc, X, X, X]
        free = valid & (pos2[:, 2] != 0)
        top = valid & (pos2[:, 2] == 2 * n)
        f = np.zeros((len(self.offsets), 6, X, X, X), np.float32)
        f[:, 2][top] = -float(lat["load"]) / int(top.sum())
        mg = self.mg = dict(sol["mg"])
        mg["nu"] = tuple(mg["nu"])
        t = time.perf_counter()
        self.step = make_structured_compliance_step(
            sl, free, f, tol=sol["tol"], maxiter=sol["maxiter"],
            precond=sol["precond"], mg_opts=mg)
        _sync(device)
        self.setup_parts = {"lattice_s": t_lat,
                            "step_s": time.perf_counter() - t}
        levels = self.step.hierarchy["levels"]
        # B1's wrappers of each multigrid level (the outer CG's operator
        # is the fine level's too)
        self._wrappers = [[self.step.matvec.apply, levels[0].matvec.apply]] \
            + [[lvl.matvec.apply] for lvl in levels[1:]]
        self.grids = [tuple(int(x) for x in lvl.slat.grid) for lvl in levels]

    def points(self) -> torch.Tensor:
        """Cell centers [n^3, 3] in C order: where the design is read."""
        c = torch.arange(self.n, dtype=torch.float64, device=self.device)
        cx, cy, cz = torch.meshgrid(c, c, c, indexing="ij")
        return torch.stack([cx, cy, cz], dim=-1).reshape(-1, 3) + 0.5

    def prepare(self, r: torch.Tensor):
        return self.step.precond_state(r.reshape(self.n, self.n, self.n))

    def solve(self, r: torch.Tensor, u0: Optional[torch.Tensor], state):
        c, g, u = self.step(r.reshape(self.n, self.n, self.n), u0, state)
        rec = self.step.last_solve
        return c, g.reshape(-1), u, int(rec["iterations"]), \
            bool(rec["converged"])

    def preconditioner(self, r: torch.Tensor, state):
        """The step's V-cycle at a frozen state, on class-grid fields
        (used by the control, ``portbench/control.py``)."""
        from pylatticedso_tpu_torch.parallel.multigrid import mg_apply
        opts = {k: v for k, v in self.mg.items() if k != "power_iters"}
        return mg_apply(self.step.hierarchy, state, **opts)

    def reset_counters(self) -> None:
        for ws in self._wrappers:
            for w in ws:
                w.launches = 0

    def launches(self) -> Dict[str, List]:
        """B1's float32 launches per multigrid level since the reset, with
        each level's grid."""
        return {"B1": [sum(w.launches for w in ws) for ws in self._wrappers],
                "grids": self.grids}

    def view(self) -> "View":
        return View(self.n, self.offsets)


class View:
    """What the check needs of the system once its state is freed: how to
    read the program's outputs in the reference's numbering."""

    def __init__(self, n: int, offsets: np.ndarray):
        self.n, self.offsets = n, offsets
        self._map = None

    def _slots(self, ref):
        if self._map is None:
            dev = ref.device
            X = self.n + 1
            g = torch.stack(torch.meshgrid(
                *(torch.arange(X, device=dev),) * 3, indexing="ij"), -1)
            off = torch.as_tensor(self.offsets, device=dev)
            idx = torch.stack([ref.node_index(2 * g + off[c])
                               for c in range(len(off))])   # [nc, X, X, X]
            hit = idx[idx >= 0]
            if hit.numel() != ref.n_nodes or \
                    torch.unique(hit).numel() != ref.n_nodes:
                raise ValueError("the program's class grid does not hold "
                                 "the reference's nodes once each")
            self._map = idx
        return self._map

    def u_to_ref(self, ref, u: torch.Tensor) -> torch.Tensor:
        """A class-grid field [nc, 6, X, Y, Z] as [N, 6] float64."""
        idx = self._slots(ref)
        out = torch.zeros((ref.n_nodes, 6), dtype=torch.float64,
                          device=ref.device)
        for c in range(idx.shape[0]):
            ok = idx[c] >= 0
            out[idx[c][ok]] = u[c][:, ok].T.to(torch.float64)
        return out

    def u_from_ref(self, ref, v: torch.Tensor, dtype) -> torch.Tensor:
        """The inverse of ``u_to_ref`` (zero on the grid's empty slots)."""
        idx = self._slots(ref)
        X = self.n + 1
        out = torch.zeros((idx.shape[0], 6, X, X, X), dtype=dtype,
                          device=v.device)
        for c in range(idx.shape[0]):
            ok = idx[c] >= 0
            out[c][:, ok] = v[idx[c][ok]].T.to(dtype)
        return out

    def to_reference(self, ref, sample):
        out = self.u_to_ref(ref, sample["u"])
        r_beam = ref.beam_radius(sample["r"].to(torch.float64).reshape(
            self.n, self.n, self.n))
        per_cell = lambda gb: ref.per_cell(gb).reshape(-1)
        return out, r_beam, sample["g"], per_cell
