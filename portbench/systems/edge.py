"""The port's edge-sharded compliance step (``parallel/sharding.py``
``make_compliance_step``, driven through ``step.chunked``) on a
one-device mesh: the lattice from ``build_lattice`` in the reference
project's JSON schema, one radius per strut, the per-edge operator in plain
torch with per-node sums in a fixed order, block-Jacobi CG in chunks, the
self-adjoint compliance gradient.  No hand-written kernel runs.

The configuration's ``lattice`` gives the cells per side, the clamp
(Zmin, all six DOFs) and the total load on Zmax in -z, which the program's
boundary conditions split over the Zmax nodes; ``solver`` the tolerance,
iteration cap and chunk.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.fem.bc import apply_boundary_conditions
from pylatticedso_tpu_torch.parallel.sharding import (
    ShardedLattice, make_compliance_step, make_mesh)

__all__ = ["System", "KERNEL_SOURCES"]

KERNEL_SOURCES = ()
CLAMP = {"Surface": ["Zmin"], "DOF": ["X", "Y", "Z", "RX", "RY", "RZ"],
         "Value": [0, 0, 0, 0, 0, 0]}


def lattice_config(lat: Dict) -> Dict:
    """The configuration in the reference project's schema (radii are set
    per strut by the traffic)."""
    n = lat["cells"]
    return {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                         "number_of_cells": {"x": n, "y": n, "z": n},
                         "radii": [0.05], "geom_types": [lat["geometry"]]},
            "boundary_conditions": {
                "Displacement": {"Fixed": CLAMP},
                "Force": {"Load": {"Surface": ["Zmax"], "DOF": ["Z"],
                                   "Value": [-float(lat["load"])]}}}}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class System:
    has_state = False

    def __init__(self, cfg: Dict, device: torch.device):
        lat, mat, sol = cfg["lattice"], cfg["material"], cfg["solver"]
        self.device = device
        self.chunk = sol["chunk"]
        t = time.perf_counter()
        L = build_lattice(lattice_config(lat))
        bc = apply_boundary_conditions(L)
        t_lat = time.perf_counter() - t
        t = time.perf_counter()
        self.shl = ShardedLattice(make_mesh(devices=[device]), L.nodes,
                                  L.edges, mat["E"], mat["nu"],
                                  dtype=torch.float32)
        self.step = make_compliance_step(self.shl, ~bc.fixed, bc.f_applied,
                                         tol=sol["tol"],
                                         maxiter=sol["maxiter"])
        _sync(device)
        self.setup_parts = {"build_lattice_s": t_lat,
                            "step_s": time.perf_counter() - t}
        self.nodes = np.asarray(L.nodes)
        self.edges = np.asarray(L.edges)
        self.n_real = self.shl.n_real
        self.n_pad = int(self.shl.edges.shape[1])

    def points(self) -> torch.Tensor:
        """Strut midpoints [E, 3] in the program's order (on the lattice's
        quarter grid, so exact)."""
        mid = 0.5 * (self.nodes[self.edges[:, 0]] + self.nodes[self.edges[:, 1]])
        return torch.as_tensor(np.rint(mid * 4.0) / 4.0, dtype=torch.float64,
                               device=self.device)

    def prepare(self, r: torch.Tensor):
        return None

    def solve(self, r: torch.Tensor, u0: Optional[torch.Tensor], state):
        rp = torch.zeros(self.n_pad, dtype=r.dtype, device=r.device)
        rp[: self.n_real] = r
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            c, g, u, _ = self.step.chunked(rp, u0, chunk=self.chunk,
                                           on_fail="warn")
        ch = self.step.chunked
        return c, g[: self.n_real], u, int(ch.last_iterations), \
            bool(ch.last_converged)

    def preconditioner(self, r: torch.Tensor, state):
        """The step's block Jacobi at radii ``r``, on [6, N] fields (used
        by the control, ``portbench/control.py``)."""
        rp = torch.zeros(self.n_pad, dtype=r.dtype, device=r.device)
        rp[: self.n_real] = r
        return self.step.preconditioner(rp)

    def reset_counters(self) -> None:
        pass

    def launches(self):
        return None

    def view(self) -> "View":
        return View(self.nodes, self.edges)


class View:
    """The program's node and strut order mapped onto the reference's, by
    position; the map must be one to one, so the check also holds the
    program's lattice to the reference's."""

    def __init__(self, nodes: np.ndarray, edges: np.ndarray):
        self.nodes, self.edges = nodes, edges
        self._maps = None

    def _perm(self, ref):
        if self._maps is None:
            dev = ref.device
            d2 = torch.as_tensor(np.rint(self.nodes * 2.0).astype(np.int64),
                                 device=dev)
            node = ref.node_index(d2)
            e = torch.as_tensor(self.edges.astype(np.int64), device=dev)
            beam = ref.beam_index(node[e[:, 0]], node[e[:, 1]])
            for got, want, what in ((node, ref.n_nodes, "nodes"),
                                    (beam, ref.n_beams, "struts")):
                if got.numel() != want or bool((got < 0).any()) or \
                        torch.unique(got).numel() != want:
                    raise ValueError(f"the program's {what} are not the "
                                     f"reference's, once each")
            self._maps = (node, beam)
        return self._maps

    def u_to_ref(self, ref, u: torch.Tensor) -> torch.Tensor:
        """A [6, N] field in the program's node order as [N, 6] float64
        in the reference's."""
        node, _ = self._perm(ref)
        out = torch.zeros((ref.n_nodes, 6), dtype=torch.float64,
                          device=ref.device)
        out[node] = u.T.to(torch.float64)
        return out

    def u_from_ref(self, ref, v: torch.Tensor, dtype) -> torch.Tensor:
        node, _ = self._perm(ref)
        return v[node].T.to(dtype).contiguous()

    def to_reference(self, ref, sample):
        _, beam = self._perm(ref)
        u = self.u_to_ref(ref, sample["u"])
        r_beam = torch.zeros(ref.n_beams, dtype=torch.float64,
                             device=ref.device)
        r_beam[beam] = sample["r"].to(torch.float64)
        in_program_order = lambda gb: gb[beam]
        return u, r_beam, sample["g"], in_program_order
