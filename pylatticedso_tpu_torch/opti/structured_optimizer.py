"""Optimization on the structured stencil path (PyTorch).

The port of ``pylatticedso_tpu.opti.structured_optimizer``.  For uniform
lattices — single-geometry or hybrid — (the scale regime), the equilibrium
solve inside the design loop runs on the dense stencil operator instead of
the gather/scatter graph: on a CUDA device every K.u of the solve, of the
multigrid levels and of the adjoint is the hand-written stencil kernel (B1,
its float64 instance at the default dtype) and the radius cotangent its
r^2 kernel.  Reuses ``OptimizationProblem``'s parameterizations, density
constraint, drivers, and history machinery; only the solve is swapped.

Warped lattices (``lattice.node_transforms``, the design transforms'
recorded pointwise maps) run on the warped stencil operator: the maps are
composed into the lattice's ``node_transform`` and the nodes are mapped
onto the class grids in unwarped coordinates; on a CUDA device their K.u
is the warped kernel B1w.  A topology-changing transform (a seam merge)
leaves ``node_transforms`` None: the node mapping then fails with
``ValueError`` and FEM_AUTO falls back to the unstructured operator.

``setup_s`` holds the seconds of each construction phase (the base
problem, the class-grid node map, the per-DOF fields, the step), and
``evaluations`` one record per value-and-gradient: its seconds (ended by a
device sync), the objective and the forward and adjoint CG iterations.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..design.lattice import Lattice
from .optimizer import OptimizationProblem
from ..parallel.structured import (StructuredLattice,
                                   make_structured_compliance_step)

__all__ = ["StructuredOptimizationProblem"]


class StructuredOptimizationProblem(OptimizationProblem):
    def __init__(self, lattice: Lattice, dtype=torch.float64,
                 precond: str = "jacobi", mg_opts: Optional[dict] = None,
                 **kwargs):
        t0 = time.perf_counter()
        self._precond, self._mg_opts = precond, mg_opts
        # hybrid (multi-geometry) lattices are superposed templates with a
        # per-geometry radius field; the stencil operator handles them
        # natively (parallel/structured.py:_split_template_collisions)
        if not lattice.are_cells_identical():
            raise ValueError("structured path requires uniform cell size/radii "
                             "(per-cell DESIGN radii may still vary)")
        super().__init__(lattice, dtype=dtype, **kwargs)
        t1 = time.perf_counter()
        nx, ny, nz = lattice.config.num_cells
        cell_valid = np.zeros((nx, ny, nz), dtype=bool)
        for pos in lattice.cell_pos:
            cell_valid[tuple(pos)] = True
        geoms = list(lattice.config.geom_types)
        # warped lattices (design.transforms point maps): rebuild the warp
        # as per-instance stencil fields via the recorded pointwise maps.
        # node_transforms is None when a topology-changing transform ran
        # (cylindrical seam merge): the node mapping below then fails with
        # ValueError and FEM_AUTO falls back to the general-graph operator
        tfs = getattr(lattice, "node_transforms", None)
        composed = None
        if tfs:
            def composed(x, y, z, _tfs=tuple(tfs)):
                for fn in _tfs:
                    x, y, z = fn(x, y, z)
                return x, y, z
        self._slat = StructuredLattice(
            geoms[0] if len(geoms) == 1 else geoms, (nx, ny, nz),
            tuple(lattice.config.cell_size), self.material.young_modulus,
            self.material.poisson_ratio, dtype=self.dtype,
            cell_valid=cell_valid, node_transform=composed,
            device=self.device)
        sl = self._slat
        map_pos = (sl.class_pos if composed is None
                   else sl.class_pos_unwarped)
        map_nodes = (lattice.nodes if composed is None
                     else lattice.nodes_pre_transform)

        # map lattice nodes onto the class grids
        coord_to_cg = {}
        for c in range(sl.nc):
            x, y, z = map_pos[c]
            for idx in np.argwhere(sl.node_valid[c]):
                key = (round(x[tuple(idx)], 9), round(y[tuple(idx)], 9),
                       round(z[tuple(idx)], 9))
                coord_to_cg[key] = (c, tuple(idx))
        self._node_map = []
        for i, p in enumerate(map_nodes):
            key = tuple(np.round(p, 9))
            if key not in coord_to_cg:
                raise ValueError(f"node {p} not on the class grids")
            self._node_map.append(coord_to_cg[key])
        t2 = time.perf_counter()

        def to_field(per_node):  # [N, 6] -> [nc, 6, X, Y, Z]
            out = np.zeros((sl.nc, 6) + sl.grid, dtype=np.float64)
            for i, (c, g) in enumerate(self._node_map):
                out[(c, slice(None)) + g] = per_node[i]
            return out

        # per-DOF masks: [nc, 6, X, Y, Z]
        fixed_f = to_field(self.bc.fixed.astype(float)) > 0.5
        f_field = to_field(self.bc.f_applied)
        u_imp_field = to_field(self.bc.u_imposed)
        free_f = np.broadcast_to(sl.node_valid[:, None], fixed_f.shape) & ~fixed_f

        # objective functional over the field representation
        tens = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                         device=self.device)
        if self.objective_type == "compliance":
            obj = None
        else:
            sels = [to_field(s.cpu().numpy()) for s in self._obj_sel]
            if self.objective_type == "displacement":
                # min/max applies only to displacement, matching the
                # reference (lattice_opti.py:608-613) and _objective_u.
                # Bind the sign eagerly (default arg) — a late-bound
                # closure here once silently picked up a rebound name.
                disp_sign = -1.0 if self.objective_function == "max" else 1.0
                sel = tens(sels[0])
                obj = lambda u, f_, s=disp_sign: s * torch.sum(sel * u)
            else:  # displacement_ratio: objective_function is ignored
                so, si = tens(sels[0]), tens(sels[1])
                obj = lambda u, f_: -(torch.sum(so * u) * torch.sum(si * u))
        self._free_field = free_f
        t3 = time.perf_counter()
        self._step = make_structured_compliance_step(
            sl, free_f, f_field, u_imposed=u_imp_field, objective=obj,
            tol=self.cg_tol, maxiter=self.cg_maxiter,
            precond=self._precond, mg_opts=self._mg_opts)
        raw = self._step.raw
        free_t, f_t = self._step._operands
        pos = torch.as_tensor(np.asarray(lattice.cell_pos), dtype=torch.long,
                              device=self.device)
        cell_idx = (pos[:, 0], pos[:, 1], pos[:, 2])
        num_cells = sl.num_cells
        param = self.param
        n_geom = sl.n_geom

        def radius_field(theta):
            """[Nx, Ny, Nz] (or [n_geom, Nx, Ny, Nz]) radii scattered from
            the per-cell radii; differentiable in theta."""
            cr = param.cell_radii(theta)                # [C, n_geom]
            if n_geom == 1:
                return cr.new_zeros(num_cells).index_put(cell_idx, cr[:, 0])
            rf = cr.new_zeros(num_cells + (n_geom,)).index_put(cell_idx, cr)
            return rf.permute(3, 0, 1, 2)

        def objective_theta(theta):
            val, _u = raw(radius_field(theta), free_t, f_t,
                          torch.zeros_like(f_t))
            return val

        self._objective_theta_structured = objective_theta
        # warm-start successive evaluations with the previous solution:
        # convergence-only (the implicit-diff fixed point is exact
        # regardless of x0), typically 5-10x fewer CG iterations along a
        # design path
        self._u_warm = None
        self.evaluations = []
        solves = self._step.solves

        def value_and_grad_warm(theta):
            t = time.perf_counter()
            u_start = self._u_warm if self._u_warm is not None \
                else torch.zeros_like(f_t)
            th = self._theta(theta).detach().requires_grad_(True)
            with torch.enable_grad():
                val, u = raw(radius_field(th), free_t, f_t, u_start)
                (g,) = torch.autograd.grad(val, th)
            self._u_warm = u.detach()
            recs = solves()
            if g.is_cuda:
                torch.cuda.synchronize(g.device)
            self.evaluations.append({
                "seconds": time.perf_counter() - t,
                "objective": float(val.detach()),
                "forward": recs[0]["iterations"],
                "adjoint": recs[1]["iterations"] if len(recs) > 1
                else None})
            return val.detach(), g

        self._value_and_grad = value_and_grad_warm
        self.setup_s = {"problem": t1 - t0, "node_map": t2 - t1,
                        "fields": t3 - t2,
                        "step": time.perf_counter() - t3}
