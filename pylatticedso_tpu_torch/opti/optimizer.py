"""Design optimization: one differentiable objective, two drivers (PyTorch).

The port of ``pylatticedso_tpu.opti.optimizer``.  The reference's SLSQP loop
with hand-built gradients (lattice_opti.py:141-226, 701-901: per-cell
u^T (dS/dr) u compliance terms, adjoint CG for displacement objectives, FD
fallbacks, an empirical sign flip at :719) collapses into autograd through
the implicit equilibrium solve (``fem.solve.linear_solve``: its backward runs
the adjoint CG; compliance is self-adjoint so lambda = u).

The problem's tensors live on ``device`` (default ``"cuda"``) in ``dtype``
(default float64).  scipy hands the drivers float64 numpy arrays: each
evaluation moves them onto the device once and returns numpy.

Drivers:
* ``optimize_slsqp``      — scipy SLSQP with the value/grad and the
  density NonlinearConstraint (reference parity).
* ``optimize_projected``  — projected gradient with box bounds and a
  density bisection projection; the iterates stay on the device, the
  bisection's 40 comparisons are host syncs.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import DOF_NAMES
from ..design.lattice import Lattice
from ..materials import MatProperties
from ..fem.bc import apply_boundary_conditions
from ..fem.elements import edge_dof_diag, section_stiffness
from ..fem.operator import SegmentSum, build_operator
from ..fem.solve import linear_solve
from .density import KrigingDensity, density_dataset
from .parameterization import make_parameterization

__all__ = ["OptimizationProblem", "OptimizationResult"]


def _np(x) -> np.ndarray:
    """A tensor (any device) or array-like as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=float)


@dataclass
class OptimizationResult:
    theta: np.ndarray
    radii: np.ndarray            # [C, G] final physical radii
    objective: float
    density: float
    iterations: int
    success: bool
    history: List[dict] = field(default_factory=list)
    message: str = ""


class OptimizationProblem:
    """Differentiable lattice design problem.

    objective_type: "compliance" | "displacement" | "displacement_ratio"
    objective_function: "min" | "max"
    """

    def __init__(self, lattice: Lattice, material: Optional[MatProperties] = None,
                 objective_type: str = "compliance", objective_function: str = "min",
                 objective_data: Optional[dict] = None,
                 opt_params: Optional[dict] = None,
                 constraints: Optional[dict] = None,
                 min_radius: float = 0.01, max_radius: float = 0.1,
                 normalized: bool = True, density_model: Optional[KrigingDensity] = None,
                 cg_tol: float = 1e-10, cg_maxiter: int = 5000,
                 dtype=torch.float64, device="cuda"):
        cfg_opt = lattice.config.optimization or {}
        opt_params = opt_params or cfg_opt.get("optimization_parameters",
                                               {"type": "constant"})
        constraints = constraints if constraints is not None \
            else cfg_opt.get("constraints", {})
        self.objective_type = cfg_opt.get("objective_type", objective_type) \
            if objective_type == "compliance" else objective_type
        self.objective_function = cfg_opt.get("objective_function", objective_function) \
            if objective_function == "min" else objective_function

        self.lattice = lattice
        self.material = material or MatProperties(lattice.config.material_name())
        self.bc = apply_boundary_conditions(lattice)
        self.param = make_parameterization(lattice, opt_params, min_radius,
                                           max_radius, normalized)
        self.constraints = constraints
        self.cg_tol, self.cg_maxiter = cg_tol, cg_maxiter
        self.history: List[dict] = []

        op = build_operator(lattice.nodes, lattice.edges, lattice.radius,
                            self.material.young_modulus,
                            self.material.poisson_ratio, dtype=dtype,
                            device=device)
        self._op = op
        self.dtype, self.device = op.geom.L.dtype, op.geom.L.device
        tens = lambda a: torch.as_tensor(np.asarray(a, dtype=float),
                                         dtype=self.dtype, device=self.device)
        self._free = tens(~self.bc.fixed)
        self._f = tens(self.bc.f_applied)
        self._u_imp = tens(self.bc.u_imposed)
        # per-edge radius = cell_radii[edge_cell, edge_type]
        # (``Parameterization.edge_radius``) gathered with an ordered
        # per-(cell, geometry) sum as its gradient: an indexing gather's
        # gradient adds with atomics on the card
        G = lattice.config.n_geom
        flat = (np.asarray(lattice.edge_cell, dtype=np.int64) * G
                + np.asarray(lattice.edge_type, dtype=np.int64))
        self._edge_gather = SegmentSum(
            torch.as_tensor(flat, device=self.device), lattice.num_cells * G)

        obj_data = objective_data or cfg_opt.get("objective_data")
        self._obj_sel = self._objective_selectors(obj_data)

        # density surrogate (fit on the fly over the voxel dataset if needed);
        # the voxel sweep is expensive on a slow host, so it is cached on disk
        # keyed by geometry set + grid (resumable, like the reference's
        # compute_relative_densities_dataset(resume=True))
        self._density_model = density_model
        if "relative_density" in self.constraints and self._density_model is None:
            grid = np.round(np.arange(min_radius, max_radius + 1e-9, 0.01), 3)
            from pathlib import Path
            cache = Path("data/outputs/density_datasets") / (
                "_".join(lattice.config.geom_types)
                + f"_{grid[0]:g}_{grid[-1]:g}_{len(grid)}.pkl")
            # the GPR hyperparameter fit takes minutes on a slow host; cache
            # the fitted closed-form parameters next to the dataset
            fit_cache = cache.with_suffix(".gpr.npz")
            if fit_cache.exists() and cache.exists() \
                    and fit_cache.stat().st_mtime >= cache.stat().st_mtime:
                self._density_model = KrigingDensity.load(fit_cache)
            else:
                ds = density_dataset(lattice.config.geom_types, grid,
                                     resume_path=cache, device=self.device)
                self._density_model = KrigingDensity.fit(ds)
                try:
                    self._density_model.save(fit_cache)
                except OSError:
                    pass

        self._value_and_grad = self._value_and_grad_of(self._objective_theta)
        self._density_vg = (self._value_and_grad_of(self._density_theta)
                            if self._density_model is not None else None)

    # ------------------------------------------------------------------
    def _theta(self, theta) -> torch.Tensor:
        """theta (numpy or a tensor) on the problem's device and dtype."""
        if not isinstance(theta, torch.Tensor):
            theta = np.asarray(theta, dtype=float)
        return torch.as_tensor(theta, dtype=self.dtype, device=self.device)

    def _value_and_grad_of(self, fn: Callable) -> Callable:
        """theta -> (fn(theta) as a 0-d tensor, d fn / d theta), both on
        the device."""
        def vg(theta):
            th = self._theta(theta).detach().requires_grad_(True)
            with torch.enable_grad():
                v = fn(th)
                (g,) = torch.autograd.grad(v, th)
            return v.detach(), g
        return vg

    def _objective_selectors(self, obj_data):
        """Node/DOF masks for displacement-type objectives
        (calculate_objective, lattice_opti.py:580-641)."""
        if self.objective_type == "compliance":
            return None
        if obj_data is None:
            raise ValueError(f"objective_data required for {self.objective_type}")
        nodes_out = self.lattice.find_nodes_on_surface(obj_data["Surface"])
        dofs_out = [DOF_NAMES[d] for d in obj_data["DOF"]]
        sel_out = np.zeros((self.lattice.num_nodes, 6))
        for d in dofs_out:
            sel_out[nodes_out, d] = 1.0
        sel_out /= sel_out.sum()
        tens = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                         device=self.device)
        if self.objective_type == "displacement":
            return (tens(sel_out),)
        # displacement_ratio: input = "Load" BC surface (lattice_opti.py:619-627)
        bcs = self.lattice.config.boundary_conditions or {}
        load = (bcs.get("Force") or bcs.get("Displacement") or {}).get("Load")
        if load is None:
            raise ValueError("displacement_ratio needs a BC entry named 'Load'")
        nodes_in = self.lattice.find_nodes_on_surface(load["Surface"])
        sel_in = np.zeros((self.lattice.num_nodes, 6))
        for d in [DOF_NAMES[x] for x in load["DOF"]]:
            sel_in[nodes_in, d] = 1.0
        sel_in /= sel_in.sum()
        return (tens(sel_out), tens(sel_in))

    # ------------------------------------------------------------------
    def _solve_u(self, radius_e: torch.Tensor) -> torch.Tensor:
        op, free = self._op, self._free
        D = section_stiffness(radius_e, self.material.young_modulus,
                              self.material.poisson_ratio).D
        op2 = op._replace(D=D)

        def A(u):
            return free * op2.matvec(free * u) + (1.0 - free) * u

        # the preconditioner never moves the fixed point: detached
        with torch.no_grad():
            d12 = edge_dof_diag(op2.geom, D)
            diag = op.ends(torch.cat([d12[:, :6], d12[:, 6:]], dim=0))
            diag = free * diag + (1.0 - free)
            diag = torch.where(diag == 0, torch.ones_like(diag), diag)
        b = free * (self._f - op2.matvec(self._u_imp)) + (1.0 - free) * self._u_imp
        u = linear_solve(A, b, M=lambda r: r / diag,
                         maxiter=self.cg_maxiter, tol=self.cg_tol)
        return free * u + (1.0 - free) * self._u_imp

    def _objective_u(self, u: torch.Tensor) -> torch.Tensor:
        if self.objective_type == "compliance":
            obj = torch.sum(self._f * u)
        elif self.objective_type == "displacement":
            (sel_out,) = self._obj_sel
            mean_disp = torch.sum(sel_out * u)
            # reference applies min/max only to the displacement objective
            # (lattice_opti.py:608-613); compliance and displacement_ratio
            # ignore objective_function there.
            obj = -mean_disp if self.objective_function == "max" else mean_disp
        elif self.objective_type == "displacement_ratio":
            sel_out, sel_in = self._obj_sel
            obj = -(torch.sum(sel_out * u) * torch.sum(sel_in * u))
        else:
            raise ValueError(self.objective_type)
        return obj

    def _objective_theta(self, theta: torch.Tensor) -> torch.Tensor:
        cr = self.param.cell_radii(theta)
        r_e = self._edge_gather.gather(cr.reshape(-1))
        return self._objective_u(self._solve_u(r_e))

    def _density_theta(self, theta: torch.Tensor) -> torch.Tensor:
        """Mean Kriging density over cells (get_relative_density,
        lattice_opti.py:1070-1115)."""
        cr = self.param.cell_radii(theta)
        return torch.mean(self._density_model.mean(cr))

    # ------------------------------------------------------------------
    def objective(self, theta) -> float:
        return float(self._value_and_grad(theta)[0])

    def gradient(self, theta) -> np.ndarray:
        return _np(self._value_and_grad(theta)[1])

    def density(self, theta) -> float:
        return float(self._density_vg(theta)[0])

    #: optional per-iteration hook, e.g. ``OptimizationPlotter().on_iteration``
    #: (live convergence plotting, plotting_lattice_optim.py:116-167)
    iteration_callback: Optional[Callable] = None

    def _record(self, theta, obj):
        rho = self.density(theta) if self._density_vg is not None else None
        rec = {
            "iteration": len(self.history),
            "objective": float(obj),
            "relative_density": rho,
            "parameters": _np(theta).tolist(),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        self.history.append(rec)
        if self.iteration_callback is not None:
            self.iteration_callback(rec)

    # ------------------------------------------------------------------
    def feasible_x0(self, x0=None) -> np.ndarray:
        """Project the start point onto the density-feasible set by a
        uniform parameter shift (bisection).

        The reference's records start SLSQP at the (density-infeasible)
        config radii; its era's Fortran SLSQP line search rejected the
        resulting full Newton step, but scipy >= 1.16's C SLSQP accepts it
        and slams every parameter to a bound (verified: the first QP step
        from an infeasible x0 needs a constraint multiplier ~|violation| /
        |drho|^2 ~ 600, which saturates all boxes).  Starting on the
        constraint surface sidesteps the pathology with no change to the
        problem or its optima.
        """
        x0 = np.asarray(self.param.x0 if x0 is None else x0, dtype=float)
        if self._density_vg is None:
            return x0
        spec = self.constraints["relative_density"]
        target, mode = spec["value"], spec.get("mode", "upper")
        rho = lambda s: float(self._density_vg(
            np.clip(x0 + s, self.param.lower, self.param.upper))[0]) - target
        r0 = rho(0.0)
        if (mode == "upper" and r0 <= 0) or (mode == "lower" and r0 >= 0):
            return x0
        from scipy.optimize import brentq
        lo, hi = (-2.0, 0.0) if r0 > 0 else (0.0, 2.0)
        # clipping to the parameter box can make rho(s) plateau before it
        # crosses the target; brentq then has no bracket.  Fall back to the
        # nearest-bound projection (the best feasibility achievable by a
        # uniform shift) instead of raising.
        r_far = rho(lo if r0 > 0 else hi)
        if np.sign(r_far) == np.sign(r0):
            import warnings
            warnings.warn(
                "feasible_x0: the density target is unreachable by a "
                "uniform parameter shift within bounds; starting from the "
                f"nearest-bound projection (residual {r_far:.3e}).",
                RuntimeWarning, stacklevel=2)
            s = lo if r0 > 0 else hi
        else:
            s = brentq(rho, lo, hi, xtol=1e-9)
        return np.clip(x0 + s, self.param.lower, self.param.upper)

    def project_density(self, x) -> np.ndarray:
        """Uniform-shift feasibility restoration: shift all parameters by
        the scalar s that puts the density back on the constraint surface
        (density is monotone in a uniform radius shift).  SLSQP's final
        iterate routinely sits 1e-5..1e-4 OVER an active upper density
        bound (its internal constraint tolerance); restoring feasibility
        costs a roundoff-level objective change and makes results
        comparable like-for-like at the advertised budget."""
        x = np.asarray(x, dtype=float)
        if self._density_vg is None:
            return x
        spec = self.constraints["relative_density"]
        target, mode = spec["value"], spec.get("mode", "upper")
        band = max(spec.get("tolerance", 0.0), 1e-6)
        rho = lambda s: float(self._density_vg(
            np.clip(x + s, self.param.lower, self.param.upper))[0]) - target
        r0 = rho(0.0)
        if ((mode == "upper" and r0 <= 1e-6) or (mode == "lower" and r0 >= -1e-6)
                or (mode in ("eq", "band") and abs(r0) <= band)):
            return x
        from scipy.optimize import brentq
        lo, hi = (-2.0, 0.0) if r0 > 0 else (0.0, 2.0)
        r_far = rho(lo if r0 > 0 else hi)
        if np.sign(r_far) == np.sign(r0):
            return np.clip(x + (lo if r0 > 0 else hi),
                           self.param.lower, self.param.upper)
        s = brentq(rho, lo, hi, xtol=1e-12)
        # land on the FEASIBLE side of the surface for inequality modes
        nudge = {"upper": -1e-9, "lower": 1e-9}.get(mode, 0.0)
        for _ in range(40):
            if ((mode == "upper" and rho(s) <= 0)
                    or (mode == "lower" and rho(s) >= 0)
                    or mode in ("eq", "band")):
                break
            s += nudge
            nudge *= 2.0
        return np.clip(x + s, self.param.lower, self.param.upper)

    def optimize_slsqp(self, max_iterations: int = 20, ftol: float = 1e-9,
                       normalize_objective: bool = True,
                       feasible_start: bool = False,
                       move_limit: Optional[float] = None) -> OptimizationResult:
        """SLSQP driver.  ``normalize_objective`` divides by the first
        objective value (normalize_objective, lattice_opti.py:1333-1342) so
        ftol acts on relative improvements.  ``feasible_start`` projects x0
        onto the density constraint first (see ``feasible_x0``).

        ``move_limit``: per-outer-iteration box |x_k+1 - x_k| <= delta (the
        classic topology-optimization safeguard).  scipy >= 1.16's C SLSQP
        accepts the unbounded first QP step of badly scaled problems and
        saturates every parameter bound, wandering through surrogate-invalid
        corners; a move limit keeps each step trusted while converging to
        the same KKT point.  Implemented as repeated 1-iteration SLSQP calls
        with shrinking boxes around the current iterate."""
        from scipy.optimize import Bounds, NonlinearConstraint, minimize

        vg = self._value_and_grad
        scale = {"c0": None}
        # raw objective per evaluated point, so the iteration callback can
        # record f(x_k) rather than the last line-search trial's value
        evals: Dict[bytes, float] = {}
        # best FEASIBLE evaluated point across the whole run (line-search
        # trials included): SLSQP reports its final ITERATE, which a late
        # NaN/garbage excursion can leave far above the best design it
        # already visited (observed with the JAX package: a free polish
        # descending 1.27e-3 -> 1.21e-3, then stepping into a
        # surrogate-invalid corner that evaluates NaN and finishing worse
        # than it started)
        best = {"v": np.inf, "x": None}

        def _feasible(x) -> bool:
            if self._density_vg is None:
                return True
            spec = self.constraints["relative_density"]
            d = float(self._density_vg(x)[0]) - spec["value"]
            tol_f = max(spec.get("tolerance", 0.0), 1e-6)
            mode = spec.get("mode", "upper")
            return {"upper": d <= tol_f, "lower": d >= -tol_f,
                    "eq": abs(d) <= tol_f, "band": abs(d) <= tol_f}[mode]

        def fun(x):
            v, g = vg(x)
            v, g = float(v), _np(g)
            if not np.isfinite(v) or not np.isfinite(g).all():
                # a NaN/Inf trial (ill-conditioned extreme design) must be
                # REJECTED by the line search, not ingested into SLSQP's
                # internal state: report a large finite value, flat slope
                evals[np.asarray(x, dtype=float).tobytes()] = float("inf")
                # the rejection value must dominate on the SAME scale the
                # other returns use: normalized returns are O(1) (v/c0), so
                # 1e6 flat; un-normalized returns are raw, so anchor on the
                # largest magnitude seen so far (c0 is never set then)
                if normalize_objective and scale["c0"] is not None:
                    big = 1e6
                else:
                    ref = scale["c0"] or abs(scale.get("last_raw", 0.0)) or 1.0
                    big = 1e6 * max(ref, 1e-30)
                return big, np.zeros_like(np.asarray(x, dtype=float))
            scale["last_raw"] = v
            evals[np.asarray(x, dtype=float).tobytes()] = v
            if v < best["v"] and _feasible(x):
                best["v"] = v
                best["x"] = np.asarray(x, dtype=float).copy()
            if normalize_objective:
                if scale["c0"] is None:
                    scale["c0"] = abs(v) if v != 0 else 1.0
                v, g = v / scale["c0"], g / scale["c0"]
            return v, g

        def raw_at(x):
            key = np.asarray(x, dtype=float).tobytes()
            if key not in evals:
                evals[key] = float(vg(x)[0])
            return evals[key]

        cons = []
        if self._density_vg is not None:
            spec = self.constraints["relative_density"]
            target = spec["value"]
            mode = spec.get("mode", "upper")
            tol_band = spec.get("tolerance", 0.0)
            lb, ub = {"upper": (-np.inf, 0.0), "lower": (0.0, np.inf),
                      "eq": (0.0, 0.0), "band": (-tol_band, tol_band)}[mode]

            def cfun(x):
                return float(self._density_vg(x)[0]) - target

            def cjac(x):
                return _np(self._density_vg(x)[1])

            cons.append(NonlinearConstraint(cfun, lb, ub, jac=cjac))

        x0 = self.feasible_x0() if feasible_start \
            else np.asarray(self.param.x0, dtype=float)
        if move_limit is None:
            res = minimize(
                fun, x0, jac=True,
                method="SLSQP",
                bounds=Bounds(self.param.lower, self.param.upper),
                constraints=cons,
                callback=lambda x: self._record(x, raw_at(x)),
                options={"maxiter": max_iterations, "ftol": ftol},
            )
            theta, nit = res.x, int(res.nit)
            success, message = bool(res.success), str(res.message)
        else:
            x = np.asarray(x0, dtype=float)
            f_prev = None
            success, message = False, "move-limit iteration cap reached"
            nit = 0
            for it in range(max_iterations):
                lo = np.maximum(self.param.lower, x - move_limit)
                hi = np.minimum(self.param.upper, x + move_limit)
                res = minimize(fun, x, jac=True, method="SLSQP",
                               bounds=Bounds(lo, hi), constraints=cons,
                               options={"maxiter": 1, "ftol": 0.0})
                x = np.clip(res.x, lo, hi)
                nit = it + 1
                f_now = raw_at(x)
                self._record(x, f_now)
                if f_prev is not None and np.isfinite(f_now) \
                        and abs(f_prev - f_now) <= ftol * max(abs(f_prev), 1e-30):
                    success, message = True, "move-limit ftol satisfied"
                    break
                f_prev = f_now
            theta = x
        # res.fun can hold a rejected trial's value; report f(res.x)
        raw_obj = raw_at(theta)
        # Final-point selection among FEASIBLE candidates: (a) the final
        # iterate (restored onto the density surface when SLSQP left it
        # slightly over — its internal constraint tolerance is looser than
        # ours), (b) the best feasible point evaluated anywhere in the run
        # (line-search trials included — a late NaN/garbage excursion can
        # leave the final iterate above designs already visited).
        theta = np.asarray(theta, dtype=float)
        cands = []
        if np.isfinite(raw_obj) and _feasible(theta):
            cands.append((raw_obj, theta, ""))
        elif np.isfinite(raw_obj):
            proj = self.project_density(theta)
            vproj = float(vg(proj)[0])
            if np.isfinite(vproj) and _feasible(proj):
                evals[proj.tobytes()] = vproj
                cands.append((vproj, proj, "; density-restored final point"))
        if best["x"] is not None and np.isfinite(best["v"]):
            cands.append((best["v"], best["x"],
                          "; returned best feasible evaluated point"))
        if cands:
            vb, xb, note = min(cands, key=lambda c: c[0])
            if not (np.array_equal(xb, theta) and vb == raw_obj):
                theta, raw_obj = xb, vb
                message = str(message) + note
        return OptimizationResult(
            theta=theta, radii=_np(self.param.cell_radii(self._theta(theta))),
            objective=raw_obj,
            density=self.density(theta) if self._density_vg is not None else float("nan"),
            iterations=nit, success=success,
            history=self.history, message=message)

    def optimize_projected(self, max_iterations: int = 100, step: float = None,
                           tol: float = 1e-8) -> OptimizationResult:
        """Projected gradient with box bounds + optional density equality
        projection by bisection on a uniform shift."""
        lo = self._theta(self.param.lower)
        hi = self._theta(self.param.upper)
        vg = self._value_and_grad
        dvg = self._density_vg
        spec = self.constraints.get("relative_density") if dvg is not None else None
        target = spec["value"] if spec else None
        mode = spec.get("mode", "upper") if spec else None

        @torch.no_grad()
        def project(x):
            x = torch.clamp(x, lo, hi)
            if spec is None:
                return x

            def rho(s):
                return self._density_theta(torch.clamp(x + s, lo, hi)) - target
            r0 = rho(0.0)
            need = bool((r0 > 0) if mode in ("upper",) else
                        (torch.abs(r0) > 0) if mode in ("eq", "band")
                        else (r0 < 0))
            if not need:
                return x
            # bisection on a uniform shift s, one host comparison a step
            a, b = -1.0, 1.0
            for _ in range(40):
                m = 0.5 * (a + b)
                if bool(rho(m) > 0):
                    b = m
                else:
                    a = m
            return torch.clamp(x + 0.5 * (a + b), lo, hi)

        x = self._theta(self.param.x0)
        x = project(x)
        v, g = vg(x)
        if step is None:
            step = 0.1 / (torch.linalg.norm(g) + 1e-12)
        n_done = 0
        for it in range(max_iterations):
            x_new = project(x - step * g)
            v_new, g_new = vg(x_new)
            self._record(x_new, v_new)
            n_done = it + 1
            if v_new > v:           # backtrack
                step = step * 0.5
                if step < 1e-12:
                    break
                continue
            if torch.abs(v - v_new) <= tol * torch.clamp_min(torch.abs(v),
                                                             1e-30):
                x, v, g = x_new, v_new, g_new
                break
            x, v, g = x_new, v_new, g_new
            step = step * 1.1
        return OptimizationResult(
            theta=_np(x), radii=_np(self.param.cell_radii(x)),
            objective=float(v),
            density=self.density(x) if dvg is not None else float("nan"),
            iterations=n_done, success=True, history=self.history)

    # ------------------------------------------------------------------
    def save_optimization_json(self, path, result: OptimizationResult) -> None:
        """Persist the run like save_optimization_json (lattice_opti.py:1730)."""
        payload = {
            "objective_type": self.objective_type,
            "objective_function": self.objective_function,
            "parameterization": self.param.kind,
            "n_parameters": self.param.n_params,
            "solution": {
                "objective": result.objective,
                "relative_density": result.density,
                "parameters": np.asarray(result.theta).tolist(),
                "iterations": result.iterations,
                "success": result.success,
            },
            "history": result.history,
        }
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=2)
