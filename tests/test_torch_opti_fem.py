"""The port's unstructured design problem (``opti.OptimizationProblem``,
the FEM route) and its two drivers against the JAX package's, in float64
on the CPU, with the same lattice, theta and density model on both sides:

* value and gradient at <= 1e-10 (relative to the largest entry) for the
  compliance objective on the 3x2x2 Octet cantilever of
  ``scripts/validate_structured_opt.py``, the displacement objective (max,
  the sign-sensitive case) and compliance on a 2^3 BCC+Hybrid1 lattice;
* ``optimize_projected`` and ``optimize_slsqp``, 3 iterations each: every
  history record's objective, density and parameters at <= 1e-8.

Each JAX problem compiles one value-and-gradient (a few seconds).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu import build_lattice as jax_build
from pylatticedso_tpu.opti.density import KrigingDensity as JaxKriging
from pylatticedso_tpu.opti.optimizer import OptimizationProblem as JaxProblem

from pylatticedso_tpu_torch import convert
from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.opti.optimizer import OptimizationProblem

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FIT = ROOT / "data/outputs/density_datasets"
VG_TOL = 1e-10
HISTORY_TOL = 1e-8
OPT = {"type": "unit_cell"}
CON = {"relative_density": {"value": 0.10, "mode": "upper"}}


def cantilever(n, geoms, radii):
    return {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                         "number_of_cells": dict(zip("xyz", n)),
                         "radii": radii, "geom_types": geoms},
            "boundary_conditions": {
                "Displacement": {"Fixed": {
                    "Surface": ["Xmin"],
                    "DOF": ["X", "Y", "Z", "RX", "RY", "RZ"],
                    "Value": [0, 0, 0, 0, 0, 0]}},
                "Force": {"Load": {"Surface": ["Xmax"], "DOF": ["Z"],
                                   "Value": [-0.1]}}}}


def models(name):
    """The same density model in both packages: the JAX fit from its
    cache, carried across by ``convert.kriging_from_jax``."""
    jm = JaxKriging.load(FIT / f"{name}_0.01_0.1_10.gpr.npz")
    return jm, convert.kriging_from_jax(
        {f.name: np.asarray(getattr(jm, f.name))
         for f in dataclasses.fields(jm)})


def rel(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    return float(np.abs(got - want).max() / np.abs(want).max())


def pair(cfg, fit, **kw):
    jm, tm = models(fit)
    jp = JaxProblem(jax_build(cfg), density_model=jm, **kw)
    tp = OptimizationProblem(build_lattice(cfg), density_model=tm,
                             device="cpu", **kw)
    return jp, tp


CASES = {
    "octet_compliance": (cantilever((3, 2, 2), ["Octet"], [0.05]), "Octet",
                         dict(opt_params=OPT, constraints=CON)),
    "bcc_displacement_max": (
        cantilever((2, 1, 1), ["BCC"], [0.05]), "BCC",
        dict(objective_type="displacement", objective_function="max",
             objective_data={"Surface": ["Xmax"], "DOF": ["Z"]},
             opt_params=OPT, constraints={})),
    "bcc_hybrid1_compliance": (
        cantilever((2, 2, 2), ["BCC", "Hybrid1"], [0.05, 0.04]),
        "BCC_Hybrid1", dict(opt_params=OPT, constraints=CON)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_value_and_grad_match_jax(case):
    cfg, fit, kw = CASES[case]
    jp, tp = pair(cfg, fit, **kw)
    rng = np.random.default_rng(11)
    x = 0.3 + 0.4 * rng.random(tp.param.n_params)
    vj, gj = jp._value_and_grad(jnp.asarray(x))
    vt, gt = tp._value_and_grad(x)
    assert abs(float(vt) - float(vj)) <= VG_TOL * abs(float(vj))
    assert rel(gt.numpy(), gj) <= VG_TOL
    assert tp.objective(x) == float(vt)
    np.testing.assert_array_equal(tp.gradient(x), gt.numpy())
    if tp._density_vg is not None:
        dj, dgj = jp._density_vg(jnp.asarray(x))
        dt, dgt = tp._density_vg(x)
        assert abs(float(dt) - float(dj)) <= VG_TOL * abs(float(dj))
        assert rel(dgt.numpy(), dgj) <= VG_TOL


def _same_history(jp, tp, rj, rt):
    assert len(tp.history) == len(jp.history) >= 1
    for hj, ht in zip(jp.history, tp.history):
        assert abs(ht["objective"] - hj["objective"]) <= \
            HISTORY_TOL * abs(hj["objective"])
        assert abs(ht["relative_density"] - hj["relative_density"]) <= \
            HISTORY_TOL * abs(hj["relative_density"])
        assert rel(ht["parameters"], hj["parameters"]) <= HISTORY_TOL
    assert abs(rt.objective - rj.objective) <= HISTORY_TOL * abs(rj.objective)
    assert abs(rt.density - rj.density) <= HISTORY_TOL * abs(rj.density)
    assert rel(rt.theta, rj.theta) <= HISTORY_TOL
    assert rel(rt.radii, rj.radii) <= HISTORY_TOL
    assert rt.iterations == rj.iterations


def test_projected_driver_matches_jax():
    cfg, fit, kw = CASES["octet_compliance"]
    jp, tp = pair(cfg, fit, **kw)
    rj = jp.optimize_projected(max_iterations=3)
    rt = tp.optimize_projected(max_iterations=3)
    assert len(tp.history) == 3
    _same_history(jp, tp, rj, rt)
    assert rt.density <= CON["relative_density"]["value"] + 1e-6


def test_slsqp_driver_matches_jax(tmp_path):
    cfg, fit, kw = CASES["octet_compliance"]
    jp, tp = pair(cfg, fit, **kw)
    rj = jp.optimize_slsqp(max_iterations=3)
    rt = tp.optimize_slsqp(max_iterations=3)
    _same_history(jp, tp, rj, rt)
    assert rt.message == rj.message and rt.success == rj.success
    tp.save_optimization_json(tmp_path / "run.json", rt)
    import json
    saved = json.loads((tmp_path / "run.json").read_text())
    assert saved["solution"]["objective"] == rt.objective
    assert saved["n_parameters"] == tp.param.n_params == 12
    # the feasible start and the density restoration agree too
    np.testing.assert_allclose(tp.feasible_x0(), jp.feasible_x0(), rtol=0,
                               atol=1e-12)
    # (its last step nudges by 1e-9, doubling, until the density is on the
    # feasible side: a rounding-level difference of the density at the
    # root may take one nudge more or less)
    x_over = np.asarray(tp.param.x0) + 0.05
    proj = tp.project_density(x_over)
    np.testing.assert_allclose(proj, jp.project_density(x_over), rtol=0,
                               atol=HISTORY_TOL)
    assert tp.density(proj) <= CON["relative_density"]["value"]
