"""The port's ``StructuredOptimizationProblem`` against the JAX package's
on two more cases (float64, Jacobi, on the CPU): the displacement objective
("max", whose sign applies to displacement only) on a 2x1x1 BCC
cantilever, and compliance on a 2^3 BCC+Hybrid1 lattice (a per-geometry
radius field).  Value and gradient at <= 1e-10 (relative to the largest
entry), and against the port's unstructured problem at <= 1e-10.  Each
case compiles one JAX structured value-and-gradient.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pylatticedso_tpu import build_lattice as jax_build
from pylatticedso_tpu.opti.structured_optimizer import \
    StructuredOptimizationProblem as JaxStructured

from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.opti.optimizer import OptimizationProblem
from pylatticedso_tpu_torch.opti.structured_optimizer import \
    StructuredOptimizationProblem

from test_torch_opti_fem import CASES, VG_TOL, models, rel

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["bcc_displacement_max",
                                  "bcc_hybrid1_compliance"])
def test_structured_matches_jax(case):
    cfg, fit, kw = CASES[case]
    jm, tm = models(fit)
    jp = JaxStructured(jax_build(cfg), density_model=jm, **kw)
    lat = build_lattice(cfg)
    tp = StructuredOptimizationProblem(lat, density_model=tm, device="cpu",
                                       **kw)
    up = OptimizationProblem(lat, density_model=tm, device="cpu", **kw)
    assert tp._slat.n_geom == len(lat.config.geom_types)
    x = 0.3 + 0.4 * np.random.default_rng(12).random(tp.param.n_params)
    vj, gj = jp._value_and_grad(jnp.asarray(x))
    vt, gt = tp._value_and_grad(x)
    assert abs(float(vt) - float(vj)) <= VG_TOL * abs(float(vj))
    assert rel(gt.numpy(), gj) <= VG_TOL
    vu, gu = up._value_and_grad(x)
    assert abs(float(vt) - float(vu)) <= VG_TOL * abs(float(vu))
    assert rel(gt.numpy(), gu.numpy()) <= VG_TOL
    if kw.get("objective_type") == "displacement":
        # under a -Z tip load the mean Z displacement is negative; "max"
        # negates it
        assert float(vt) > 0
