"""The port's ``StructuredOptimizationProblem`` (float64, Jacobi, the
defaults) against the JAX package's on the 3x2x2 Octet cantilever of
``scripts/validate_structured_opt.py``, on the CPU, with the same theta
and density model: value and gradient at <= 1e-10 (relative to the largest
entry), equal to the port's unstructured problem at <= 1e-10, then the
projected driver for 3 iterations from the same warm state on both sides,
every history record at <= 1e-8.  One JAX structured value-and-gradient
compiles here (about a minute); the other structured cases are in
``tests/test_torch_opti_structured_cases.py`` so workers run them side by
side.
"""

import numpy as np
import jax.numpy as jnp
import torch

from pylatticedso_tpu import build_lattice as jax_build
from pylatticedso_tpu.opti.structured_optimizer import \
    StructuredOptimizationProblem as JaxStructured

from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.opti.optimizer import OptimizationProblem
from pylatticedso_tpu_torch.opti.structured_optimizer import \
    StructuredOptimizationProblem

from test_torch_opti_fem import (CON, HISTORY_TOL, OPT, VG_TOL, cantilever,
                                 models, rel, _same_history)

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)


def test_structured_matches_jax_and_drives_alike():
    cfg = cantilever((3, 2, 2), ["Octet"], [0.05])
    jm, tm = models("Octet")
    jp = JaxStructured(jax_build(cfg), opt_params=OPT, constraints=CON,
                       density_model=jm)
    lat = build_lattice(cfg)
    tp = StructuredOptimizationProblem(lat, opt_params=OPT, constraints=CON,
                                       density_model=tm, device="cpu")
    up = OptimizationProblem(lat, opt_params=OPT, constraints=CON,
                             density_model=tm, device="cpu")
    assert tp._step.grad_form == "implicit"
    x0 = np.asarray(tp.param.x0) * 0.9 + 0.03
    vj, gj = jp._value_and_grad(jnp.asarray(x0))
    vt, gt = tp._value_and_grad(x0)
    assert abs(float(vt) - float(vj)) <= VG_TOL * abs(float(vj))
    assert rel(gt.numpy(), gj) <= VG_TOL
    vu, gu = up._value_and_grad(x0)
    assert abs(float(vt) - float(vu)) <= VG_TOL * abs(float(vu))
    assert rel(gt.numpy(), gu.numpy()) <= VG_TOL
    ev = tp.evaluations[-1]
    assert ev["forward"] > 0 and ev["adjoint"] > 0
    assert ev["objective"] == float(vt)
    assert set(tp.setup_s) == {"problem", "node_map", "fields", "step"}
    # the drivers: both problems warm-started from the same evaluation
    rj = jp.optimize_projected(max_iterations=3)
    rt = tp.optimize_projected(max_iterations=3)
    assert len(tp.history) == 3
    _same_history(jp, tp, rj, rt)
    assert rt.density <= CON["relative_density"]["value"] + 1e-6
    assert HISTORY_TOL == 1e-8
