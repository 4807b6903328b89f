"""Port parity of the design-gradient step's implicit forms with the
multigrid preconditioner (the bench's options) and a frozen state, in
float64, CG tol 1e-10:

* against the JAX step (c, g and u within 1e-10): the displacement
  objective with a nonzero imposed displacement on BCC n=4, and
  ``step.raw`` through ``torch.autograd.grad`` against JAX's
  value-and-grad of the same function (its ``_jitted_frozen``).  Both
  packages run from ONE frozen state, the port's, handed to JAX as numpy
  (the two states agree to 1e-12, tests/test_torch_step_mg.py).  BCC, not
  Octet: JAX unrolls the V-cycle into its forward and adjoint CG loops,
  and its compile grows with the template's edges and creators; on Octet
  one such step compiles for several times as long as on BCC;
* compliance under ``PLDSO_GRAD=implicit`` and ``PLDSO_SELFADJOINT=1`` on
  Octet n=4 and ``BCC+Hybrid1+Hybrid4`` n=4, against the port's analytic
  form on the same state, which tests/test_torch_step_mg.py holds to the
  JAX step at 1e-10: for compliance the three forms share the forward
  solve (the adjoint solve repeats it), so they agree to rounding at any
  CG tol, and these cases run at 1e-4.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu_torch.parallel.structured import (
    StructuredLattice, make_structured_compliance_step)
from test_torch_implicit_jacobi import (MG_OPTS, assert_close,
                                        displacement_steps, radius)

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

N = 4
HYBRID = ["BCC", "Hybrid1", "Hybrid4"]


def jax_state(port_state):
    """The port's frozen state as the JAX step's pytree."""
    return {k: [None if a is None else jnp.asarray(a.numpy()) for a in v]
            for k, v in port_state.items()}


@pytest.fixture(scope="module")
def disp():
    js, ts = displacement_steps(N, "mg", geom="BCC")
    st = ts.precond_state(torch.tensor(radius(10, N)))
    return js, ts, st, jax_state(st)


def test_frozen_state_displacement_matches_jax(disp):
    js, ts, st, sj = disp
    assert ts.grad_form == "implicit"
    r = radius(11, N)
    out_j = js(jnp.asarray(r), None, sj)
    assert_close(out_j, ts(torch.tensor(r), None, st))
    assert ts.last_adjoint["converged"]


def test_raw_autograd_with_frozen_state_matches_jax(disp):
    js, ts, st, sj = disp
    r = radius(12, N)
    free_j, f_j = js._operands
    (val_j, u_j), g_j = js._jitted_frozen(jnp.asarray(r), free_j, f_j,
                                          jnp.zeros_like(f_j), sj)
    rt = torch.tensor(r, requires_grad=True)
    free_t, f_t = ts._operands
    val_t, u_t = ts.raw(rt, free_t, f_t, torch.zeros_like(f_t), st)
    (g_t,) = torch.autograd.grad(val_t, rt)
    assert_close((val_j, g_j, u_j), (val_t, g_t, u_t))


def _port_compliance(geom, n, env):
    ts = StructuredLattice(geom, (n,) * 3, (1.0,) * 3, 1013.0, 0.3,
                           dtype=torch.float64, device="cpu")
    fixed = ts.select_nodes(lambda x, y, z: z == 0.0)
    top = ts.select_nodes(lambda x, y, z: z == float(n))
    f = np.zeros((ts.nc, 6) + ts.grid)
    for c in range(ts.nc):
        f[c, 2][top[c]] = -1.0 / int(top.sum())
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return make_structured_compliance_step(
            ts, ts.node_valid & ~fixed, f, tol=1e-4, maxiter=3000,
            precond="mg", mg_opts=MG_OPTS)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("geom,n", [("Octet", N), ("hybrid", 4)])
def test_implicit_and_selfadjoint_compliance_match_analytic(geom, n):
    g = HYBRID if geom == "hybrid" else geom
    lead = (3,) if geom == "hybrid" else ()
    r = torch.tensor(radius(13, n, lead))
    an = _port_compliance(g, n, {})
    im = _port_compliance(g, n, {"PLDSO_GRAD": "implicit"})
    sa = _port_compliance(g, n, {"PLDSO_SELFADJOINT": "1"})
    assert (an.grad_form, im.grad_form, sa.grad_form) == \
        ("analytic", "implicit", "selfadjoint")
    st = an.precond_state(r)
    ref = an(r, None, st)
    out_im = im(r, None, st)
    assert im.last_adjoint["iterations"] == im.last_solve["iterations"]
    out_sa = sa(r)                       # its own state, built at r
    for out in (out_im, out_sa):
        assert_close(tuple(x.numpy() for x in ref), out)
