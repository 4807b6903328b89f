"""Port parity of the design-gradient step's implicit forms with the Jacobi
preconditioner, against the JAX step in float64 (n=3, CG tol 1e-10, c, g
and u within 1e-10):

* on Octet, a displacement objective (the JAX optimizer's "max" of the
  top face's mean Z displacement) with a nonzero imposed X displacement of
  the clamped face, which forces the implicit form, cold and
  warm-started, and ``step.raw`` through ``torch.autograd.grad`` against
  JAX's ``value_and_grad`` of its ``step.raw`` (the step's own jitted
  function);
* on BCC, compliance under ``PLDSO_GRAD=implicit`` (a JAX step compiles
  several times faster on BCC's single-creator template than on Octet's,
  whose shared beams the displacement case already covers);
* ``PLDSO_SELFADJOINT=1`` and ``step.batch`` (B = 3), held to the JAX
  implicit compliance step: for compliance the JAX package's self-adjoint
  and implicit forms give one gradient (the adjoint solve repeats the
  forward one), and its ``step.batch`` vmaps that same value-and-grad over
  the candidates, a vmapped while-loop freezing each converged lane, so
  each candidate's cold step is its result.  Compiling JAX's own
  self-adjoint and vmapped programs would cost minutes of this file's
  budget for the same numbers.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu.parallel.structured import (
    StructuredLattice as JSL, make_structured_compliance_step as jstep)
from pylatticedso_tpu_torch import convert
from pylatticedso_tpu_torch.parallel.structured import (
    StructuredLattice as TSL, make_structured_compliance_step as tstep)

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

N = 3
TOL = 1e-10
MG_OPTS = {"nu": (1, 2), "coarse_degree": 24, "smooth_frac": 0.35,
           "power_iters": 5}


def problem(n, geom="Octet"):
    """(jax lattice, port lattice, free, f, u_imposed, selector): the
    bench's problem with an imposed X displacement of 1e-3 on the clamped
    face and the top face's mean Z displacement as the selector."""
    js = JSL(geom, (n,) * 3, (1.0,) * 3, 1013.0, 0.3, dtype=jnp.float64)
    ts = TSL(geom, (n,) * 3, (1.0,) * 3, 1013.0, 0.3, dtype=torch.float64,
             device="cpu")
    fixed = js.select_nodes(lambda x, y, z: z == 0.0)
    top = js.select_nodes(lambda x, y, z: z == float(n))
    free = js.node_valid & ~fixed
    f = np.zeros((js.nc, 6) + js.grid)
    u_imp = np.zeros_like(f)
    sel = np.zeros_like(f)
    n_top = int(top.sum())
    for c in range(js.nc):
        f[c, 2][top[c]] = -1.0 / n_top
        u_imp[c, 0][fixed[c]] = 1e-3
        sel[c, 2][top[c]] = 1.0 / n_top
    return js, ts, free, f, u_imp, sel


def _options(precond, kw):
    opts = dict(tol=TOL, maxiter=3000, precond=precond,
                mg_opts=MG_OPTS if precond == "mg" else None)
    opts.update(kw)
    return opts


def displacement_steps(n, precond, geom="Octet", **kw):
    """(jax_step, port_step) of the displacement objective with the
    imposed displacement; the port's objective comes through the
    converter from the JAX optimizer's selector field."""
    js, ts, free, f, u_imp, sel = problem(n, geom)
    sel_j = jnp.asarray(sel)
    obj_j = lambda u, f_: -jnp.sum(sel_j * u)
    obj_t = convert.objective_from_jax("displacement", [sel], "max",
                                       device="cpu")
    opts = _options(precond, kw)
    return (jstep(js, free, f, u_imposed=u_imp, objective=obj_j, **opts),
            tstep(ts, free, f, u_imposed=u_imp, objective=obj_t, **opts))


def compliance_steps(n, precond, env, geom="Octet", **kw):
    js, ts, free, f, _u, _s = problem(n, geom)
    opts = _options(precond, kw)
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return jstep(js, free, f, **opts), tstep(ts, free, f, **opts)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def radius(seed, n=N, lead=()):
    return np.random.default_rng(seed).uniform(0.03, 0.08, lead + (n,) * 3)


def assert_close(jax_out, port_out, tol=TOL):
    """Each of the outputs agrees to ``tol`` relative to max |.|."""
    for k, (a, b) in enumerate(zip(jax_out, port_out)):
        a = np.asarray(a)
        b = b.detach().numpy()
        assert a.shape == b.shape, k
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err <= tol, f"output {k}: {err:.3e}"


@pytest.fixture(scope="module")
def disp():
    return displacement_steps(N, "jacobi")


@pytest.fixture(scope="module")
def implicit():
    return compliance_steps(N, "jacobi", {"PLDSO_GRAD": "implicit"},
                            geom="BCC")


def test_displacement_with_imposed_displacement_matches_jax(disp):
    js, ts = disp
    assert ts.grad_form == "implicit"
    r = radius(1)
    out_j = js(jnp.asarray(r))
    out_t = ts(torch.tensor(r))
    assert_close(out_j, out_t)
    assert ts.last_adjoint is not None and ts.last_adjoint["converged"]
    # the imposed values come back on the constrained DOFs
    free_t = ts.operands[0]
    u_imp = convert.step_inputs_from_jax(
        r, *(np.asarray(x) for x in js._operands),
        u_imposed=problem(N)[4], device="cpu")[3]
    assert torch.equal((1.0 - free_t) * out_t[2], u_imp)
    cold = ts.last_solve["iterations"]
    r2 = r * 1.01
    assert_close(js(jnp.asarray(r2), out_j[2]), ts(torch.tensor(r2),
                                                   out_t[2]))
    assert ts.last_solve["iterations"] < cold


def test_raw_autograd_matches_jax_grad(disp):
    """The optimizer's entry: d obj / d radius of ``step.raw``."""
    js, ts = disp
    r = radius(2)
    free_j, f_j = js._operands
    (val_j, u_j), g_j = js._jitted(jnp.asarray(r), free_j, f_j,
                                   jnp.zeros_like(f_j))
    rt = torch.tensor(r, requires_grad=True)
    free_t, f_t = ts._operands
    val_t, u_t = ts.raw(rt, free_t, f_t, torch.zeros_like(f_t))
    (g_t,) = torch.autograd.grad(val_t, rt)
    assert_close((val_j, g_j, u_j), (val_t, g_t, u_t))


def test_implicit_compliance_matches_jax(implicit):
    js, ts = implicit
    assert ts.grad_form == "implicit"
    r = radius(3)
    assert_close(js(jnp.asarray(r)), ts(torch.tensor(r)))
    # compliance: the adjoint solve repeats the forward one
    assert ts.last_adjoint["iterations"] == ts.last_solve["iterations"]


def test_selfadjoint_matches_jax(implicit):
    js, _ts = implicit
    _j, ts = compliance_steps(N, "jacobi", {"PLDSO_SELFADJOINT": "1"},
                              geom="BCC")
    assert ts.grad_form == "selfadjoint"
    r = radius(4)
    assert_close(js(jnp.asarray(r)), ts(torch.tensor(r)))
    assert ts.last_adjoint is None


def test_batch_matches_jax(implicit):
    js, ts = implicit
    rs = radius(5, lead=(3,))
    c_t, g_t = ts.batch(torch.tensor(rs))
    assert tuple(c_t.shape) == (3,) and tuple(g_t.shape) == rs.shape
    for b in range(3):
        c_j, g_j, _u = js(jnp.asarray(rs[b]))
        assert_close((c_j, g_j), (c_t[b], g_t[b]))
