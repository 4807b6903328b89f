"""Port parity: pcg (with the reference solver's options), the
differentiable linear solves and the refined solves against the JAX
package on dense SPD systems in float64."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pylatticedso_tpu.fem.solve import pcg as jpcg
from pylatticedso_tpu_torch.fem.solve import pcg as tpcg

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)


def _spd(n, seed, cond=10.0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.logspace(0, np.log10(cond), n)
    return (Q * lam) @ Q.T, rng.standard_normal(n), rng.standard_normal(n)


@pytest.mark.parametrize("precond,warm", [(False, False), (True, False),
                                          (True, True)])
def test_pcg_matches_jax(precond, warm):
    A, b, x0 = _spd(40, seed=int(precond) + 2 * int(warm))
    dg = np.diag(A).copy()
    jA, tA = jnp.asarray(A), torch.tensor(A)
    kw_j = dict(maxiter=500, tol=1e-10)
    kw_t = dict(maxiter=500, tol=1e-10)
    if precond:
        kw_j["M"] = lambda r: r / jnp.asarray(dg)
        kw_t["M"] = lambda r: r / torch.tensor(dg)
    if warm:
        kw_j["x0"] = jnp.asarray(0.1 * x0)
        kw_t["x0"] = torch.tensor(0.1 * x0)
    rj = jpcg(lambda v: jA @ v, jnp.asarray(b), **kw_j)
    rt = tpcg(lambda v: tA @ v, torch.tensor(b), **kw_t)
    assert rt.iterations == int(rj.iterations) > 0
    assert rt.converged == bool(rj.converged)
    xj = np.asarray(rj.x)
    err = np.abs(rt.x.numpy() - xj).max() / np.abs(xj).max()
    assert err < 1e-12, err
    # the final residual sits at the 1e-10 level: compare it against |b|
    assert abs(float(rt.residual_norm) - float(rj.residual_norm)) \
        <= 1e-12 * np.linalg.norm(b)


def test_pcg_zero_rhs_and_maxiter():
    A, b, _ = _spd(20, seed=5)
    tA = torch.tensor(A)
    res = tpcg(lambda v: tA @ v, torch.zeros(20, dtype=torch.float64))
    assert res.iterations == 0 and res.converged
    assert torch.count_nonzero(res.x) == 0
    short = tpcg(lambda v: tA @ v, torch.tensor(b), maxiter=3, tol=1e-14)
    ref = jpcg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), maxiter=3,
               tol=1e-14)
    assert short.iterations == int(ref.iterations) == 3
    assert not short.converged
    np.testing.assert_allclose(short.x.numpy(), np.asarray(ref.x),
                               rtol=1e-12, atol=1e-14)


# -------------------------------------------------------------- pcg options
OPTIONS = {
    "mintol": dict(tol=1e-15, mintol=1e-4),
    "alpha_max": dict(tol=1e-10, alpha_max=0.3),
    "restart_every": dict(tol=1e-10, restart_every=3),
    "track_history": dict(tol=1e-10, track_history=True),
    "flexible": dict(tol=1e-10, flexible=True),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_pcg_options_match_jax(name):
    """Each reference-solver option of the JAX pcg, with the same
    semantics: iterations, convergence flag, solution and history."""
    A, b, x0 = _spd(30, seed=11)
    dg = np.diag(A).copy()
    jA, tA = jnp.asarray(A), torch.tensor(A)
    kw = dict(OPTIONS[name], maxiter=200)
    rj = jpcg(lambda v: jA @ v, jnp.asarray(b),
              M=lambda r: r / jnp.asarray(dg), x0=jnp.asarray(0.1 * x0), **kw)
    rt = tpcg(lambda v: tA @ v, torch.tensor(b),
              M=lambda r: r / torch.tensor(dg), x0=torch.tensor(0.1 * x0),
              **kw)
    assert rt.iterations == int(rj.iterations) > 0
    assert rt.converged == bool(rj.converged)
    xj = np.asarray(rj.x)
    assert np.abs(rt.x.numpy() - xj).max() / np.abs(xj).max() < 1e-12
    if name == "track_history":
        hj = np.asarray(rj.residual_history)
        ht = rt.residual_history.numpy()
        assert hj.shape == ht.shape == (200,)
        np.testing.assert_array_equal(ht < 0, hj < 0)
        np.testing.assert_allclose(ht, hj, rtol=1e-9,
                                   atol=1e-12 * np.linalg.norm(b))
    else:
        assert rt.residual_history is None
    if name == "mintol":            # stopped by the direction test
        assert float(rt.residual_norm) > 1e-15 * np.linalg.norm(b)
        assert rt.converged


# ------------------------------------------------- differentiable solves
def _param_system(seed, n=24):
    """A(theta) = A0 + diag(theta) (SPD for theta > 0) and b(phi) =
    b0 * phi, with a loss weight w."""
    A0, b0, w = _spd(n, seed=seed, cond=20.0)
    rng = np.random.default_rng(seed + 100)
    return A0, b0, w, rng.uniform(0.5, 1.5, n), rng.uniform(0.5, 1.5, n)


def test_linear_solve_gradient_matches_jax():
    """d(w . x)/d(theta, phi) through linear_solve (adjoint CG) against
    jax.grad through the JAX linear_solve, with a Jacobi M and a scaled
    warm start."""
    from pylatticedso_tpu.fem.solve import linear_solve as jls
    from pylatticedso_tpu_torch.fem.solve import linear_solve as tls
    A0, b0, w, th, ph = _param_system(3)
    x0 = np.linalg.solve(A0, b0) * 0.7

    def jloss(theta, phi):
        A = jnp.asarray(A0) + jnp.diag(theta)
        x = jls(lambda v: A @ v, jnp.asarray(b0) * phi,
                M=lambda r: r / jnp.diag(A), x0=jnp.asarray(x0),
                tol=1e-13, scale_x0=True)
        return jnp.sum(jnp.asarray(w) * x)

    vj, (gtj, gpj) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(th), jnp.asarray(ph))
    theta = torch.tensor(th, requires_grad=True)
    phi = torch.tensor(ph, requires_grad=True)
    A = torch.tensor(A0) + torch.diag(theta)
    dA = torch.diag(A).detach()
    x = tls(lambda v: A @ v, torch.tensor(b0) * phi, M=lambda r: r / dA,
            x0=torch.tensor(x0), tol=1e-13, scale_x0=True)
    vt = torch.sum(torch.tensor(w) * x)
    gtt, gpt = torch.autograd.grad(vt, (theta, phi))
    assert abs(float(vt.detach()) - float(vj)) <= 1e-12 * abs(float(vj))
    for a, b in ((gtj, gtt), (gpj, gpt)):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 1e-10 * np.abs(a).max()


def test_custom_linear_solve_runs_one_adjoint_solve():
    from pylatticedso_tpu_torch.fem.solve import custom_linear_solve
    A0, b0, w, th, _ph = _param_system(4)
    calls = []

    def solve_fn(mv, rhs):
        calls.append(rhs)
        return tpcg(mv, rhs, tol=1e-13, maxiter=500).x

    theta = torch.tensor(th, requires_grad=True)
    A = torch.tensor(A0) + torch.diag(theta)
    x = custom_linear_solve(lambda v: A @ v, torch.tensor(b0), solve_fn)
    assert len(calls) == 1
    (g,) = torch.autograd.grad(torch.sum(torch.tensor(w) * x), theta)
    assert len(calls) == 2                   # the adjoint solve
    lam = np.linalg.solve(A0 + np.diag(th), w)
    xs = np.linalg.solve(A0 + np.diag(th), b0)
    np.testing.assert_allclose(g.numpy(), -lam * xs, rtol=1e-9, atol=1e-12)
    with torch.no_grad():                    # no graph: a plain solve
        custom_linear_solve(lambda v: A @ v, torch.tensor(b0), solve_fn)
    assert len(calls) == 3


# --------------------------------------------------------- refined solves
# The inner solves run in float32 in both packages, whose float32 matrix
# products sum in different orders; the refined float64 solutions agree to
# the refinement tolerance times the condition number, not bitwise.
REFINED_TOL = 1e-7


def test_pcg_refined_and_refined_solve_match_jax():
    from pylatticedso_tpu.fem.solve import pcg_refined as jpr
    from pylatticedso_tpu.fem.solve import refined_solve as jrs
    from pylatticedso_tpu_torch.fem.solve import pcg_refined as tpr
    from pylatticedso_tpu_torch.fem.solve import refined_solve as trs
    A, b, _ = _spd(30, seed=7, cond=30.0)
    A32 = A.astype(np.float32)
    jA32, tA32 = jnp.asarray(A32), torch.tensor(A32)
    jA, tA = jnp.asarray(A), torch.tensor(A)
    xs = np.linalg.solve(A, b)
    # float32 CG refined with a float64 residual
    rj = jpr(lambda v: jA32 @ v, jnp.asarray(b, jnp.float32), tol=1e-5,
             refinements=3,
             residual_fn=lambda x: jnp.asarray(b) - jA @ x.astype(jnp.float64))
    rt = tpr(lambda v: tA32 @ v, torch.tensor(b, dtype=torch.float32),
             tol=1e-5, refinements=3,
             residual_fn=lambda x: torch.tensor(b) - tA @ x.double())
    assert rt.x.dtype == torch.float64
    for x in (np.asarray(rj.x), rt.x.numpy()):
        assert np.abs(x - xs).max() <= REFINED_TOL * np.abs(xs).max()
    assert rt.converged == bool(rj.converged)
    # adaptive refinement, float32 inner solves, float64 residuals
    kw = dict(tol=1e-12, inner_tol=1e-4, max_refinements=12)
    sj = jrs(lambda v: jA32 @ v, lambda v: jA @ v, jnp.asarray(b), **kw)
    st = trs(lambda v: tA32 @ v, lambda v: tA @ v, torch.tensor(b), **kw)
    assert st.converged and bool(sj.converged)
    assert st.x.dtype == torch.float64
    xj = np.asarray(sj.x)
    assert np.abs(st.x.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()
    assert abs(st.iterations - int(sj.iterations)) <= 2


def test_refined_solve_gradients_match_jax():
    """linear_solve_refined and linear_solve_dense_refined: values and
    gradients w.r.t. A_hi's parameters and b against jax.grad."""
    from pylatticedso_tpu.fem import solve as js
    from pylatticedso_tpu_torch.fem import solve as ts
    A0, b0, w, th, ph = _param_system(5)
    A_lo32 = (A0 + np.diag(th)).astype(np.float32)
    inv32 = np.linalg.inv(A_lo32.astype(np.float64)).astype(np.float32)

    def jloss(theta, phi, dense):
        A = jnp.asarray(A0) + jnp.diag(theta)
        b = jnp.asarray(b0) * phi
        if dense:
            x = js.linear_solve_dense_refined(
                lambda r: jnp.asarray(inv32) @ r.astype(jnp.float32), b,
                lambda v: A @ v, tol=1e-13)
        else:
            x = js.linear_solve_refined(
                lambda v: jnp.asarray(A_lo32) @ v, b, lambda v: A @ v,
                tol=1e-13, inner_tol=1e-5)
        return jnp.sum(jnp.asarray(w) * x)

    for dense in (False, True):
        vj, (gtj, gpj) = jax.value_and_grad(jloss, argnums=(0, 1))(
            jnp.asarray(th), jnp.asarray(ph), dense)
        theta = torch.tensor(th, requires_grad=True)
        phi = torch.tensor(ph, requires_grad=True)
        A = torch.tensor(A0) + torch.diag(theta)
        b = torch.tensor(b0) * phi
        if dense:
            x = ts.linear_solve_dense_refined(
                lambda r: torch.tensor(inv32) @ r.to(torch.float32), b,
                lambda v: A @ v, tol=1e-13)
        else:
            x = ts.linear_solve_refined(
                lambda v: torch.tensor(A_lo32) @ v, b, lambda v: A @ v,
                tol=1e-13, inner_tol=1e-5)
        vt = torch.sum(torch.tensor(w) * x)
        gtt, gpt = torch.autograd.grad(vt, (theta, phi))
        assert abs(float(vt.detach()) - float(vj)) <= 1e-11 * abs(float(vj))
        for a, g in ((gtj, gtt), (gpj, gpt)):
            a = np.asarray(a)
            assert np.abs(g.numpy() - a).max() <= 1e-10 * np.abs(a).max()
