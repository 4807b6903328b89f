"""Port parity: pcg against the JAX pcg on dense SPD systems in float64."""

import numpy as np
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
