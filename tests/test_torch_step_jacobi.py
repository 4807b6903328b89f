"""Port parity: the whole compliance step with the Jacobi preconditioner,
cold and warm-started, against the JAX step in float64 (Octet n=4)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pylatticedso_tpu.parallel.structured import (
    StructuredLattice as JSL, make_structured_compliance_step as jstep)
from pylatticedso_tpu_torch.parallel.structured import (
    StructuredLattice as TSL, make_structured_compliance_step as tstep)

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

N = 4
TOL = 1e-10
MG_OPTS = {"nu": (1, 2), "coarse_degree": 24, "smooth_frac": 0.35,
           "power_iters": 5}


def steps(precond):
    """(jax_step, port_step) on the bench's problem: n^3 Octet clamped at
    z = 0, unit load on the top face, f64, CG tol 1e-10."""
    js = JSL("Octet", (N, N, N), (1.0, 1.0, 1.0), 1013.0, 0.3,
             dtype=jnp.float64)
    ts = TSL("Octet", (N, N, N), (1.0, 1.0, 1.0), 1013.0, 0.3,
             dtype=torch.float64, device="cpu")
    fixed = js.select_nodes(lambda x, y, z: z == 0.0)
    top = js.select_nodes(lambda x, y, z: z == float(N))
    free = js.node_valid & ~fixed
    f = np.zeros((js.nc, 6) + js.grid)
    for c in range(js.nc):
        f[c, 2][top[c]] = -1.0 / int(top.sum())
    kw = dict(tol=1e-10, maxiter=3000, precond=precond,
              mg_opts=MG_OPTS if precond == "mg" else None)
    return jstep(js, free, f, **kw), tstep(ts, free, f, **kw)


def radius(seed):
    return np.random.default_rng(seed).uniform(0.03, 0.08, (N, N, N))


def assert_close(jax_out, port_out, tol=TOL):
    """c, g and u of both steps agree to ``tol`` (relative to max |.|)."""
    for name, a, b in zip("cgu", jax_out, port_out):
        a = np.asarray(a)
        b = b.detach().numpy()
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err <= tol, f"{name}: {err:.3e}"


@pytest.fixture(scope="module")
def pair():
    return steps("jacobi")


def test_cold_and_warm_match_jax(pair):
    js, ts = pair
    r = radius(1)
    out_j = js(jnp.asarray(r))
    out_t = ts(torch.tensor(r))
    assert_close(out_j, out_t)
    cold_iters = ts.last_solve["iterations"]
    r2 = r * 1.01
    out_j2 = js(jnp.asarray(r2), out_j[2])
    out_t2 = ts(torch.tensor(r2), out_t[2])
    assert_close(out_j2, out_t2)
    assert ts.last_solve["iterations"] < cold_iters


def test_unported_step_features_raise(monkeypatch):
    """What the port's step still declines: on the multigrid a fused
    request the state cannot meet (float64 has no fused smoother; JAX
    warns and falls back there), with or without the fused V-cycle's bf16
    arithmetic (ported: it changes nothing where there is no fused level).
    A warped lattice's step is ported: here JAX's c, g and u on a small
    one (tests/test_torch_warped_step.py holds the rest).  ``u_imposed``,
    a custom objective, the implicit and self-adjoint forms and
    ``step.batch`` are ported and held to JAX in
    tests/test_torch_implicit_{jacobi,mg}.py."""
    kw = dict(dtype=torch.float64, device="cpu")
    warp = lambda x, y, z: (x, y, z + 0.1 * x)
    warped = TSL("BCC", (2, 2, 2), (1.0, 1.0, 1.0), 1013.0, 0.3,
                 node_transform=warp, **kw)
    wj = JSL("BCC", (2, 2, 2), (1.0, 1.0, 1.0), 1013.0, 0.3,
             dtype=jnp.float64, node_transform=warp)
    f = np.zeros((warped.nc, 6) + warped.grid)
    tip = warped.select_nodes(lambda x, y, z: x == 2.0)
    for c in range(warped.nc):
        f[c, 2][tip[c]] = -0.1
    free = warped.node_valid & ~warped.select_nodes(
        lambda x, y, z: x == 0.0)
    r = np.full((2, 2, 2), 0.05)
    assert_close(jstep(wj, free, f, tol=1e-10)(jnp.asarray(r)),
                 tstep(warped, free, f, tol=1e-10)(torch.tensor(r)))
    ts = TSL("BCC", (2, 2, 2), (1.0, 1.0, 1.0), 1013.0, 0.3, **kw)
    step = tstep(ts, ts.node_valid, f, precond="mg",
                 mg_opts={"fused": True, "power_iters": 1})
    r = torch.full((2, 2, 2), 0.05, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="fall back"):
        step(r)
    monkeypatch.setenv("PLDSO_MG_FUSED_COMPUTE", "bf16")
    with pytest.raises(RuntimeError, match="fall back"):
        step(r)
