"""The whole compliance step with the fused V-cycle in bf16 storage (the
bench's configuration), port against the JAX package (kernels in
interpret mode), Octet n=4, tol 1e-8: compliance within 1e-6 and u and the
gradient within 1e-4 relative, as ``tests/test_stencil_pallas.py:327-340``
holds the JAX fused step against the unfused one (the preconditioner moves
only the path to the fixed point, and bf16 storage shapes M, never the
fixed point)."""

import jax.numpy as jnp
import numpy as np
import torch

from pylatticedso_tpu.parallel.structured import StructuredLattice as JSL
from pylatticedso_tpu.parallel.structured import (
    make_structured_compliance_step as jstep)
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice as TSL
from pylatticedso_tpu_torch.parallel.structured import (
    make_structured_compliance_step as tstep)

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

N = 4
MG = {"nu": (1, 1), "coarse_degree": 6, "power_iters": 3, "fused": True}


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_fused_bf16_step_matches_jax(monkeypatch):
    monkeypatch.setenv("PLDSO_MATVEC", "pallas")
    monkeypatch.setenv("PLDSO_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PLDSO_MG_FUSED_DTYPE", "bf16")
    monkeypatch.delenv("PLDSO_MG_FUSED", raising=False)
    monkeypatch.delenv("PLDSO_MG_BF16", raising=False)
    js = JSL("Octet", (N,) * 3, (1.0,) * 3, 1013.0, 0.3)
    fixed = js.select_nodes(lambda x, y, z: z == 0.0)
    top = js.select_nodes(lambda x, y, z: z == float(N))
    free = js.node_valid & ~fixed
    f = np.zeros((js.nc, 6) + js.grid, np.float32)
    for c in range(js.nc):
        f[c, 2][top[c]] = -1.0 / int(top.sum())
    r0 = np.full((N,) * 3, 0.05, np.float32)

    sj = jstep(js, free, f, tol=1e-8, maxiter=500, precond="mg", mg_opts=MG)
    ps_j = sj.precond_state(jnp.asarray(r0))
    assert all(fo["fdinv"].dtype == jnp.bfloat16 for fo in ps_j["fused"])
    c_j, g_j, u_j = sj(jnp.asarray(r0), None, ps_j)

    ts = TSL("Octet", (N,) * 3, (1.0,) * 3, 1013.0, 0.3, dtype=torch.float32,
             device="cpu")
    st = tstep(ts, free, f, tol=1e-8, maxiter=500, precond="mg", mg_opts=MG)
    ps_t = st.precond_state(torch.tensor(r0))
    assert all(fo["fdinv"].dtype == torch.bfloat16 for fo in ps_t["fused"])
    c_t, g_t, u_t = st(torch.tensor(r0), None, ps_t)

    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-6)
    assert _rel(u_j, u_t.numpy()) <= 1e-4
    assert _rel(g_j, g_t.numpy()) <= 1e-4
    # the same fixed point as the unfused V-cycle; with f32 storage the
    # fused V-cycle is the unfused one up to rounding, and converges alike
    su = tstep(ts, free, f, tol=1e-8, maxiter=500, precond="mg",
               mg_opts=dict(MG, fused=False))
    c_u, _, _ = su(torch.tensor(r0))
    np.testing.assert_allclose(float(c_t), float(c_u), rtol=1e-6)
    monkeypatch.setenv("PLDSO_MG_FUSED_DTYPE", "f32")
    s32 = tstep(ts, free, f, tol=1e-8, maxiter=500, precond="mg",
                mg_opts=MG)
    c_32, _, _ = s32(torch.tensor(r0))
    np.testing.assert_allclose(float(c_32), float(c_u), rtol=1e-6)
    assert abs(s32.last_solve["iterations"]
               - su.last_solve["iterations"]) <= 1
