"""Port parity of the unfused bf16-I/O smoother route (``lo_smoother``,
``PLDSO_MG_BF16=1``, the bench's ``BENCH_MG_FUSED=0`` route): kernel B2's
plain version against the JAX Pallas ``apply.lo`` (interpret mode), the
lo V-cycle from one JAX state carried over by the converter, and the
whole step's fixed point.

Tolerances: 1e-2 between the two bf16 outputs (both round the same f32
values at the same points, so they differ where an order-of-summation
difference flips a bf16 rounding, 2^-8 relative), 3e-2 against float32
(``tests/test_stencil_pallas.py:89``: bf16 rounding of inputs and output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu.parallel import multigrid as jmg
from pylatticedso_tpu.parallel.stencil_pallas import make_pallas_matvec
from pylatticedso_tpu.parallel.structured import StructuredLattice as JSL
from pylatticedso_tpu_torch import convert
from pylatticedso_tpu_torch.parallel import multigrid as tmg
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice as TSL
from pylatticedso_tpu_torch.parallel.structured import (
    make_structured_compliance_step as tstep)

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)


def rel(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def f64(t):
    return t.to(torch.float64).numpy()


@pytest.mark.parametrize("geom", ["Octet", "BCC"])
def test_lo_matvec_matches_jax(geom):
    n = 4
    js = JSL(geom, (n,) * 3, (1.0,) * 3, 1013.0, 0.3)
    mv, _ = js.make_matvec()
    prep_p, apply_p = make_pallas_matvec(js, mv.prepare, mv.apply,
                                         interpret=True)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((js.nc, 6) + js.grid).astype(np.float32)
    r = (0.04 + 0.05 * rng.random((n,) * 3)).astype(np.float32)
    aux = prep_p(jnp.asarray(r))
    y32 = np.asarray(apply_p(jnp.asarray(u), aux))
    y16_j = np.asarray(apply_p.lo(jnp.asarray(u, jnp.bfloat16),
                                  apply_p.prepare_lo(aux)).astype(jnp.float32))

    ts = TSL(geom, (n,) * 3, (1.0,) * 3, 1013.0, 0.3, dtype=torch.float32,
             device="cpu")
    tm, _ = ts.make_matvec()
    aux_t = tm.prepare(torch.tensor(r))
    aux_lo = tm.apply.prepare_lo(aux_t)
    assert aux_lo.dtype == torch.bfloat16
    y16_t = tm.apply.lo(torch.tensor(u).to(torch.bfloat16), aux_lo)
    assert y16_t.dtype == torch.bfloat16
    assert tuple(y16_t.shape) == (ts.nc, 6) + ts.grid
    assert rel(y16_j, f64(y16_t)) <= 1e-2
    assert rel(y32, f64(y16_t)) <= 3e-2
    with pytest.raises(ValueError, match="bfloat16"):
        tm.apply.lo(torch.tensor(u), aux_lo)


def test_lo_vcycle_matches_jax(monkeypatch):
    """Port lo M(v) against JAX lo M(v), BCC n=4, from one Pallas-layout
    JAX state (its bf16 r^2 copies carried over), and more than 1e-6 away
    from the port's f32 M (B2 is engaged)."""
    monkeypatch.setenv("PLDSO_MATVEC", "pallas")
    monkeypatch.setenv("PLDSO_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PLDSO_MG_FUSED", raising=False)
    n = 4
    js = JSL("BCC", (n,) * 3, (1.0,) * 3, 1013.0, 0.3)
    fixed = js.select_nodes(lambda x, y, z: z == 0.0)
    free = np.broadcast_to((js.node_valid & ~fixed)[:, None],
                           (js.nc, 6) + js.grid)
    hj = jmg.build_mg_hierarchy(js, free)
    rng = np.random.default_rng(5)
    r0 = jnp.asarray(0.04 + 0.03 * rng.random((n,) * 3), jnp.float32)
    sj = jmg.mg_precond_state(hj, r0, power_iters=3)
    assert all(a is not None for a in sj["auxs_lo"])
    st = convert.precond_state_from_jax(
        jax.tree_util.tree_map(np.asarray, sj), dtype=torch.float32,
        device="cpu")
    ts = TSL("BCC", (n,) * 3, (1.0,) * 3, 1013.0, 0.3, dtype=torch.float32,
             device="cpu")
    ht = tmg.build_mg_hierarchy(ts, free)
    v = rng.standard_normal((js.nc, 6) + js.grid).astype(np.float32) \
        * np.asarray(hj["levels"][0].free)
    opts = dict(nu=(1, 2), coarse_degree=6, smooth_frac=0.35)
    mj = np.asarray(jmg.mg_apply(hj, sj, lo_smoother=True, fused=False,
                                 **opts)(jnp.asarray(v)))
    mt = f64(tmg.mg_apply(ht, st, lo_smoother=True, fused=False,
                          **opts)(torch.tensor(v)))
    m32 = f64(tmg.mg_apply(ht, st, lo_smoother=False, fused=False,
                           **opts)(torch.tensor(v)))
    assert rel(mj, mt) <= 3e-2
    assert 1e-6 < rel(m32, mt) <= 3e-2


def test_lo_step_keeps_the_fixed_point(monkeypatch):
    """The lo route's step reaches the f32 route's solution (Octet n=4,
    tol 1e-8; ``tests/test_stencil_pallas.py:92-115``'s tolerances)."""
    monkeypatch.delenv("PLDSO_MG_FUSED", raising=False)
    n = 4
    ts = TSL("Octet", (n,) * 3, (1.0,) * 3, 1013.0, 0.3, dtype=torch.float32,
             device="cpu")
    free = ts.select_nodes(lambda x, y, z: z > 1e-9)
    f = ts.node_field()
    top = ts.select_nodes(lambda x, y, z: z > n - 1e-9)
    f[:, 2][top] = -0.5
    r = torch.full((n,) * 3, 0.05)
    mg = {"nu": (1, 2), "coarse_degree": 24, "smooth_frac": 0.35,
          "power_iters": 5}
    hi = tstep(ts, free, f, tol=1e-8, maxiter=400, precond="mg",
               mg_opts=mg)
    lo = tstep(ts, free, f, tol=1e-8, maxiter=400, precond="mg",
               mg_opts=dict(mg, lo_smoother=True))
    c_hi, g_hi, _ = hi(r)
    c_lo, g_lo, _ = lo(r)
    launches = [lvl.matvec.apply.launches_lo for lvl in lo.hierarchy["levels"]]
    assert launches == [0] * len(launches)        # no kernel on the CPU
    np.testing.assert_allclose(float(c_lo), float(c_hi), rtol=1e-6)
    np.testing.assert_allclose(g_lo.numpy(), g_hi.numpy(), rtol=1e-4,
                               atol=1e-10)
