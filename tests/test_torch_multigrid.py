"""Port parity: multigrid transfers, radius restriction, hierarchy, lmax
and the V-cycle M(v) against the JAX package in float64, with the JAX
state carried over by convert.precond_state_from_jax."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pylatticedso_tpu.parallel import multigrid as jmg
from pylatticedso_tpu.parallel.structured import StructuredLattice as JSL
from pylatticedso_tpu_torch import convert
from pylatticedso_tpu_torch.parallel import multigrid as tmg
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice as TSL

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

TOL = 1e-12
OPTS = dict(nu=(1, 2), coarse_degree=24, smooth_frac=0.35)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


@pytest.mark.parametrize("fine,coarse,keys", [
    ((7, 6, 5), (4, 4, 3), np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0]])),
    ((5, 5, 5), (3, 3, 3), JSL("Octet", (4, 4, 4), (1., 1., 1.), 1.0,
                               0.3).class_keys),
])
def test_transfers_match_jax_and_are_adjoint(fine, coarse, keys):
    rng = np.random.default_rng(0)
    nc = len(keys)
    c = rng.normal(size=(nc, 6) + coarse)
    f = rng.normal(size=(nc, 6) + fine)
    Pj, Rj = jmg.make_transfers(fine, coarse, keys)
    Pt, Rt = tmg.make_transfers(fine, coarse, keys, dtype=torch.float64,
                                device="cpu")
    pc, rf = Pt(torch.tensor(c)), Rt(torch.tensor(f))
    assert _rel(Pj(jnp.asarray(c)), pc.numpy()) <= TOL
    assert _rel(Rj(jnp.asarray(f)), rf.numpy()) <= TOL
    lhs = float(torch.sum(pc * torch.tensor(f)))
    rhs = float(torch.sum(torch.tensor(c) * rf))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_radius_restrictor_matches_jax():
    rng = np.random.default_rng(1)
    valid = rng.random((5, 4, 3)) > 0.2
    rj = jmg.make_radius_restrictor(valid)
    rt = tmg.make_radius_restrictor(valid, device="cpu")
    for shape in ((5, 4, 3), (3, 5, 4, 3)):
        r = rng.uniform(0.03, 0.08, shape)
        assert _rel(rj(jnp.asarray(r)), rt(torch.tensor(r)).numpy()) <= TOL
    np.testing.assert_array_equal(tmg._coarse_cell_valid(valid),
                                  jmg._coarse_cell_valid(valid))


def _problem(geom, n):
    js = JSL(geom, (n, n, n), (1.0, 1.0, 1.0), 1013.0, 0.3,
             dtype=jnp.float64)
    ts = TSL(geom, (n, n, n), (1.0, 1.0, 1.0), 1013.0, 0.3,
             dtype=torch.float64, device="cpu")
    fixed = js.select_nodes(lambda x, y, z: z == 0.0)
    free = js.node_valid & ~fixed
    return js, ts, free


@pytest.fixture(scope="module")
def bcc4():
    js, ts, free = _problem("BCC", 4)
    hj = jmg.build_mg_hierarchy(js, free)
    ht = tmg.build_mg_hierarchy(ts, free)
    r = np.random.default_rng(2).uniform(0.03, 0.08, (4, 4, 4))
    with jax.disable_jit():
        sj = jmg.mg_precond_state(hj, jnp.asarray(r), power_iters=5)
    return js, ts, free, hj, ht, r, sj


def test_hierarchy_matches_jax(bcc4):
    _js, _ts, _free, hj, ht, _r, _sj = bcc4
    assert len(ht["levels"]) == len(hj["levels"]) >= 2
    for lj, lt in zip(hj["levels"], ht["levels"]):
        assert lt.slat.num_cells == lj.slat.num_cells
        np.testing.assert_array_equal(lt.free.numpy(), np.asarray(lj.free))


def test_precond_state_and_vcycle_match_jax(bcc4):
    js, ts, _free, hj, ht, r, sj = bcc4
    st = tmg.mg_precond_state(ht, torch.tensor(r), power_iters=5)
    for key in ("radii", "auxs", "Ds", "lmaxs"):
        for a, b in zip(sj[key], st[key]):
            assert _rel(a, b.numpy()) <= TOL, key

    # the same (JAX) state drives both V-cycles
    tree = jax.tree_util.tree_map(np.asarray, sj)
    st_j = convert.precond_state_from_jax(tree, device="cpu")
    v = np.random.default_rng(3).standard_normal((js.nc, 6) + js.grid)
    v *= np.asarray(hj["levels"][0].free)
    with jax.disable_jit():
        mj = np.asarray(jmg.mg_apply(hj, sj, **OPTS)(jnp.asarray(v)))
    mt = tmg.mg_apply(ht, st_j, **OPTS)(torch.tensor(v)).numpy()
    assert np.abs(mj).max() > 0
    assert _rel(mj, mt) <= 1e-11


def test_mg_preconditioner_matches_jax(bcc4):
    """``mg_preconditioner``: the state from the radii, then the V-cycle,
    in one call, as the JAX package's."""
    js, _ts, _free, hj, ht, r, _sj = bcc4
    v = np.random.default_rng(8).standard_normal((js.nc, 6) + js.grid)
    v *= np.asarray(hj["levels"][0].free)
    with jax.disable_jit():
        mj = np.asarray(jmg.mg_preconditioner(hj, jnp.asarray(r),
                                              power_iters=5, **OPTS)(
            jnp.asarray(v)))
    mt = tmg.mg_preconditioner(ht, torch.tensor(r), power_iters=5,
                               **OPTS)(torch.tensor(v)).numpy()
    assert np.abs(mj).max() > 0
    assert _rel(mj, mt) <= 1e-11


@pytest.mark.parametrize("nu", [1, (1, 2)])
def test_vcycle_is_symmetric_positive(bcc4, nu):
    _js, ts, free, _hj, ht, r, _sj = bcc4
    st = tmg.mg_precond_state(ht, torch.tensor(r), power_iters=5)
    M = tmg.mg_apply(ht, st, nu=nu, coarse_degree=8)
    rng = np.random.default_rng(4)
    shape = (ts.nc, 6) + ts.grid
    mask = np.broadcast_to(free[:, None], shape)
    a = torch.tensor(rng.normal(size=shape) * mask)
    b = torch.tensor(rng.normal(size=shape) * mask)
    lhs = float(torch.sum(M(a) * b))
    rhs = float(torch.sum(a * M(b)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)
    assert float(torch.sum(a * M(a))) > 0


def test_unported_smoothers_raise(bcc4, monkeypatch):
    """A fused request that the state cannot meet (float64: no level has a
    fused smoother) raises instead of running the unfused V-cycle, with
    the fused V-cycle's bf16 arithmetic asked for too (it is ported, and
    the request still has no fused level to run it on).  A bf16-I/O
    request smooths each level without bf16 operands with B1, as JAX
    smooths it with its gather form: at float64 no level has them, so it
    is the full-precision V-cycle."""
    _js, ts, _free, _hj, ht, r, _sj = bcc4
    st = tmg.mg_precond_state(ht, torch.tensor(r), power_iters=1)
    with pytest.raises(RuntimeError, match="fall back"):
        tmg.mg_apply(ht, st, fused=True)
    assert st["auxs_lo"] == [None] * len(st["Ds"])
    v = torch.tensor(np.random.default_rng(6).standard_normal(
        (ts.nc, 6) + ts.grid)) * ht["levels"][0].free
    assert torch.equal(tmg.mg_apply(ht, st, lo_smoother=True)(v),
                       tmg.mg_apply(ht, st, lo_smoother=False)(v))
    st_f = tmg.mg_precond_state(ht, torch.tensor(r), power_iters=1,
                                fused=True)
    assert st_f["fused"] == [None] * len(st_f["Ds"])
    monkeypatch.setenv("PLDSO_MG_FUSED_COMPUTE", "bf16")
    with pytest.raises(RuntimeError, match="fall back"):
        tmg.mg_apply(ht, st_f, fused=True)
