"""``shard_structured_step`` on 1 x 4, 2 x 4 and 1 x 2 meshes of CPU
devices against the port's one-device step (``step.value_and_grad``, the
implicit form JAX's wrapper runs) and, for one BCC Jacobi case, against
the JAX package's one-device step (``step._jitted``), in float64 at JAX's
tolerances (c 1e-10, g 1e-8; ``tests/test_sharding.py``):

* ``tests/test_sharding.py``'s Octet N=3 Jacobi and BCC N=7 multigrid
  cases (frozen and live multigrid state), u in slabs, the same bits on
  repeat, u taken back as ``u0``;
* a 1 x 2 mesh on which two levels run on slabs (the slab transfers), a
  Cubic+BCC hybrid, a warped lattice, a custom objective with an imposed
  displacement;
* the lo route in float32 (B2's plain version on the slabs) at 1e-5 /
  1e-4 (the fused V-cycle: ``test_torch_structured_mesh_fused.py``);
* the "divisible" refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu.parallel.structured import (
    StructuredLattice as JSL, make_structured_compliance_step as jstep)

from pylatticedso_tpu_torch.parallel.mesh import Sharded, make_mesh
from pylatticedso_tpu_torch.parallel.structured import (
    StructuredLattice, make_structured_compliance_step, shard_structured_step)

torch.set_num_threads(1)

C_TOL, G_TOL = 1e-10, 1e-8
MG = {"nu": 2, "coarse_degree": 8, "smooth_frac": 0.25, "power_iters": 5}


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _mesh(n_shard, n_dp=1):
    return make_mesh(n_shard=n_shard, n_dp=n_dp,
                     devices=["cpu"] * (n_shard * n_dp))


def _case(geom, cells, along="z", dtype=torch.float64, pkg=StructuredLattice,
          **kw):
    """test_sharding.py's loads: clamped at the low end of ``along``, -0.5
    (z: Octet N=3) or -0.1 (x: BCC N=7) on the high end."""
    ax = "xyz".index(along)
    extra = {"device": "cpu"} if pkg is StructuredLattice else {}
    sl = pkg(geom, cells, (1.0, 1.0, 1.0), 1013.0, 0.3, dtype=dtype,
             **extra, **kw)
    end = float(cells[ax])
    free = sl.select_nodes(lambda *p: p[ax] > 1e-9)
    f = sl.node_field().astype(np.float64)
    f[:, 2][sl.select_nodes(lambda *p: p[ax] > end - 1e-9)] = \
        -0.5 if along == "z" else -0.1
    return sl, free, f


def _check(step, sstep, r, ps=None, c_tol=C_TOL, g_tol=G_TOL):
    want = step.value_and_grad(r, torch.zeros_like(step.operands[1]), ps)
    got = sstep(r, None, ps)
    assert isinstance(got[2], Sharded) and got[2].dim == 2 + sstep.grid_axis
    assert len(got[2].parts) == sstep.mesh.shape["shard"]
    assert _rel(got[0], want[0]) <= c_tol
    assert _rel(got[1], want[1]) <= g_tol
    assert _rel(got[2].gather(), want[2]) <= c_tol * 100
    return got


@pytest.mark.parametrize("shape", [(4, 1), (4, 2)], ids=["1x4", "2x4"])
def test_octet_jacobi(shape):
    sl, free, f = _case("Octet", (3, 3, 3))
    step = make_structured_compliance_step(sl, free, f, tol=1e-10,
                                           maxiter=500, precond="jacobi")
    sstep = shard_structured_step(step, _mesh(*shape))
    assert sstep.grid_axis == 2          # JAX's rule: the last of the ties
    r = torch.full((3, 3, 3), 0.05, dtype=torch.float64)
    c1, g1, u1 = _check(step, sstep, r)
    c2, g2, u2 = sstep(r)
    assert torch.equal(c1, c2) and torch.equal(g1, g2) \
        and torch.equal(u1.gather(), u2.gather())
    # the slabs back as a warm start: the solve starts converged
    sstep(r, u1)
    assert sstep.last_solve["iterations"] <= 2


@pytest.mark.parametrize("shape", [(4, 1), (4, 2)], ids=["1x4", "2x4"])
def test_bcc_mg(shape):
    sl, free, f = _case("BCC", (7, 2, 2), along="x")
    step = make_structured_compliance_step(sl, free, f, tol=1e-10,
                                           maxiter=500, precond="mg",
                                           mg_opts=MG)
    sstep = shard_structured_step(step, _mesh(*shape))
    assert sstep.n_sharded_levels == 1
    r = torch.full((7, 2, 2), 0.05, dtype=torch.float64)
    ps = step.precond_state(r)
    _check(step, sstep, r, ps)
    _check(step, sstep, r)                   # the state built on the slabs
    # the slab power iteration's lmax against the one-device one's
    live = sstep.runner.precond_state(r)
    for a, b in zip(live["lmaxs"], ps["lmaxs"]):
        assert _rel(a, b) <= 1e-12


def test_two_sharded_levels():
    """1 x 2 on a 6-point grid: levels of 6 and 4 points on slabs (the
    slab transfers between them), the coarsest gathered."""
    sl, free, f = _case("BCC", (5, 2, 2), along="x")
    step = make_structured_compliance_step(
        sl, free, f, tol=1e-10, maxiter=500, precond="mg",
        mg_opts=dict(MG, coarse_degree=4))
    sstep = shard_structured_step(step, _mesh(2))
    assert [lvl.slat.grid[0] for lvl in step.hierarchy["levels"]] == [6, 4]
    assert sstep.n_sharded_levels == 2
    r = torch.full((5, 2, 2), 0.05, dtype=torch.float64)
    _check(step, sstep, r, step.precond_state(r))


def test_bcc_jacobi_against_jax():
    """The sharded port against JAX's one-device implicit step."""
    js, free, f = _case("BCC", (3, 2, 2), along="x", pkg=JSL,
                        dtype=jnp.float64)
    sl, _free, _f = _case("BCC", (3, 2, 2), along="x")
    kw = dict(tol=1e-10, maxiter=500, precond="jacobi")
    jst = jstep(js, free, f, **kw)
    step = make_structured_compliance_step(sl, free, f, **kw)
    r = np.full((3, 2, 2), 0.05)
    fj, ff = jst._operands
    (jc, ju), jg = jst._jitted(jnp.asarray(r), fj, ff, jnp.zeros_like(ff))
    sstep = shard_structured_step(step, _mesh(4, 2))
    c, g, u = sstep(torch.tensor(r))
    assert _rel(c, jc) <= C_TOL and _rel(g, jg) <= G_TOL
    assert _rel(u.gather(), ju) <= 1e-8


def test_hybrid_and_warped():
    for kw, shape in (({"geom": ["Cubic", "BCC"]}, (2, 3, 2, 2)),
                      ({"geom": "BCC", "node_transform": lambda x, y, z: (
                          x, y + 0.03 * x * z, z - 0.02 * x * x)},
                       (3, 2, 2))):
        geom = kw.pop("geom")
        sl, free, f = _case(geom, (3, 2, 2), along="x", **kw)
        step = make_structured_compliance_step(sl, free, f, tol=1e-10,
                                               maxiter=500, precond="mg",
                                               mg_opts=MG)
        sstep = shard_structured_step(step, _mesh(4))
        r = torch.full(shape, 0.05, dtype=torch.float64)
        _check(step, sstep, r, step.precond_state(r))


def test_custom_objective_with_imposed_displacement():
    sl, free, f = _case("BCC", (7, 2, 2), along="x")
    u_imp = np.zeros_like(f)
    u_imp[:, 0][sl.select_nodes(lambda x, y, z: x < 1e-9)] = 1e-3
    free_d = np.broadcast_to(free[:, None], f.shape).copy()
    free_d[:, 0][sl.select_nodes(lambda x, y, z: x < 1e-9)] = False
    obj = lambda u, f_: torch.sum(u[:, 2] * u[:, 2]) + torch.sum(f_ * u)
    step = make_structured_compliance_step(
        sl, free_d, f, u_imposed=u_imp, objective=obj, tol=1e-11,
        maxiter=500, precond="mg", mg_opts=MG)
    sstep = shard_structured_step(step, _mesh(4))
    r = torch.full((7, 2, 2), 0.05, dtype=torch.float64)
    _check(step, sstep, r, step.precond_state(r))


def test_lo_route(monkeypatch):
    """f32 on the lo route: B2's plain version on the fine level's slabs,
    against one device at 1e-5 / 1e-4."""
    sl, free, f = _case("BCC", (7, 2, 2), along="x", dtype=torch.float32)
    step = make_structured_compliance_step(
        sl, free, f, tol=1e-6, maxiter=500, precond="mg",
        mg_opts={"nu": (1, 1), "coarse_degree": 8, "power_iters": 3,
                 "fused": False, "lo_smoother": True})
    sstep = shard_structured_step(step, _mesh(4))
    assert sstep.n_sharded_levels == 1
    assert sstep.runner.slab_levels[0].slat.grid == sl.grid
    r = torch.full((7, 2, 2), 0.05, dtype=torch.float32)
    ps = step.precond_state(r)
    assert ps["auxs_lo"][0] is not None
    assert len(sstep.runner.slab_state(ps)["auxs_lo"][0].parts) == 4
    _check(step, sstep, r, ps, c_tol=1e-5, g_tol=1e-4)


def test_refusals():
    sl, free, f = _case("BCC", (2, 2, 2))
    step = make_structured_compliance_step(sl, free, f, tol=1e-8,
                                           maxiter=50, precond="jacobi")
    with pytest.raises(ValueError, match="divisible"):
        shard_structured_step(step, _mesh(4, 2))
    with pytest.raises(ValueError, match="divisible"):
        shard_structured_step(step, _mesh(2), grid_axis=0)
