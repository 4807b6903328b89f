"""Port parity: the warped compliance step, its multigrid, the warped
optimizer and ``shard_structured_step`` against the JAX package, in
float64 on the CPU.

A 4x2x2 BCC cantilever warped by a map that keeps x (so the clamped Xmin
face and the loaded Xmax face stay planes): the step's c, g and u against
JAX's, Jacobi and multigrid, at 1e-10; its implicit and self-adjoint
gradients and ``step.batch`` against the analytic one; the warped V-cycle
against JAX's ``mg_apply`` on the same state (1e-11); the fused route's
refusal naming the warp.  The optimizer on
``tests/test_structured_optimizer.py``'s curved, cylinder-draped
cantilever (BCC here: one JAX compile of seconds, where Octet's takes a
minute) against JAX's ``StructuredOptimizationProblem`` and the port's
unstructured problem (1e-9 / 1e-7, that test's bounds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu import build_lattice as jax_build
from pylatticedso_tpu.design import transforms as jtf
from pylatticedso_tpu.opti.structured_optimizer import \
    StructuredOptimizationProblem as JaxStructured
from pylatticedso_tpu.parallel import multigrid as jmg
from pylatticedso_tpu.parallel.structured import (
    StructuredLattice as JSL, make_structured_compliance_step as jstep)

from pylatticedso_tpu_torch import convert
from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.design import transforms as ttf
from pylatticedso_tpu_torch.opti.optimizer import OptimizationProblem
from pylatticedso_tpu_torch.opti.structured_optimizer import \
    StructuredOptimizationProblem
from pylatticedso_tpu_torch.parallel import multigrid as tmg
from pylatticedso_tpu_torch.parallel.sharding import make_mesh
from pylatticedso_tpu_torch.parallel.structured import (
    StructuredLattice as TSL, make_structured_compliance_step as tstep,
    shard_structured_step)

from test_torch_opti_fem import CON, OPT, cantilever, models, rel

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

N = (4, 2, 2)
TOL = 1e-10
MG_OPTS = {"nu": (1, 2), "coarse_degree": 24, "smooth_frac": 0.35,
           "power_iters": 5}


def sag(x, y, z):
    """A warp that keeps x: every instance gets its own frame and length."""
    return (x, y + 0.03 * x * z + 0.02 * np.sin(z),
            z - 0.02 * x * x + 0.05 * np.sin(y + 0.5 * x))


def _problem(pkg_sl, dtype):
    sl = pkg_sl("BCC", N, (1.0, 1.0, 1.0), 1013.0, 0.3, dtype=dtype,
                node_transform=sag,
                **({"device": "cpu"} if pkg_sl is TSL else {}))
    fixed = sl.select_nodes(lambda x, y, z: x == 0.0)
    tip = sl.select_nodes(lambda x, y, z: x == float(N[0]))
    free = sl.node_valid & ~fixed
    f = np.zeros((sl.nc, 6) + sl.grid)
    for c in range(sl.nc):
        f[c, 2][tip[c]] = -0.1 / int(tip.sum())
    return sl, free, f


def _steps(precond, **kw):
    js, free, f = _problem(JSL, jnp.float64)
    ts, _free, _f = _problem(TSL, torch.float64)
    opts = dict(tol=1e-10, maxiter=3000, precond=precond,
                mg_opts=MG_OPTS if precond == "mg" else None, **kw)
    return jstep(js, free, f, **opts), tstep(ts, free, f, **opts)


def _radius(seed):
    return np.random.default_rng(seed).uniform(0.03, 0.08, N)


def _close(jax_out, port_out, tol=TOL):
    for name, a, b in zip("cgu", jax_out, port_out):
        a, b = np.asarray(a), b.detach().numpy()
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err <= tol, f"{name}: {err:.3e}"


@pytest.mark.parametrize("precond", ["jacobi", "mg"])
def test_warped_step_matches_jax(precond):
    js, ts = _steps(precond)
    assert ts.grad_form == "analytic"
    r = _radius(1)
    out_j = js(jnp.asarray(r))
    out_t = ts(torch.tensor(r))
    _close(out_j, out_t)
    # warm start, and on the multigrid a frozen state
    r2 = r * 1.01
    if precond == "mg":
        out_j2 = js(jnp.asarray(r2), out_j[2], js.precond_state(
            jnp.asarray(r)))
        out_t2 = ts(torch.tensor(r2), out_t[2], ts.precond_state(
            torch.tensor(r)))
    else:
        out_j2 = js(jnp.asarray(r2), out_j[2])
        out_t2 = ts(torch.tensor(r2), out_t[2])
    _close(out_j2, out_t2)


def test_warped_step_gradient_forms_and_batch(monkeypatch):
    """The implicit and self-adjoint gradients of the warped step agree
    with the analytic one (each solve at tol 1e-10); ``step.batch`` gives
    the bits of one implicit value-and-gradient per candidate."""
    ts, free, f = _problem(TSL, torch.float64)
    kw = dict(tol=1e-10, maxiter=3000)
    r = torch.tensor(_radius(2))
    c_a, g_a, _u = tstep(ts, free, f, **kw)(r)
    monkeypatch.setenv("PLDSO_GRAD", "implicit")
    st_i = tstep(ts, free, f, **kw)
    assert st_i.grad_form == "implicit"
    c_i, g_i, _u = st_i(r)
    monkeypatch.delenv("PLDSO_GRAD")
    monkeypatch.setenv("PLDSO_SELFADJOINT", "1")
    st_s = tstep(ts, free, f, **kw)
    assert st_s.grad_form == "selfadjoint"
    c_s, g_s, _u = st_s(r)
    for c, g in ((c_i, g_i), (c_s, g_s)):
        assert abs(float(c - c_a)) <= 1e-10 * abs(float(c_a))
        assert rel(g.numpy(), g_a.numpy()) <= 1e-7
    rs = torch.stack([r, r * 0.9])
    cb, gb = st_s.batch(rs)
    for k in range(2):
        c1, g1, _u1 = st_s.value_and_grad(rs[k], torch.zeros_like(
            st_s.operands[1]))
        assert torch.equal(cb[k], c1) and torch.equal(gb[k], g1)


@pytest.fixture(scope="module")
def warped_mg():
    js, free, _f = _problem(JSL, jnp.float64)
    ts, _free, _f = _problem(TSL, torch.float64)
    hj = jmg.build_mg_hierarchy(js, free)
    ht = tmg.build_mg_hierarchy(ts, free)
    r = _radius(3)
    with jax.disable_jit():
        sj = jmg.mg_precond_state(hj, jnp.asarray(r), power_iters=5)
    return js, hj, ht, r, sj


def test_warped_vcycle_matches_jax(warped_mg):
    js, hj, ht, r, sj = warped_mg
    assert len(ht["levels"]) == len(hj["levels"]) >= 2
    for lj, lt in zip(hj["levels"], ht["levels"]):
        assert lt.slat.node_transform is sag
        np.testing.assert_array_equal(lt.free.numpy(), np.asarray(lj.free))
    st = tmg.mg_precond_state(ht, torch.tensor(r), power_iters=5)
    for key in ("radii", "auxs", "Ds", "lmaxs"):
        for a, b in zip(sj[key], st[key]):
            assert rel(b.numpy(), a) <= 1e-12, key
    st_j = convert.precond_state_from_jax(
        jax.tree_util.tree_map(np.asarray, sj), device="cpu")
    v = np.random.default_rng(4).standard_normal((js.nc, 6) + js.grid)
    v *= np.asarray(hj["levels"][0].free)
    opts = {k: v_ for k, v_ in MG_OPTS.items() if k != "power_iters"}
    with jax.disable_jit():
        mj = np.asarray(jmg.mg_apply(hj, sj, **opts)(jnp.asarray(v)))
    mt = tmg.mg_apply(ht, st_j, **opts)(torch.tensor(v)).numpy()
    assert np.abs(mj).max() > 0
    assert rel(mt, mj) <= 1e-11


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_warped_levels_have_no_b2_or_fused_smoother(dtype):
    """Every level of a warped hierarchy runs B1w (JAX: its gather form):
    no bf16-I/O matvec, no fused smoother, and a fused request raises with
    the warp named (JAX warns and runs unfused)."""
    ts, free, f = _problem(TSL, dtype)
    step = tstep(ts, free, f, tol=1e-6, maxiter=200, precond="mg",
                 mg_opts=dict(MG_OPTS, fused=True))
    levels = step.hierarchy["levels"]
    assert len(levels) >= 2
    for lvl in levels:
        assert lvl.matvec.apply.warped and not lvl.has_lo
        assert not lvl.fused.ok
    st = tmg.mg_precond_state(step.hierarchy, torch.full(N, 0.05,
                                                         dtype=dtype),
                              power_iters=2, fused=True)
    assert st["auxs_lo"] == [None] * len(levels)
    with pytest.raises(RuntimeError, match=r"warped \(node_transform\)"):
        step(torch.full(N, 0.05, dtype=dtype))


def _warped_cantilever(build, tf):
    lat = build(cantilever((3, 2, 2), ["BCC"], [0.05]))
    tf.curve_lattice(lat, center=(1.5, 1.0, 5.0), curvature_strength=0.02)
    tf.move_to_cylinder_form(lat, radius=4.0)
    assert len(lat.node_transforms) == 2
    return lat


def test_warped_optimizer_matches_jax_and_unstructured():
    jm, tm = models("BCC")
    jp = JaxStructured(_warped_cantilever(jax_build, jtf), opt_params=OPT,
                       constraints=CON, density_model=jm)
    lat = _warped_cantilever(build_lattice, ttf)
    tp = StructuredOptimizationProblem(lat, opt_params=OPT, constraints=CON,
                                       density_model=tm, device="cpu")
    up = OptimizationProblem(lat, opt_params=OPT, constraints=CON,
                             density_model=tm, device="cpu")
    assert tp._slat.node_transform is not None
    assert tp._node_map == [tuple([c, tuple(int(i) for i in g)])
                            for c, g in jp._node_map]
    x0 = np.asarray(tp.param.x0) * 0.9 + 0.03
    vj, gj = jp._value_and_grad(jnp.asarray(x0))
    vt, gt = tp._value_and_grad(x0)
    vu, gu = up._value_and_grad(x0)
    for v, g in ((float(vj), np.asarray(gj)), (float(vu), gu.numpy())):
        np.testing.assert_allclose(float(vt), v, rtol=1e-9)
        np.testing.assert_allclose(gt.numpy(), g, rtol=1e-7)


def test_shard_structured_step_on_one_device(monkeypatch):
    """On a one-device mesh the sharded step runs JAX's wrapper's form
    (the implicit value and gradient) with the bits of
    ``step.value_and_grad``, and of the step itself when that is its form
    (u as one slab); JAX's grid-axis rule.  On a 1 x 5 mesh (slabs of one
    plane, both ghost layers a neighbour's) the warped step (B1w per slab
    on the card) within 1e-10 / 1e-8 of the one-device step, and a mesh
    axis that divides no grid axis refused."""
    ts, free, f = _problem(TSL, torch.float64)
    monkeypatch.setenv("PLDSO_GRAD", "implicit")
    # a cheap V-cycle: the sharded step's bits, not the solver, are under
    # test
    step = tstep(ts, free, f, tol=1e-8, maxiter=3000, precond="mg",
                 mg_opts={"nu": 1, "coarse_degree": 4, "power_iters": 2})
    mesh = make_mesh(devices=["cpu"])
    sstep = shard_structured_step(step, mesh)
    assert sstep.mesh is mesh
    assert sstep.grid_axis == int(np.argmax(ts.grid))
    assert shard_structured_step(step, mesh, grid_axis=2).grid_axis == 2
    r = torch.tensor(_radius(5))
    zeros = torch.zeros_like(step.operands[1])
    five = shard_structured_step(step, make_mesh(n_shard=5,
                                                 devices=["cpu"] * 5))
    assert five.grid_axis == 0 and five.n_sharded_levels == 1
    for ps in (None, step.precond_state(r)):
        got = sstep(r, None, ps)
        want = step.value_and_grad(r, zeros, ps)
        own = step(r, None, ps)
        assert len(got[2].parts) == 1
        got = (got[0], got[1], got[2].gather())
        for a, b, c in zip(got, want, own):
            assert torch.equal(a, b) and torch.equal(a, c)
        c5, g5, u5 = five(r, None, ps)
        assert [p.shape[2] for p in u5.parts] == [1] * 5
        assert abs(float(c5 - want[0])) <= 1e-10 * abs(float(want[0]))
        assert rel(g5, want[1]) <= 1e-8
        assert rel(u5.gather(), want[2]) <= 1e-10
    two = make_mesh(n_shard=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="divisible"):
        shard_structured_step(step, two)
