"""The port's surrogate-DDM optimizer (``opti.ddm_optimizer``) against the
JAX package's, in float64 on the CPU, on ``tests/test_ddm_optimizer.py``'s
cantilever (2x1x1 BCC, surrogate grid step 0.02, target_h 0.3) and trimmed
(3x3x3 BCC clipped by an octahedron, per-topology surrogates at step 0.04)
fixtures:

* ``build_schur_surrogate``: the grid, the cache name and schema, the basis
  within 1e-9 of JAX's (the chained condensation differs in its last bits);
* objective and gradient within 1e-9 / 1e-7 (of max |g|) of JAX's on each
  solve branch: plain float64 CG, the dense refined route (``refined``
  forced on) and the matrix-free refined route (forced by lowering
  ``DENSE_MAX_DOF``, against JAX's dense refined values); the cold value
  and gradient the SLSQP driver asks for; the same bits on repeat;
* ``_topology_groups``: the groups and sha1 tags equal to JAX's (the tags
  name the cache files);
* a non-positive compliance is NaN, and a failing dense factor gives NaN;
* ``optimize_lattice`` with ``"DDM"`` takes the robust drive.

Every case builds its lattice in both packages from one config and first
asserts that the arrays are equal.  Surrogate training runs with both
packages under the test's temporary working directory.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu import build_lattice as jax_build
from pylatticedso_tpu.design.mesh_trimmer import MeshTrimmer as JaxTrimmer
from pylatticedso_tpu.materials import MatProperties as JaxMat
from pylatticedso_tpu.opti import ddm_optimizer as jdo

from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.design.mesh_trimmer import MeshTrimmer
from pylatticedso_tpu_torch.materials import MatProperties
from pylatticedso_tpu_torch.opti import ddm_optimizer as tdo
from pylatticedso_tpu_torch.opti import optimize_lattice
from pylatticedso_tpu_torch.opti.density import KrigingDensity

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
BCC_FIT = ROOT / "data/outputs/density_datasets/BCC_0.01_0.1_10.gpr.npz"
ARRAYS = ("nodes", "edges", "radius", "edge_type", "cell_edge_idx",
          "cell_node_idx", "cell_radii", "node_tag")
CLAMP = {"DOF": ["X", "Y", "Z", "RX", "RY", "RZ"], "Value": [0] * 6}
OBJ_TOL, GRAD_TOL = 1e-9, 1e-7
PROBLEM = dict(opt_params={"type": "unit_cell"}, constraints={},
               cg_tol=1e-11, cg_maxiter=2000, min_radius=0.02, spd_shift=0.0)


def cantilever_config(nx=2):
    return {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                         "number_of_cells": {"x": nx, "y": 1, "z": 1},
                         "radii": [0.05], "geom_types": ["BCC"]},
            "simulation_parameters": {"enable": True, "material": "VeroClear"},
            "boundary_conditions": {
                "Displacement": {"Fixed": {"Surface": ["Xmin"], **CLAMP}},
                "Force": {"Load": {"Surface": ["Xmax"], "DOF": ["Z"],
                                   "Value": [-0.1]}}}}


def trimmed_config():
    return {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                         "number_of_cells": {"x": 3, "y": 3, "z": 3},
                         "radii": [0.05], "geom_types": ["BCC"]},
            "simulation_parameters": {"enable": True, "material": "VeroClear"},
            "boundary_conditions": {
                "Displacement": {"Fixed": {"Surface": ["Zmin"], **CLAMP}},
                "Force": {"Load": {"Surface": ["Zmax"], "DOF": ["Z"],
                                   "Value": [-0.5]}}}}


def octahedron(center, R):
    c = np.asarray(center, float)
    vx = [c + R * np.asarray(v) for v in
          [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]]
    faces = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
             (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    return np.asarray([[vx[i], vx[j], vx[k]] for i, j, k in faces])


def both(cfg, trim=False):
    jl, tl = jax_build(cfg), build_lattice(cfg)
    if trim:
        JaxTrimmer(octahedron((1.5, 1.5, 1.5), 3.2)).trim_lattice(jl)
        MeshTrimmer(octahedron((1.5, 1.5, 1.5), 3.2)).trim_lattice(tl)
    for name in ARRAYS:
        assert np.array_equal(getattr(jl, name), getattr(tl, name)), name
    return jl, tl


def close(got, want):
    """(objective rel err, gradient err over max |g|)."""
    (v, g), (vj, gj) = got, want
    return (abs(v - vj) / abs(vj),
            float(np.abs(np.asarray(g) - np.asarray(gj)).max()
                  / np.abs(np.asarray(gj)).max()))


@pytest.fixture(scope="module")
def cantilever(tmp_path_factory):
    """Both packages' surrogates, trained in a temporary directory (JAX's
    cache write fails there and is swallowed; the port's lands there)."""
    mp = pytest.MonkeyPatch()
    mp.chdir(tmp_path_factory.mktemp("cantilever"))
    try:
        jl, tl = both(cantilever_config())
        jsur = jdo.build_schur_surrogate(jl, JaxMat("VeroClear"), 0.02, 0.1,
                                         step=0.02, target_h=0.3)
        tsur = tdo.build_schur_surrogate(tl, MatProperties("VeroClear"),
                                         0.02, 0.1, step=0.02, target_h=0.3,
                                         device="cpu")
    finally:
        mp.undo()
    return jl, tl, jsur, tsur


def test_surrogate_training_matches(cantilever, tmp_path, monkeypatch):
    jl, tl, jsur, tsur = cantilever
    assert np.array_equal(tsur.samples, jsur.samples)
    assert tsur.samples.shape == (5, 1) and tsur.basis.shape == jsur.basis.shape
    assert np.abs(tsur.basis - jsur.basis).max() < 1e-9
    assert np.abs(tsur.alpha - jsur.alpha).max() \
        < 1e-9 * np.abs(jsur.alpha).max()
    # the cache: the JAX package's name and schema, relative to the working
    # directory, written by one package and read by the other
    monkeypatch.chdir(tmp_path)
    cache = tmp_path / "data/outputs/schur_complement"
    cache.mkdir(parents=True)
    sur = tdo.build_schur_surrogate(tl, MatProperties("VeroClear"), 0.02, 0.1,
                                    step=0.02, target_h=0.3, device="cpu")
    (f,) = list(cache.iterdir())
    assert f.name == "rb_BCC_0.02_0.1_5_tol1e-06_shared.npz"
    assert np.array_equal(sur.basis, tsur.basis)
    back = jdo.build_schur_surrogate(jl, JaxMat("VeroClear"), 0.02, 0.1,
                                     step=0.02, target_h=0.3)
    assert np.array_equal(back.basis, sur.basis)
    f.unlink()
    jdo.build_schur_surrogate(jl, JaxMat("VeroClear"), 0.02, 0.1, step=0.02,
                              target_h=0.3)
    loaded = tdo.build_schur_surrogate(tl, MatProperties("VeroClear"), 0.02,
                                       0.1, step=0.02, target_h=0.3,
                                       device="cpu")
    assert np.array_equal(loaded.basis, np.load(f)["basis_reduced_ortho"])


def _problems(cantilever, branch, monkeypatch):
    jl, tl, jsur, tsur = cantilever
    if branch == "matrix_free":
        monkeypatch.setattr(tdo, "DENSE_MAX_DOF", 0)
    refined = branch != "plain"
    tp = tdo.DDMOptimizationProblem(tl, surrogate=tsur, refined=refined,
                                    device="cpu", **PROBLEM)
    jp = jdo.DDMOptimizationProblem(jl, surrogate=jsur, refined=refined,
                                    **PROBLEM)
    assert tp.refined == refined and (tp._dense is None) == (
        branch != "dense")
    return tp, jp


@pytest.mark.parametrize("branch", ["plain", "dense", "matrix_free"])
def test_value_and_gradient_match_jax(cantilever, branch, monkeypatch):
    tp, jp = _problems(cantilever, branch, monkeypatch)
    x0 = tp.param.x0
    x1 = np.clip(x0 + 0.1 * np.sin(np.arange(len(x0)) + 1.0), 0.0, 1.0)
    for x in (x0, x1):                    # cold, then from the warm start
        got = (tp.objective(x), tp.gradient(x))
        v_err, g_err = close(got, (jp.objective(x), jp.gradient(x)))
        assert v_err <= OBJ_TOL and g_err <= GRAD_TOL, (v_err, g_err)
    # the cold evaluation SLSQP's driver takes
    v, g = tp._value_and_grad(x1)
    vj, gj = jp._value_and_grad(jnp.asarray(x1))
    v_err, g_err = close((float(v), g.numpy()), (float(vj), gj))
    assert v_err <= OBJ_TOL and g_err <= GRAD_TOL, (v_err, g_err)
    # the same bits from the same theta and warm start
    u0 = tp._u_warm
    (va, ua), ga = tp._vg_aux(x0, u0)
    (vb, ub), gb = tp._vg_aux(x0, u0)
    assert torch.equal(va, vb) and torch.equal(ga, gb) and torch.equal(ua, ub)


def test_gradient_matches_central_difference(cantilever, monkeypatch):
    tp, _ = _problems(cantilever, "plain", monkeypatch)
    x0 = tp.param.x0
    g = tp.gradient(x0)
    h = 1e-5
    for k in range(tp.param.n_params):
        e = np.zeros_like(x0)
        e[k] = h
        fd = (tp.objective(x0 + e) - tp.objective(x0 - e)) / (2 * h)
        np.testing.assert_allclose(g[k], fd, rtol=1e-4)


@pytest.mark.parametrize("branch", ["plain", "dense"])
def test_indefinite_operator_is_nan(cantilever, branch):
    """A negated surrogate makes the interface operator negative definite:
    the plain CG converges to a negative compliance, which is NaN (as in
    JAX); the dense branch's f32 factor fails, which gives NaN too."""
    jl, tl, jsur, tsur = cantilever
    neg = tdo.SchurSurrogate(-tsur.basis, tsur.alpha, tsur.samples,
                             device="cpu")
    tp = tdo.DDMOptimizationProblem(tl, surrogate=neg, device="cpu",
                                    refined=branch == "dense", **PROBLEM)
    v, g = tp.objective(tp.param.x0), tp.gradient(tp.param.x0)
    assert np.isnan(v)
    if branch == "plain":
        assert np.isfinite(g).all()
        jneg = jdo.SchurSurrogate(-jsur.basis, jsur.alpha, jsur.samples)
        jp = jdo.DDMOptimizationProblem(jl, surrogate=jneg, **PROBLEM)
        assert np.isnan(jp.objective(jp.param.x0))
    else:
        # a positive definite trial afterwards factors again
        tp2 = tdo.DDMOptimizationProblem(tl, surrogate=tsur, device="cpu",
                                         refined=True, **PROBLEM)
        assert np.isfinite(tp2.objective(tp2.param.x0))


@pytest.fixture(scope="module")
def hetero(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.chdir(tmp_path_factory.mktemp("hetero"))
    try:
        jl, tl = both(trimmed_config(), trim=True)
        kw = dict(opt_params={"type": "unit_cell"}, constraints={},
                  cg_tol=1e-11, cg_maxiter=4000, min_radius=0.02,
                  grid_step=0.04, spd_shift=0.0, target_h=0.3)
        tp = tdo.DDMOptimizationProblem(tl, device="cpu", **kw)
        jp = jdo.DDMOptimizationProblem(jl, **kw)
    finally:
        mp.undo()
    return jl, tl, tp, jp


def test_topology_groups_and_tags_match(hetero):
    jl, tl, tp, _ = hetero
    got = tdo._topology_groups(tl)
    want = jdo._topology_groups(jl)
    assert np.array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]
    assert len(tp._groups) == len(got[1]) > 1 and tp._surrogate is None
    assert len({g.bn.shape[1] for g in tp._groups}) > 1
    with pytest.raises(ValueError, match="mixed-topology"):
        tdo.DDMOptimizationProblem(tl, surrogate=tdo.SchurSurrogate(
            np.eye(4), np.eye(4), np.eye(4)[:, :1], kind="nearest_neighbor",
            device="cpu"),
            device="cpu", **PROBLEM)


def test_hetero_value_and_gradient_match_jax(hetero):
    _, _, tp, jp = hetero
    rng = np.random.default_rng(3)
    x = np.clip(tp.param.x0 + rng.uniform(-0.1, 0.1, tp.param.n_params),
                0.0, 1.0)
    v_err, g_err = close((tp.objective(x), tp.gradient(x)),
                         (jp.objective(x), jp.gradient(x)))
    assert v_err <= OBJ_TOL and g_err <= GRAD_TOL, (v_err, g_err)


def test_optimize_lattice_takes_the_robust_drive(cantilever, monkeypatch):
    """``"DDM"`` with a density constraint: a feasible start under a move
    limit of 0.1, then ``slsqp_polish``; the result feasible and no worse
    than the start."""
    _, _, _, tsur = cantilever
    cfg = cantilever_config()
    cfg["optimization_informations"] = {
        "simulation_type": "DDM", "objective_type": "compliance",
        "optimization_parameters": {"type": "unit_cell"},
        "constraints": {"relative_density": {"value": 0.10,
                                             "mode": "upper"}},
        "max_iterations": 2}
    lat = build_lattice(cfg)
    calls = []
    real = tdo.DDMOptimizationProblem.optimize_slsqp

    def spy(self, **kw):
        calls.append(kw)
        return real(self, **kw)

    monkeypatch.setattr(tdo.DDMOptimizationProblem, "optimize_slsqp", spy)
    problem, res = optimize_lattice(
        lat, surrogate=tsur, density_model=KrigingDensity.load(BCC_FIT),
        device="cpu")
    assert isinstance(problem, tdo.DDMOptimizationProblem)
    assert calls[0] == {"max_iterations": 2, "ftol": 1e-6,
                        "feasible_start": True, "move_limit": 0.1}
    assert len(calls) >= 2 and calls[1] == {"max_iterations": 2,
                                            "ftol": 1e-6}
    start = problem.feasible_x0()
    assert np.isfinite(res.objective)
    assert res.objective <= problem.objective(start) * (1 + 1e-12)
    assert res.density <= 0.10 + 1e-6
