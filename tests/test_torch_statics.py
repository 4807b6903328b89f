"""The port's full-lattice statics and its framework-free copies against
the JAX package, in float64 on the CPU:

* ``subdivide_edges``, ``segment_counts``, ``penalize_edges`` (with its
  L-zones and their coefficients) and ``boundary_node_order``: arrays
  equal to JAX's;
* ``StaticProblem.solve`` and ``solve_fem`` on ``tests/test_fem_solve.py``'s
  cases (the cantilever, the axial bar, the dense cross-check, config BCs,
  the force split, subdivision) within 1e-10 (relative to the largest
  entry), and ``make_problem(penalization=True)``;
* the differentiable solve's gradient against JAX's ``jax.grad``;
* a CUDA request without a card raises.

Every case builds its lattice in both packages from one config and first
asserts that the arrays are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu import build_lattice as jax_build
from pylatticedso_tpu.fem import bc as jbc_mod
from pylatticedso_tpu.fem import statics as jst
from pylatticedso_tpu.fem import subdivide as jsub
from pylatticedso_tpu.sim import boundary_order as jbo
from pylatticedso_tpu.sim import penalization as jpen

from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.fem import bc as tbc_mod
from pylatticedso_tpu_torch.fem import statics as tst
from pylatticedso_tpu_torch.fem import subdivide as tsub
from pylatticedso_tpu_torch.sim import boundary_order as tbo
from pylatticedso_tpu_torch.sim import penalization as tpen

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

SOLVE_TOL = 1e-10
E_MOD, NU = 1013.0, 0.3
CLAMP = {"Surface": ["Xmin"], "DOF": ["X", "Y", "Z", "RX", "RY", "RZ"],
         "Value": [0, 0, 0, 0, 0, 0]}


def geometry(n, geom="BCC", r=0.08):
    return {"cell_size": {"x": 1, "y": 1, "z": 1},
            "number_of_cells": dict(zip("xyz", n)),
            "radii": [r], "geom_types": [geom]}


def both(cfg):
    jl, tl = jax_build(cfg), build_lattice(cfg)
    for name in ("nodes", "edges", "radius", "node_tag", "cell_edge_idx",
                 "cell_node_idx"):
        assert np.array_equal(getattr(jl, name), getattr(tl, name)), name
    return jl, tl


def rel(got, want):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-300))


def assert_equal_results(got, want):
    """Two FEMResults: fields within the solve tolerance.  (Their CG counts
    are not compared: at the tolerances of these cases, 1e-13 and 1e-14,
    CG runs at the rounding floor, where the last residual tests fall
    either side of the threshold.)"""
    for name in ("u", "reaction"):
        assert rel(getattr(got, name), getattr(want, name)) <= SOLVE_TOL, name
    for name in ("compliance", "energy"):
        assert abs(getattr(got, name) - getattr(want, name)) <= \
            SOLVE_TOL * abs(getattr(want, name)), name


# ---------------------------------------------------------------- copies
def test_subdivide_structure_equal():
    nodes = np.array([[0., 0., 0.], [1., 0., 0.], [1., 1., 0.]])
    edges = np.array([[0, 1], [1, 2]], dtype=np.int32)
    rad = np.array([0.1, 0.2])
    got = tsub.subdivide_edges(nodes, edges, n_segments=np.array([3, 1]),
                               edge_data=(rad,))
    want = jsub.subdivide_edges(nodes, edges, n_segments=np.array([3, 1]),
                                edge_data=(rad,))
    for a, b in zip(got, want):
        assert np.array_equal(a, b) and a.dtype == b.dtype


@pytest.mark.parametrize("h", [0.05, 0.3])
def test_subdivide_lattice_equal(h):
    jl, tl = both({"geometry": geometry((2, 1, 1), "Octet", 0.05)})
    lengths = np.linalg.norm(tl.nodes[tl.edges[:, 1]]
                             - tl.nodes[tl.edges[:, 0]], axis=1)
    assert np.array_equal(tsub.segment_counts(lengths, h),
                          jsub.segment_counts(lengths, h))
    got = tsub.subdivide_edges(tl.nodes, tl.edges, h, edge_data=(tl.radius,))
    want = jsub.subdivide_edges(jl.nodes, jl.edges, h, edge_data=(jl.radius,))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        tsub.subdivide_edges(tl.nodes, tl.edges)


@pytest.mark.parametrize("periodicity", [False, True])
def test_penalization_equal(periodicity):
    jl, tl = both({"geometry": geometry((2, 2, 1), "BCC", 0.05)})
    got = tpen.penalize_edges(tl.nodes, tl.edges, tl.radius,
                              periodicity=periodicity)
    want = jpen.penalize_edges(jl.nodes, jl.edges, jl.radius,
                               periodicity=periodicity)
    for name in ("nodes", "edges", "radius", "parent_edge", "penalized",
                 "l_zones"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    et = tl.edge_type
    for a, b in zip(tpen.lzone_coefficients(tl.nodes, tl.edges, et, 1,
                                            periodicity=periodicity),
                    jpen.lzone_coefficients(jl.nodes, jl.edges, et, 1,
                                            periodicity=periodicity)):
        assert np.array_equal(a, b)
    for a in (0.0, 30.0, 171.0):
        assert tpen.function_penalization_Lzone(0.05, a) == \
            jpen.function_penalization_Lzone(0.05, a)


@pytest.mark.parametrize("geom", ["BCC", "Octet"])
def test_boundary_order_equal(geom):
    jl, tl = both({"geometry": geometry((1, 1, 1), geom, 0.05)})
    bbox = [0, 1, 0, 1, 0, 1]
    assert np.array_equal(tbo.boundary_nodes_of_cell(tl.nodes, bbox),
                          jbo.boundary_nodes_of_cell(jl.nodes, bbox))
    got = tbo.boundary_node_order(tl.nodes, bbox)
    assert len(got) > 0
    assert np.array_equal(got, jbo.boundary_node_order(jl.nodes, bbox))


# ---------------------------------------------------------------- solves
def beam(n_elem, L=1.0, r=0.05, tip=(2, 0.01)):
    """Cantilever along x in both packages: a tip load on one DOF."""
    nodes = np.zeros((n_elem + 1, 3))
    nodes[:, 0] = np.linspace(0, L, n_elem + 1)
    edges = np.stack([np.arange(n_elem), np.arange(1, n_elem + 1)],
                     axis=1).astype(np.int32)
    radius = np.full(n_elem, r)
    N = n_elem + 1
    fixed = np.zeros((N, 6), dtype=bool); fixed[0] = True
    f = np.zeros((N, 6)); f[-1, tip[0]] = tip[1]
    args = (nodes, edges, radius, E_MOD, NU)
    jp = jst.StaticProblem(*args, jbc_mod.BCArrays(fixed, np.zeros((N, 6)), f),
                           N)
    tp = tst.StaticProblem(*args, tbc_mod.BCArrays(fixed, np.zeros((N, 6)), f),
                           N, device="cpu")
    return jp, tp


@pytest.mark.parametrize("n, tip", [(4, (2, 0.01)), (16, (2, 0.01)),
                                    (64, (2, 0.01)), (1, (0, 0.5)),
                                    (5, (0, 0.01))],
                         ids=["cantilever4", "cantilever16", "cantilever64",
                              "axial1", "subdivided5"])
def test_beam_solves_match(n, tip):
    jp, tp = beam(n, tip=tip)
    ju, jit, jres = jp.solve(tol=1e-14)
    u, it, res = tp.solve(tol=1e-14)
    assert u.dtype == torch.float64 and u.device.type == "cpu"
    assert rel(u, ju) <= SOLVE_TOL


def test_assigned_load_is_read():
    """A load set on the problem after construction (as the JAX tests do)
    enters the solve: the axial bar's exact answer."""
    jp, tp = beam(1, L=2.0, r=0.03, tip=(0, 0.0))
    f = np.zeros((2, 6)); f[-1, 0] = 0.5
    jp.f_applied, tp.f_applied = jnp.asarray(f), f
    u, _, _ = tp.solve(tol=1e-14)
    np.testing.assert_allclose(float(u[-1, 0]),
                               0.5 * 2.0 / (E_MOD * np.pi * 0.03**2),
                               rtol=1e-10)
    assert rel(u, jp.solve(tol=1e-14)[0]) <= SOLVE_TOL


def test_lattice_solve_matches_dense_and_jax():
    jl, tl = both({"geometry": geometry((2, 2, 2))})
    N = tl.num_nodes
    fixed = np.zeros((N, 6), dtype=bool)
    fixed[tl.nodes[:, 2] == 0.0] = True
    f = np.zeros((N, 6)); f[tl.nodes[:, 2] == 2.0, 2] = -0.01
    bc = tbc_mod.BCArrays(fixed, np.zeros((N, 6)), f)
    tp = tst.StaticProblem(tl.nodes, tl.edges, tl.radius, E_MOD, NU, bc, N,
                           device="cpu")
    jp = jst.StaticProblem(jl.nodes, jl.edges, jl.radius, E_MOD, NU,
                           jbc_mod.BCArrays(fixed, np.zeros((N, 6)), f), N)
    u, it, _ = tp.solve(tol=1e-13)
    ju, jit, _ = jp.solve(tol=1e-13)
    assert rel(u, ju) <= SOLVE_TOL
    # above the rounding floor the two CGs take the same iterations (this
    # symmetric lattice's residual falls from ~1e-3 to the floor in one
    # iteration, so the threshold must sit above the floor)
    assert tp.solve(tol=1e-6)[1] == int(jp.solve(tol=1e-6)[1])
    from pylatticedso_tpu_torch.fem import assemble_dense
    K = assemble_dense(tl.nodes, tl.edges, tl.radius, E_MOD, NU,
                       device="cpu").numpy()
    free = (~fixed).reshape(-1)
    u_ref = np.zeros(6 * N)
    u_ref[free] = np.linalg.solve(K[np.ix_(free, free)], f.reshape(-1)[free])
    np.testing.assert_allclose(u.numpy().reshape(-1), u_ref, rtol=1e-8,
                               atol=1e-12)


CONFIGS = {
    "config_bcs": {
        "geometry": geometry((2, 1, 1)),
        "simulation_parameters": {"enable": True, "material": "VeroClear"},
        "boundary_conditions": {"Displacement": {
            "Fixed": CLAMP,
            "Push": {"Surface": ["Xmax"], "DOF": ["X"], "Value": [-0.01]}}}},
    "force_split": {
        "geometry": geometry((2, 2, 2)),
        "boundary_conditions": {
            "Displacement": {"Fixed": {**CLAMP, "Surface": ["Zmin"]}},
            "Force": {"Load": {"Surface": ["Zmax"], "DOF": ["Z"],
                               "Value": [-0.9]}}}},
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
@pytest.mark.parametrize("subdivide_h", [None, 0.25])
def test_solve_fem_matches(case, subdivide_h):
    jl, tl = both(CONFIGS[case])
    jb, tb = jbc_mod.apply_boundary_conditions(jl), \
        tbc_mod.apply_boundary_conditions(tl)
    for name in ("fixed", "u_imposed", "f_applied"):
        assert np.array_equal(getattr(jb, name), getattr(tb, name))
    want = jst.solve_fem(jl, subdivide_h=subdivide_h, tol=1e-13)
    got = tst.solve_fem(tl, subdivide_h=subdivide_h, tol=1e-13,
                        device="cpu")
    assert got.u.shape == (tl.num_nodes, 6)
    assert_equal_results(got, want)
    if case == "config_bcs":
        np.testing.assert_allclose(got.u[tl.nodes[:, 0] == 2.0, 0], -0.01,
                                   atol=1e-12)
        np.testing.assert_allclose(got.energy, got.compliance / 2, rtol=1e-8)


def test_make_problem_penalized_matches():
    cfg = {**CONFIGS["force_split"], "geometry": geometry((2, 1, 1))}
    jl, tl = both(cfg)
    jp = jst.make_problem(jl, penalization=True)
    tp = tst.make_problem(tl, penalization=True, device="cpu")
    assert np.array_equal(tp.op.edges.numpy(), np.asarray(jp.op.edges))
    assert rel(tp.op.D, jp.op.D) <= 1e-15
    assert tp.op.n_nodes > tl.num_nodes          # zone points appended
    ju, jit, _ = jp.solve(tol=1e-13)
    u, it, _ = tp.solve(tol=1e-13)
    assert rel(u, ju) <= SOLVE_TOL
    got = tst.solve_fem(tl, penalization=True, tol=1e-13, device="cpu")
    assert_equal_results(got, jst.solve_fem(jl, penalization=True, tol=1e-13))


def test_differentiable_solve_gradient_matches():
    """d(compliance)/d(radius) through ``solve(differentiable=True)``
    (``custom_linear_solve``) against ``jax.grad`` of the same solve."""
    jl, tl = both({"geometry": geometry((1, 1, 1))})
    N = tl.num_nodes
    fixed = np.zeros((N, 6), dtype=bool); fixed[tl.nodes[:, 2] == 0.0] = True
    f = np.zeros((N, 6)); f[tl.nodes[:, 2] == 1.0, 2] = -0.01

    def jax_c(r):
        p = jst.StaticProblem(jl.nodes, jl.edges, r, E_MOD, NU,
                              jbc_mod.BCArrays(fixed, np.zeros((N, 6)), f), N)
        u, _, _ = p.solve(tol=1e-14, maxiter=500, differentiable=True)
        return jnp.sum(p.f_applied * u)

    r0 = np.full(tl.num_edges, 0.08)
    jc, jg = jax.value_and_grad(jax_c)(jnp.asarray(r0))
    r = torch.tensor(r0, requires_grad=True)
    p = tst.StaticProblem(tl.nodes, tl.edges, r, E_MOD, NU,
                          tbc_mod.BCArrays(fixed, np.zeros((N, 6)), f), N,
                          device="cpu")
    u, it, res = p.solve(tol=1e-14, maxiter=500, differentiable=True)
    assert it == -1 and torch.isnan(res)
    c = torch.sum(p.f_applied * u)
    g, = torch.autograd.grad(c, r)
    assert rel(c, jc) <= SOLVE_TOL and rel(g, jg) <= SOLVE_TOL


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs none")
    tl = build_lattice(CONFIGS["config_bcs"])
    with pytest.raises(RuntimeError, match="cuda"):
        tst.solve_fem(tl)
