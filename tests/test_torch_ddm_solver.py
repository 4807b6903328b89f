"""The port's DDM interface solver (``ddm.solver``) against the JAX
package's, in float64 on the CPU, on ``tests/test_ddm_solver.py``'s cases:

* the interface operator built from the same Schur groups: ``matvec``,
  ``diagonal``, ``node_blocks``, every preconditioner and the high-precision
  operator within 1e-12 (relative to the largest entry); the per-group Schur
  complements of ``build_ddm_system`` within 1e-12 of JAX's;
* ``solve_ddm``: u, reaction and compliance within 1e-10 of JAX's, and the
  interface u and the compliance within 1e-8 of the port's ``solve_fem``
  on the same penalized, subdivided lattice (the reference's own oracle,
  compare_FEM_DDM.py:36-37), for a pushed and a loaded lattice;
* grouping by radius, the mesh-trimmed heterogeneous lattice, and the
  refined float32 solve reaching float64 accuracy where a plain float32
  solve cannot.

Every case builds its lattice in both packages from one config and first
asserts that the arrays are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu import build_lattice as jax_build
from pylatticedso_tpu.ddm import solver as jsv
from pylatticedso_tpu.design.mesh_trimmer import MeshTrimmer as JaxTrimmer

from pylatticedso_tpu_torch.ddm import solver as tsv
from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.design.mesh_trimmer import MeshTrimmer
from pylatticedso_tpu_torch.fem.bc import apply_boundary_conditions
from pylatticedso_tpu_torch.fem.statics import solve_fem

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

ARRAYS = ("nodes", "edges", "radius", "edge_type", "cell_edge_idx",
          "cell_node_idx", "cell_radii", "node_tag")
CLAMP = {"DOF": ["X", "Y", "Z", "RX", "RY", "RZ"], "Value": [0] * 6}


def lattice_config(geom="BCC", n=(2, 2, 2), r=0.08, force=False):
    bc = {"Displacement": {"Fixed": {"Surface": ["Zmin"], **CLAMP}}}
    if force:
        bc["Force"] = {"Load": {"Surface": ["Zmax"], "DOF": ["Z"],
                                "Value": [-0.5]}}
    else:
        bc["Displacement"]["Push"] = {"Surface": ["Zmax"], "DOF": ["Z"],
                                      "Value": [-0.01]}
    return {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                         "number_of_cells": dict(zip("xyz", n)),
                         "radii": [r], "geom_types": [geom]},
            "simulation_parameters": {
                "enable": True, "material": "VeroClear", "periodicity": False,
                "DDM": {"enable_preconditioner": True,
                        "preconditioner_type": "mean",
                        "max_iterations": 2000,
                        "schur_complement_computation": {"type": "exact"}}},
            "boundary_conditions": bc}


GRADED = {
    "geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                 "number_of_cells": {"x": 3, "y": 1, "z": 1},
                 "radii": [0.06], "geom_types": ["BCC"]},
    "gradient": {"radii": {"rule": "linear", "direction_x": True,
                           "parameter_x": 0.3}},
    "simulation_parameters": {"enable": True, "material": "VeroClear"},
    "boundary_conditions": {"Displacement": {
        "Fixed": {"Surface": ["Xmin"], **CLAMP},
        "Push": {"Surface": ["Xmax"], "DOF": ["X"], "Value": [0.01]}}}}


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
        # the asymmetric clip of test_ddm_solver's heterogeneous case:
        # cells with 4/6/8 boundary nodes
        JaxTrimmer(octahedron((1.5, 1.5, 1.5), 3.2)).trim_lattice(jl)
        MeshTrimmer(octahedron((1.5, 1.5, 1.5), 3.2)).trim_lattice(tl)
    for name in ARRAYS:
        assert np.array_equal(getattr(jl, name), getattr(tl, name)), name
    return jl, tl


def rel(a, b) -> float:
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def assert_same_solution(got, want, tol=1e-10):
    for name in ("u", "reaction"):
        assert rel(getattr(got, name), getattr(want, name)) <= tol, name
    assert abs(got.compliance - want.compliance) <= tol * abs(want.compliance)


def assert_matches_fem(lat, res, sys_):
    fem = solve_fem(lat, subdivide_h=0.05, penalization=True, tol=1e-13,
                    device="cpu")
    iface = sys_.interface_nodes
    du = res.u[iface] - fem.u[iface]
    assert np.linalg.norm(du) / np.linalg.norm(fem.u[iface]) < 1e-8
    np.testing.assert_allclose(res.compliance, fem.compliance, rtol=1e-8)


@pytest.fixture(scope="module")
def loaded():
    jl, tl = both(lattice_config(n=(2, 2, 1), force=True))
    return jl, tl, jsv.build_ddm_system(jl), tsv.build_ddm_system(
        tl, device="cpu")


def test_schur_groups_match(loaded):
    jl, tl, js_, ts_ = loaded
    assert np.array_equal(ts_.cell_group, js_.cell_group)
    assert len(ts_.S) == len(js_.S) == 4
    assert ts_.S[0].dtype == torch.float64 and ts_.homogeneous
    for a, b in zip(ts_.S_np, js_.S_np):
        assert rel(a, b) <= 1e-12
    for a, b in zip(ts_.bn_groups, js_.bn_groups):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(ts_.interface_nodes, js_.interface_nodes)
    assert np.array_equal(ts_.free.numpy(), np.asarray(js_.free))


@pytest.mark.parametrize("what", ["matvec", "diagonal", "node_blocks", "rhs",
                                  "block_jacobi", "jacobi", "none", "mean",
                                  "hi_operator"])
def test_operator_from_the_same_schur_groups(loaded, what):
    """The port's system built from JAX's Schur groups: every operator
    piece within 1e-12 of JAX's."""
    jl, tl, js_, _ = loaded
    sys_ = tsv.DDMSystem(tl, js_.S_np, js_.cell_group, js_.bn_list,
                         apply_boundary_conditions(tl), device="cpu")
    u = np.random.default_rng(0).normal(size=(tl.num_nodes, 6))
    ut, uj = torch.as_tensor(u), jnp.asarray(u)
    if what in ("matvec", "diagonal", "node_blocks", "rhs"):
        got = getattr(sys_, what)(*((ut,) if what == "matvec" else ()))
        want = getattr(js_, what)(*((uj,) if what == "matvec" else ()))
    elif what == "hi_operator":
        A, b = sys_.hi_operator()
        Aj, bj = js_.hi_operator()
        assert rel(b, bj) <= 1e-12
        got, want = A(ut), Aj(uj)
    else:
        got = sys_.preconditioner(what)(ut)
        want = js_.preconditioner(what)(uj)
    assert rel(got, want) <= 1e-12
    with pytest.raises(ValueError, match="unknown preconditioner"):
        sys_.preconditioner("ilu0")


@pytest.mark.parametrize("force", [False, True], ids=["push", "load"])
def test_solve_matches_jax_and_fem(force):
    jl, tl = both(lattice_config(force=force))
    sys_ = tsv.build_ddm_system(tl, device="cpu")
    res = tsv.solve_ddm(tl, tol=1e-12, system=sys_)
    want = jsv.solve_ddm(jl, tol=1e-12)
    assert_same_solution(res, want)
    assert res.iterations > 0 and np.isfinite(res.residual)
    assert_matches_fem(tl, res, sys_)
    # the same bits on a second solve
    again = tsv.solve_ddm(tl, tol=1e-12, system=sys_)
    assert np.array_equal(again.u, res.u) and again.compliance == res.compliance


def test_preconditioners_agree(loaded):
    _, tl, _, sys_ = loaded
    runs = {k: tsv.solve_ddm(tl, system=sys_, preconditioner=k, tol=1e-12)
            for k in ("none", "jacobi", "block_jacobi")}
    np.testing.assert_allclose(runs["jacobi"].u, runs["none"].u, atol=1e-8)
    np.testing.assert_allclose(runs["block_jacobi"].u, runs["none"].u,
                               atol=1e-8)
    assert runs["block_jacobi"].iterations <= runs["none"].iterations + 5


def test_groups_by_radius():
    """Graded radii: one Schur group per distinct radius."""
    jl, tl = both(GRADED)
    sys_ = tsv.build_ddm_system(tl, device="cpu")
    assert len(sys_.S) == 3
    res = tsv.solve_ddm(tl, system=sys_, tol=1e-12)
    assert_same_solution(res, jsv.solve_ddm(jl, tol=1e-12))
    assert_matches_fem(tl, res, sys_)


def test_trimmed_heterogeneous_lattice():
    """Mixed topology (per-cell boundary-node counts 4/6/8), grouped per
    unique local subgraph, batched per group."""
    jl, tl = both(lattice_config(n=(3, 3, 3), force=True), trim=True)
    sys_ = tsv.build_ddm_system(tl, device="cpu")
    assert not sys_.homogeneous and sys_.cell_bnodes is None
    assert len({bn.shape[1] for bn in sys_.bn_groups}) >= 2
    res = tsv.solve_ddm(tl, system=sys_, tol=1e-12)
    assert_same_solution(res, jsv.solve_ddm(jl, tol=1e-12))
    assert_matches_fem(tl, res, sys_)


def test_refined_f32_reaches_f64_accuracy(loaded):
    """A float32 interface operator and the refined solve (automatic at a
    tol below the float32 floor) match the float64 solution; a plain
    float32 solve of the same system cannot."""
    jl, tl, _, sys64 = loaded
    r64 = tsv.solve_ddm(tl, system=sys64, tol=1e-12)
    sys32 = tsv.build_ddm_system(tl, dtype=torch.float32, device="cpu")
    assert sys32.S[0].dtype == torch.float32
    assert sys32.S_np[0].dtype == np.float64        # the source precision
    r32 = tsv.solve_ddm(tl, system=sys32, tol=1e-10)
    err = np.linalg.norm(r32.u - r64.u) / np.linalg.norm(r64.u)
    assert err < 1e-8
    assert r32.u.dtype == np.float64
    np.testing.assert_allclose(r32.compliance, r64.compliance, rtol=5e-8)
    plain = tsv.solve_ddm(tl, system=sys32, tol=1e-10, refined=False)
    assert np.linalg.norm(plain.u - r64.u) / np.linalg.norm(r64.u) > err * 10
    # and JAX's refined solve of its float32 system agrees
    j32 = jsv.solve_ddm(jl, system=jsv.build_ddm_system(
        jl, dtype=jnp.float32), tol=1e-10)
    assert np.linalg.norm(r32.u - j32.u) / np.linalg.norm(j32.u) < 1e-8


def test_default_dtype_and_device():
    _, tl = both(lattice_config(n=(1, 1, 1), force=True))
    assert tsv.build_ddm_system(tl, device="cpu").S[0].dtype == torch.float64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tsv.build_ddm_system(tl)
