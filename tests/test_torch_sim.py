"""The port's simulation layer and design front end against the JAX
package, in float64 on the CPU:

* ``homogenize_cell`` (C, C_raw, the fluctuation fields) within 1e-10 on
  ``tests/test_homogenization.py``'s BCC and Octet cells;
  ``orthotropic_constants`` and ``directional_modulus`` equal;
* ``solve_fem_cell``, ``solve_fem_lattice`` and
  ``force_displacement_curve`` on ``tests/test_sim_extras.py``'s cases
  within 1e-10, and the single-cell guard of
  ``get_homogenized_properties``;
* ``design.cleanup``, ``design.transforms`` (``attractor_lattice``, the
  cylinder wrap with its merged seam, the recorded ``node_transforms``)
  and ``MeshTrimmer`` on ``tests/test_aux.py``'s cases: arrays equal.

Every case builds its lattice in both packages from one config and first
asserts that the arrays are equal.
"""

import numpy as np
import pytest
import torch

from pylatticedso_tpu import build_lattice as jax_build
from pylatticedso_tpu.design import cleanup as jcl
from pylatticedso_tpu.design import mesh_trimmer as jmt
from pylatticedso_tpu.design import transforms as jtf
from pylatticedso_tpu.fem import bc as jbc_mod
from pylatticedso_tpu.fem import homogenization as jho
from pylatticedso_tpu.sim import utils_simulation as jus

from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.design import cleanup as tcl
from pylatticedso_tpu_torch.design import mesh_trimmer as tmt
from pylatticedso_tpu_torch.design import transforms as ttf
from pylatticedso_tpu_torch.fem import bc as tbc_mod
from pylatticedso_tpu_torch.fem import homogenization as tho
from pylatticedso_tpu_torch.sim import utils_simulation as tus

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

SOLVE_TOL = 1e-10
LATTICE_ARRAYS = ("nodes", "edges", "radius", "node_tag", "edge_type",
                  "edge_mat", "edge_cell", "cell_edge_ptr", "cell_edge_idx",
                  "cell_node_ptr", "cell_node_idx")


def config(n, geom="BCC", r=0.05, **extra):
    return {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                         "number_of_cells": dict(zip("xyz", n)),
                         "radii": [r], "geom_types": [geom]}, **extra}


def assert_same_lattice(jl, tl):
    for name in LATTICE_ARRAYS:
        a, b = getattr(jl, name), getattr(tl, name)
        if a is None or b is None:
            assert a is None and b is None, name
        else:
            assert np.array_equal(a, b), name


def both(cfg):
    jl, tl = jax_build(cfg), build_lattice(cfg)
    assert_same_lattice(jl, tl)
    return jl, tl


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


VERO = {"simulation_parameters": {"enable": True, "material": "VeroClear",
                                  "periodicity": True}}


# -------------------------------------------------------- homogenization
@pytest.mark.parametrize("geom", ["BCC", "Octet"])
def test_homogenize_cell_matches(geom):
    jl, tl = both(config((1, 1, 1), geom, **VERO))
    want = jho.homogenize_cell(jl)
    got = tho.homogenize_cell(tl, device="cpu")
    for name in ("C", "C_raw", "u_fluct"):
        assert rel(getattr(got, name), getattr(want, name)) <= SOLVE_TOL, name
    assert abs(got.symmetry_error - want.symmetry_error) <= 1e-8
    for k, v in want.orthotropic.items():
        assert abs(got.orthotropic[k] - v) <= SOLVE_TOL * abs(v), k
    # the port's own constants of JAX's C are JAX's, bit for bit
    assert tho.orthotropic_constants(want.C) == jho.orthotropic_constants(want.C)
    theta, phi = np.linspace(0, np.pi, 7), np.linspace(0, 2 * np.pi, 7)
    assert np.array_equal(tho.directional_modulus(want.C, theta, phi),
                          jho.directional_modulus(want.C, theta, phi))


def test_homogenized_properties_and_guard():
    jl, tl = both(config((1, 1, 1), "BCC", **VERO))
    got = tus.get_homogenized_properties(tl, device="cpu")
    assert rel(got.C, jus.get_homogenized_properties(jl).C) <= SOLVE_TOL
    _, tl2 = both(config((2, 1, 1)))
    with pytest.raises(ValueError, match="exactly one cell"):
        tus.get_homogenized_properties(tl2, device="cpu")


# ------------------------------------------------------------ sim layer
def test_solve_fem_cell_matches():
    jl, tl = both(config((1, 1, 1), "BCC", 0.06,
                         simulation_parameters={"enable": True,
                                                "material": "VeroClear"}))
    from pylatticedso_tpu_torch.sim.boundary_order import boundary_node_order
    nb = len(boundary_node_order(tl.nodes, [0, 1, 0, 1, 0, 1]))
    u_b = np.random.default_rng(0).normal(size=(nb, 6)) * 1e-3
    want = jus.solve_fem_cell(jl, 0, u_b, target_h=0.05, tol=1e-14)
    got = tus.solve_fem_cell(tl, 0, u_b, target_h=0.05, tol=1e-14,
                             device="cpu")
    assert got.u.shape == want.u.shape
    assert rel(got.u, want.u) <= SOLVE_TOL
    assert rel(got.reaction, want.reaction) <= SOLVE_TOL
    assert abs(got.compliance - want.compliance) <= \
        SOLVE_TOL * abs(want.compliance)


def crush(value):
    return config((1, 1, 2), "BCC", 0.08,
                  simulation_parameters={"enable": True,
                                         "material": "VeroClear"},
                  boundary_conditions={"Displacement": {
                      "Fixed": {"Surface": ["Zmin"],
                                "DOF": ["X", "Y", "Z", "RX", "RY", "RZ"],
                                "Value": [0, 0, 0, 0, 0, 0]},
                      "Crush": {"Surface": ["Zmax"], "DOF": ["Z"],
                                "Value": [value]}}})


@pytest.mark.parametrize("value", [-0.02, -0.04])
def test_force_displacement_curve_matches(value):
    jl, tl = both(crush(value))
    jb, tb = jbc_mod.apply_boundary_conditions(jl), \
        tbc_mod.apply_boundary_conditions(tl)
    want = jus.force_displacement_curve(jl, jus.solve_fem(jl, tol=1e-12), jb)
    got = tus.force_displacement_curve(tl, tus.solve_fem(tl, tol=1e-12,
                                                         device="cpu"), tb)
    assert np.array_equal(got[0], want[0])
    assert abs(got[1] - want[1]) <= SOLVE_TOL * want[1] and got[1] > 0
    assert np.isclose(got[0].min(), value)


def test_solve_fem_lattice_auto_subdivision_matches():
    jl, tl = both(crush(-0.02))
    want = jus.solve_fem_lattice(jl, tol=1e-12)
    got = tus.solve_fem_lattice(tl, tol=1e-12, device="cpu")
    assert got.u.shape == (tl.num_nodes, 6)
    assert rel(got.u, want.u) <= SOLVE_TOL
    assert rel(got.reaction, want.reaction) <= SOLVE_TOL
    assert abs(got.compliance - want.compliance) <= \
        SOLVE_TOL * abs(want.compliance)


# -------------------------------------------------------------- cleanup
def test_merge_degree2_nodes_equal():
    jl, tl = both(config((1, 1, 1), "BCCZ"))
    assert tcl.merge_degree2_nodes(tl) == jcl.merge_degree2_nodes(jl) == 0
    for lat in (jl, tl):
        lat.edges = np.array([[0, 1], [1, 2]], dtype=np.int32)
        lat.nodes = np.array([[0., 0., 0.], [0.5, 0., 0.], [1., 0., 0.]])
        lat.node_tag = np.zeros(3, dtype=np.int32)
        lat.radius = np.array([0.05, 0.05])
        lat.edge_type = np.zeros(2, dtype=np.int32)
        lat.edge_mat = np.zeros(2, dtype=np.int32)
        lat.edge_cell = np.zeros(2, dtype=np.int32)
    assert tcl.merge_degree2_nodes(tl) == jcl.merge_degree2_nodes(jl) == 1
    assert_same_lattice(jl, tl)


def test_delete_unconnected_beams_equal():
    jl, tl = both(config((1, 1, 1), "BCCZ"))
    got = tcl.delete_unconnected_beams(tl)
    assert got == jcl.delete_unconnected_beams(jl) and got[0] == 10
    assert_same_lattice(jl, tl)


def test_delete_under_radius_equal():
    jl, tl = both(config((2, 1, 1)))
    for lat in (jl, tl):
        lat.radius[:4] = 0.001
    assert tcl.delete_beams_under_radius_threshold(tl, 0.01) == \
        jcl.delete_beams_under_radius_threshold(jl, 0.01) == 4
    assert_same_lattice(jl, tl)


# ----------------------------------------------------------- transforms
def test_attractor_and_recorded_map_equal():
    jl, tl = both(config((1, 1, 1)))
    jtf.attractor_lattice(jl, (0.5, 0.5, 10.0), alpha=0.01)
    ttf.attractor_lattice(tl, (0.5, 0.5, 10.0), alpha=0.01)
    assert_same_lattice(jl, tl)
    assert np.array_equal(jl.nodes_pre_transform, tl.nodes_pre_transform)
    assert len(tl.node_transforms) == len(jl.node_transforms) == 1
    x, y, z = tl.nodes_pre_transform.T
    for a, b in zip(tl.node_transforms[0](x, y, z),
                    jl.node_transforms[0](x, y, z)):
        assert np.array_equal(a, b)
    assert np.array_equal(np.stack(tl.node_transforms[0](x, y, z), 1),
                          tl.nodes)


@pytest.mark.parametrize("name, args", [
    ("curve_lattice", ((0, 0, 0), 0.1)),
    ("move_to_cylinder_form", (5.0,)),
    ("fit_to_surface", (lambda x, y: 0.5 * x, "z")),
])
def test_pointwise_transforms_equal(name, args):
    jl, tl = both(config((2, 1, 1)))
    getattr(jtf, name)(jl, *args)
    getattr(ttf, name)(tl, *args)
    assert_same_lattice(jl, tl)
    assert len(tl.node_transforms) == len(jl.node_transforms) == 1


def test_cylinder_form_validation():
    _, tl = both(config((2, 1, 1)))
    with pytest.raises(ValueError, match="too small"):
        ttf.move_to_cylinder_form(tl, radius=0.5)


def test_cylindrical_transform_merges_seam_equal():
    jl, tl = both(config((1, 4, 1)))
    n0 = tl.num_nodes
    jtf.cylindrical_transform(jl, radius=2.0)
    ttf.cylindrical_transform(tl, radius=2.0)
    assert_same_lattice(jl, tl)
    assert tl.num_nodes < n0
    np.testing.assert_allclose(np.linalg.norm(tl.nodes[:, :2], axis=1), 2.0,
                               atol=1e-9)
    # the seam merge changed the topology: no pointwise map is recorded
    assert tl.node_transforms is None and jl.node_transforms is None


# --------------------------------------------------------- mesh trimmer
def cube(lo=0.0, hi=1.0):
    """12-triangle closed cube."""
    v = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi)
                  for z in (lo, hi)])
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5),
             (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),
             (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]
    return np.array([[v[a], v[b], v[c]] for a, b, c in faces])


def test_mesh_trimmer_queries_equal(tmp_path):
    path = tmp_path / "cube.stl"
    with open(path, "w") as fh:
        fh.write("solid cube\n")
        for tri in cube():
            fh.write("facet normal 0 0 0\nouter loop\n")
            for p in tri:
                fh.write(f"vertex {p[0]} {p[1]} {p[2]}\n")
            fh.write("endloop\nendfacet\n")
        fh.write("endsolid cube\n")
    assert np.array_equal(tmt.load_stl(path), jmt.load_stl(path))
    tm, jm = tmt.MeshTrimmer(path), jmt.MeshTrimmer(path)
    pts = np.array([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5], [0.2, 0.9, 0.1]])
    assert np.array_equal(tm.points_inside(pts), jm.points_inside(pts))
    for o, s in (([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]),
                 ([2.0, 2.0, 2.0], [0.5, 0.5, 0.5])):
        assert tm.is_cell_in_mesh(o, s) == jm.is_cell_in_mesh(o, s)
    nodes = np.array([[0.5, 0.5, 0.5], [0.5, 0.5, 1.5], [0.5, 0.5, 0.8],
                      [2.0, 2.0, 2.0], [3.0, 3.0, 3.0]])
    edges = np.array([[0, 1], [0, 2], [3, 4]], dtype=np.int32)
    radius = np.array([0.1, 0.2, 0.3])
    got = tm.cut_beams_at_mesh_intersection(nodes, edges, (radius,))
    want = jm.cut_beams_at_mesh_intersection(nodes, edges, (radius,))
    assert len(got[1]) == 2
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_trim_built_lattice_equal():
    jl, tl = both(config((2, 2, 2)))
    n0 = tl.num_edges
    jmt.MeshTrimmer(cube(-0.1, 1.1)).trim_lattice(jl)
    tmt.MeshTrimmer(cube(-0.1, 1.1)).trim_lattice(tl)
    assert_same_lattice(jl, tl)
    for name in ("cell_pos", "cell_origin", "cell_size", "cell_radii"):
        assert np.array_equal(getattr(jl, name), getattr(tl, name)), name
    assert 0 < tl.num_edges < n0
