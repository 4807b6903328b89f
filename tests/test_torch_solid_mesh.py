"""Port parity: the solid mesh (``io.solid_mesh``) against the JAX
package's, on the CPU.

``_capsule_sdf`` (a capsule-union signed distance in float32, JAX's jitted
block) against JAX's on an Octet block's grid (2e-6 absolute: both round
each point's terms in float32, in their own order of the three-term dot
products); chunking over points x beams changes no bit (a minimum taken
chunk by chunk is exact) and no [B, E, 3] temporary passes its budget;
then the triangles, volumes and exports of ``tests/test_solid_mesh.py`` on
the port (the marching tetrahedra are a numpy copy: from the same SDF,
the same triangles)."""

import numpy as np
import pytest
import torch

from pylatticedso_tpu import build_lattice as jax_build
from pylatticedso_tpu.io import solid_mesh as jsm

from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.io import solid_mesh as tsm

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

SDF_TOL = 2e-6


def _cfg(n, geom, r):
    return {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                         "number_of_cells": dict(zip("xyz", n)),
                         "radii": [r], "geom_types": [geom]}}


def _grid(lat, resolution):
    lo = lat.nodes.min(axis=0) - 0.1
    hi = lat.nodes.max(axis=0) + 0.1
    h = float((hi - lo).max()) / resolution
    dims = np.maximum(2, np.ceil((hi - lo) / h).astype(int) + 1)
    axes = [lo[k] + h * np.arange(dims[k]) for k in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)


def _ends(lat):
    return (lat.nodes[lat.edges[:, 0]], lat.nodes[lat.edges[:, 1]],
            lat.radius)


def test_capsule_sdf_matches_jax_and_chunks_exactly():
    lat = build_lattice(_cfg((2, 2, 1), "Octet", 0.05))
    G = _grid(lat, 24)
    p1, p2, r = _ends(lat)
    got = tsm._capsule_sdf(G, p1, p2, r, device="cpu")
    want = jsm._capsule_sdf(G, p1, p2, r)
    assert got.dtype == np.float32 and got.shape == (len(G),)
    assert np.abs(got - want).max() <= SDF_TOL
    # a budget that cuts both points and beams into many chunks
    small = 12 * 16 * 64
    pb, eb = tsm.sdf_chunks(len(G), len(r), small)
    assert pb < len(G) and eb < len(r) and pb * eb * 12 <= small
    chunked = tsm._capsule_sdf(G, p1, p2, r, device="cpu", max_bytes=small)
    np.testing.assert_array_equal(chunked, got)


@pytest.mark.parametrize("n_points,n_beams", [(10, 3), (10 ** 6, 8),
                                              (10 ** 6, 10 ** 6)])
def test_sdf_chunks_stay_within_budget(n_points, n_beams):
    pb, eb = tsm.sdf_chunks(n_points, n_beams)
    assert 1 <= pb <= n_points and 1 <= eb <= n_beams
    assert pb * eb * 3 * 4 <= tsm.SDF_CHUNK_BYTES


class _Capsule:
    nodes = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    edges = np.array([[0, 1]])
    radius = np.array([0.1])
    num_edges = 1

    def get_lattice_boundary_box(self):
        return [-0.1, 0.1, -0.1, 0.1, -0.1, 1.1]


def test_capsule_volume_converges_and_is_watertight():
    sdf, o, h = tsm.lattice_sdf_grid(_Capsule(), resolution=80,
                                     device="cpu")
    v = tsm.mesh_volume(tsm.marching_tetrahedra(sdf, o, h))
    exact = np.pi * 0.1 ** 2 * 1.0 + 4.0 / 3.0 * np.pi * 0.1 ** 3
    assert abs(v - exact) / exact < 0.02
    sdf, o, h = tsm.lattice_sdf_grid(_Capsule(), resolution=40,
                                     device="cpu")
    tris = tsm.marching_tetrahedra(sdf, o, h)
    # from JAX's SDF of the same grid, the same triangles (numpy copy)
    sj, oj, hj = jsm.lattice_sdf_grid(_Capsule(), resolution=40)
    np.testing.assert_array_equal(oj, o)
    np.testing.assert_array_equal(jsm.marching_tetrahedra(sdf, o, h), tris)
    assert np.abs(sj - sdf).max() <= SDF_TOL
    verts, inv = np.unique(tris.reshape(-1, 3).round(6), axis=0,
                           return_inverse=True)
    f = inv.reshape(-1, 3)
    e = np.sort(np.stack([f[:, [0, 1]], f[:, [1, 2]],
                          f[:, [2, 0]]]).reshape(-1, 2), axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert (counts == 2).all()          # closed 2-manifold


def test_lattice_relative_density_mesh_matches_jax():
    cfg = _cfg((1, 1, 1), "BCC", 0.08)
    lat, jl = build_lattice(cfg), jax_build(cfg)
    rho = tsm.get_relative_density_mesh(lat, resolution=72, device="cpu")
    rho_j = jsm.get_relative_density_mesh(jl, resolution=72)
    rho_sum = lat.get_relative_density()
    assert 0 < rho < rho_sum and abs(rho - rho_sum) / rho_sum < 0.25
    # SDF values a few ulps apart move the interpolated vertices by as much
    assert abs(rho - rho_j) <= 1e-5 * rho_j


def test_export_solid_mesh(tmp_path):
    lat = build_lattice(_cfg((1, 1, 1), "BCC", 0.08))
    tris = tsm.export_solid_mesh(tmp_path / "solid.stl", lat, resolution=48,
                                 device="cpu")
    raw = (tmp_path / "solid.stl").read_bytes()
    assert len(raw) == 84 + 50 * len(tris)
    tsm.export_solid_mesh(tmp_path / "solid.msh", lat, resolution=48,
                          device="cpu")
    assert "$MeshFormat" in (tmp_path / "solid.msh").read_text()[:40]
    v, tris2 = tsm.get_volume_mesh(lat, resolution=48, device="cpu")
    np.testing.assert_array_equal(tris2, tris)
    assert v == tsm.mesh_volume(tris)
