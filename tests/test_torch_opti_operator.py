"""The port's unstructured beam operator, density model and
parameterizations against the JAX package's, in float64 on the CPU.

* ``fem.elements`` / ``fem.operator``: element stiffness, K.u, diag(K),
  strain energy, dense assembly and per-node energies at <= 1e-12 of the
  largest value; ``SegmentSum`` adds each node's terms in ascending order
  (the same bits as a sequential loop) and its gradient is the gather.
* ``KrigingDensity.load`` of the Octet cache: mean and gradient <= 1e-12;
  the hybrid caches within the rounding bound of their sums.
* ``Parameterization.cell_radii`` and its gradient at a theta on its
  bounds, exactly (the straight-through clip keeps the gradient there).
* ``density_voxel`` against the JAX quadrature (float32 on both sides).

JAX runs eagerly here (no step is compiled).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu import build_lattice as jax_build
from pylatticedso_tpu.fem import elements as jel
from pylatticedso_tpu.fem import operator as jop
from pylatticedso_tpu.opti.density import KrigingDensity as JaxKriging
from pylatticedso_tpu.opti.density import density_voxel as jax_voxel
from pylatticedso_tpu.opti.parameterization import \
    make_parameterization as jax_make_param

from pylatticedso_tpu_torch.catalog import get_beam_structure
from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.fem import elements as tel
from pylatticedso_tpu_torch.fem import operator as top
from pylatticedso_tpu_torch.opti.density import KrigingDensity, density_voxel
from pylatticedso_tpu_torch.opti.parameterization import make_parameterization

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FIT = ROOT / "data/outputs/density_datasets"
TOL = 1e-12
E_MOD, NU = 1013.0, 0.3
CASES = {
    "octet_3x2x2": (["Octet"], (3, 2, 2), [0.05]),
    "bcc_hybrid1_2": (["BCC", "Hybrid1"], (2, 2, 2), [0.05, 0.04]),
    "kelvin_2": (["Kelvin"], (2, 2, 2), [0.06]),
}


def _cfg(geoms, n, radii):
    return {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                         "number_of_cells": dict(zip("xyz", n)),
                         "radii": radii, "geom_types": geoms}}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _random_radius(lat, seed):
    return 0.03 + 0.05 * np.random.default_rng(seed).random(lat.num_edges)


@pytest.mark.parametrize("case", list(CASES))
def test_operator_matches_jax(case):
    lat_j = jax_build(_cfg(*CASES[case]))
    lat = build_lattice(_cfg(*CASES[case]))
    r = _random_radius(lat, 1)
    oj = jop.build_operator(lat_j.nodes, lat_j.edges, r, E_MOD, NU)
    ot = top.build_operator(lat.nodes, lat.edges, r, E_MOD, NU, device="cpu")
    u = np.random.default_rng(2).standard_normal((lat.num_nodes, 6))
    ut = torch.as_tensor(u)
    assert _rel(ot.matvec(ut), oj.matvec(jnp.asarray(u))) <= TOL
    assert _rel(ot.diagonal(), oj.diagonal()) <= TOL
    assert _rel(ot.strain_energy(ut), oj.strain_energy(jnp.asarray(u))) <= TOL
    for name in ("t", "a1", "a2", "L"):
        assert _rel(getattr(ot.geom, name), getattr(oj.geom, name)) <= TOL
    free = (np.random.default_rng(3).random((lat.num_nodes, 6)) > 0.2) * 1.0
    assert _rel(top.masked_operator(ot, torch.as_tensor(free))(ut),
                jop.masked_operator(oj, jnp.asarray(free))(jnp.asarray(u))) \
        <= TOL
    # the same bits on repeat (no atomics in the per-node sums)
    assert torch.equal(ot.matvec(ut), ot.matvec(ut))


def test_dense_assembly_and_elements_match_jax():
    lat = build_lattice(_cfg(*CASES["bcc_hybrid1_2"]))
    r = _random_radius(lat, 4)
    w = 0.5 + np.random.default_rng(5).random(lat.num_edges)
    Kj = jop.assemble_dense(lat.nodes, lat.edges, r, E_MOD, NU, weight=w)
    Kt = top.assemble_dense(lat.nodes, lat.edges, r, E_MOD, NU, weight=w,
                            device="cpu")
    assert _rel(Kt, Kj) <= TOL
    ot = top.build_operator(lat.nodes, lat.edges, r, E_MOD, NU, device="cpu")
    ot = ot._replace(D=ot.D * torch.as_tensor(w)[:, None])
    u = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (lat.num_nodes, 6)))
    assert _rel(Kt @ u.reshape(-1), ot.matvec(u).reshape(-1)) <= TOL
    nodes = torch.as_tensor(lat.nodes)
    edges = torch.as_tensor(lat.edges, dtype=torch.long)
    assert _rel(tel.element_stiffness_dense(nodes, edges, torch.as_tensor(r),
                                            E_MOD, NU),
                jel.element_stiffness_dense(lat.nodes, lat.edges, r, E_MOD,
                                            NU)) <= TOL
    assert _rel(tel.section_stiffness_gradient(torch.as_tensor(r), E_MOD, NU),
                jel.section_stiffness_gradient(r, E_MOD, NU)) <= TOL


def test_node_energies_match_jax():
    cfg = _cfg(*CASES["octet_3x2x2"])
    lat_j, lat = jax_build(cfg), build_lattice(cfg)
    u = np.random.default_rng(7).standard_normal((lat.num_nodes, 6))
    assert _rel(lat.node_energies(u, device="cpu"),
                lat_j.node_energies(u)) <= TOL


def test_segment_sum_is_ordered_and_differentiable():
    """Each segment's terms are added in ascending index order, so the sum
    equals a sequential loop bit for bit; the gradient of the sum is the
    gather and the gradient of the gather is the sum."""
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 7, size=50)
    idx[idx == 3] = 4                               # one empty segment
    vals = rng.standard_normal((50, 6))
    seg = top.SegmentSum(torch.as_tensor(idx), 7)
    want = np.zeros((7, 6))
    for i, s in enumerate(idx):
        want[s] = want[s] + vals[i]
    got = seg(torch.as_tensor(vals))
    np.testing.assert_array_equal(got.numpy(), want)
    x = torch.as_tensor(vals, dtype=torch.float64).requires_grad_(True)
    w = torch.as_tensor(rng.standard_normal((7, 6)))
    (gx,) = torch.autograd.grad(torch.sum(w * seg(x)), x)
    np.testing.assert_array_equal(gx.numpy(), w.numpy()[idx])
    y = torch.as_tensor(rng.standard_normal((7, 6))).requires_grad_(True)
    (gy,) = torch.autograd.grad(torch.sum(x.detach() * seg.gather(y)), y)
    np.testing.assert_array_equal(gy.numpy(), want)
    empty = top.SegmentSum(torch.zeros(0, dtype=torch.long), 3)
    assert torch.equal(empty(torch.zeros((0, 6))), torch.zeros((3, 6)))


def _dot_bounds(model, x):
    """The a-priori rounding bounds of the mean and of its gradient (per
    component) at x: n eps sum_i |t_i| over the n training points' terms
    t_i (a sum of n float64 terms in any order; the hybrid fits' alphas
    reach 1e4 and cancel)."""
    xs = (x - model.scaler_mean) / model.scaler_scale
    diff = (xs[None, :] - model.X_train_scaled) / model.length_scale
    k = model.const * np.exp(-0.5 * np.sum(diff**2, axis=1))
    t_mean = model.y_std * model.alpha * k
    t_grad = t_mean[:, None] * diff / (model.length_scale * model.scaler_scale)
    scale = len(k) * np.finfo(float).eps
    return scale * np.abs(t_mean).sum(), scale * np.abs(t_grad).sum(axis=0)


@pytest.mark.parametrize("name", ["Octet_0.01_0.1_10", "BCC_Hybrid1_0.01_0.1_10",
                                  "BCC_Hybrid1_Hybrid4_0.01_0.1_10"])
def test_kriging_mean_and_grad_match_jax(name):
    """The Octet fit (the optimizer's) at 1e-12; every fit within the
    a-priori rounding bounds of its sums."""
    jm = JaxKriging.load(FIT / f"{name}.gpr.npz")
    tm = KrigingDensity.load(FIT / f"{name}.gpr.npz")
    d = jm.X_train_scaled.shape[1]
    xs = 0.01 + 0.09 * np.random.default_rng(9).random((6, d))
    batch = tm.mean(torch.as_tensor(xs)).numpy()
    want_batch = np.asarray(jax.vmap(jm.mean)(jnp.asarray(xs)))
    for i, x in enumerate(xs):
        vj, gj = jm.mean_and_grad(x)
        vt, gt = tm.mean_and_grad(x, device="cpu")
        b_mean, b_grad = _dot_bounds(tm, x)
        assert abs(float(vt) - float(vj)) <= b_mean
        # the batched mean the density constraint takes, one row per cell
        assert abs(batch[i] - want_batch[i]) <= b_mean
        err = np.abs(gt.numpy() - np.asarray(gj))
        assert np.all(err <= b_grad), (err, b_grad)
        if name.startswith("Octet"):
            assert abs(float(vt) - float(vj)) <= TOL * abs(float(vj))
            assert abs(batch[i] - want_batch[i]) <= TOL * abs(want_batch[i])
            assert _rel(gt, gj) <= TOL


@pytest.mark.parametrize("opt", [{"type": "unit_cell"}, {"type": "constant"},
                                 {"type": "constant", "hybrid": True},
                                 {"type": "linear"},
                                 {"type": "poly2",
                                  "terms": ["x", "y2", "xz"]}],
                         ids=lambda o: o["type"] + ("_hybrid" if o.get(
                             "hybrid") else ""))
def test_parameterization_matches_jax_at_its_bounds(opt):
    """cell_radii and its gradient at a theta whose entries sit on the box
    bounds (0 and 1, and -1/1 for the field coefficients): the values, and
    the gradient that the straight-through clip keeps, equal JAX's (the
    polynomial fields within 1e-15: their basis sums in another order)."""
    cfg = _cfg(["BCC", "Hybrid1"], (3, 2, 2), [0.05, 0.04])
    pj = jax_make_param(jax_build(cfg), opt)
    pt = make_parameterization(build_lattice(cfg), opt)
    n = pt.n_params
    theta = np.where(np.arange(n) % 2 == 0, pt.lower, pt.upper)
    theta[-1] = pt.upper[-1]
    w = np.random.default_rng(10).standard_normal((pt.n_cells, pt.n_geom))
    rj = pj.cell_radii(jnp.asarray(theta))
    gj = jax.grad(lambda t: jnp.sum(jnp.asarray(w) * pj.cell_radii(t)))(
        jnp.asarray(theta))
    th = torch.as_tensor(theta).requires_grad_(True)
    rt = pt.cell_radii(th)
    (gt,) = torch.autograd.grad(torch.sum(torch.as_tensor(w) * rt), th)
    if opt["type"] in ("linear", "poly2"):
        np.testing.assert_allclose(rt.detach().numpy(), np.asarray(rj),
                                   rtol=0, atol=1e-15)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                                   atol=1e-15 * np.abs(w).sum())
    else:
        np.testing.assert_array_equal(rt.detach().numpy(), np.asarray(rj))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
        assert np.all(gt.numpy() != 0.0)
    # the per-edge radius, and the optimizer's ordered gather of it
    lat = build_lattice(cfg)
    want = np.asarray(pj.edge_radius(jnp.asarray(theta), lat.edge_cell,
                                     lat.edge_type))
    np.testing.assert_array_equal(
        pt.edge_radius(th, lat.edge_cell, lat.edge_type).detach().numpy(),
        want)
    from pylatticedso_tpu_torch.fem.operator import SegmentSum
    flat = lat.edge_cell.astype(np.int64) * pt.n_geom + lat.edge_type
    seg = SegmentSum(torch.as_tensor(flat), pt.n_cells * pt.n_geom)
    np.testing.assert_array_equal(
        seg.gather(pt.cell_radii(th).reshape(-1)).detach().numpy(), want)


def test_density_voxel_matches_jax():
    tpl = get_beam_structure("BCC")
    radii = np.full(len(tpl), 0.08)
    want = jax_voxel(tpl, radii, resolution=24)
    got = density_voxel(tpl, radii, resolution=24, device="cpu")
    # float32 quadrature on both sides: a point on a cylinder's surface may
    # round either way, one point in 24^3 moves the fraction by 7.2e-5
    assert abs(got - want) <= 3.0 / 24**3
    assert 0 < got < 1
