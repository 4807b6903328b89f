"""Port parity: warped lattices (``node_transform``) on the structured
operator against the JAX package, in float64 on the CPU.

The warp fields of the host build (bit for bit), the gather form, the
diagonal and the analytic energy derivative (1e-12), the scatter form
against JAX's ``PLDSO_MATVEC=scatter`` matvec on warped and unwarped
lattices (1e-12), the warped r^2-cotangent's plain version against
``jax.vjp`` of JAX's gather form in r^2 (1e-12), and the dense cross-check
at the transformed coordinates through the port's ``fem.operator`` (JAX's
own bound, 1e-9 absolute).  On the 3x2x2 twisted Octet of
``tests/test_structured.py`` and a BCC+Hybrid1 hybrid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu.parallel.structured import StructuredLattice as JSL
from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.fem.operator import assemble_dense
from pylatticedso_tpu_torch.kernels.stencil import StencilMatvec
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice as TSL

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

TOL = 1e-12


def twist(x, y, z):
    """tests/test_structured.py's smooth non-affine taper and twist: every
    instance gets its own length and frame."""
    s = 1.0 + 0.15 * z
    th = 0.25 * z
    xc, yc = x - 1.5, y - 1.0
    return (1.5 + s * (np.cos(th) * xc - np.sin(th) * yc),
            1.0 + s * (np.sin(th) * xc + np.cos(th) * yc),
            z + 0.1 * np.sin(x))


def bend(x, y, z):
    return x, y + 0.05 * x * x, z + 0.1 * np.sin(0.7 * x + 0.3 * y)


CASES = {
    "octet_twist": dict(geom="Octet", n=(3, 2, 2), warp=twist),
    "hybrid_bend": dict(geom=["BCC", "Hybrid1"], n=(2, 2, 1), warp=bend),
}


def _pair(case, warped=True):
    c = CASES[case]
    w = c["warp"] if warped else None
    js = JSL(c["geom"], c["n"], (1.0, 1.0, 1.0), 1013.0, 0.3,
             dtype=jnp.float64, node_transform=w)
    ts = TSL(c["geom"], c["n"], (1.0, 1.0, 1.0), 1013.0, 0.3,
             dtype=torch.float64, device="cpu", node_transform=w)
    return js, ts


def _inputs(ts, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(ts.nc, 6) + ts.grid)
    r = 0.03 + 0.04 * rng.random((ts.n_geom,) + tuple(ts.num_cells))
    return u, r


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("case", sorted(CASES))
def test_warp_fields_equal(case):
    js, ts = _pair(case)
    for c in range(ts.nc):
        np.testing.assert_array_equal(ts.class_pos[c], js.class_pos[c])
        np.testing.assert_array_equal(ts.class_pos_unwarped[c],
                                      js.class_pos_unwarped[c])
    for ej, et in zip(js.edges, ts.edges):
        np.testing.assert_array_equal(et["warp_frames"], ej["warp_frames"])
        np.testing.assert_array_equal(et["warp_L"], ej["warp_L"])
        assert et["warp_frames"].shape == (3, 3) + tuple(et["ext"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_diag_energy_match_jax(case, monkeypatch):
    monkeypatch.delenv("PLDSO_MATVEC", raising=False)
    js, ts = _pair(case)
    u, r = _inputs(ts)
    mj, dj = js.make_matvec()
    mt, dt = ts.make_matvec()
    ut, rt = torch.tensor(u), torch.tensor(r)
    r2j = mj.prepare(jnp.asarray(r))
    r2t = mt.prepare(rt)
    np.testing.assert_array_equal(r2t.numpy(), np.asarray(r2j))
    assert _rel(mt.apply_gather(ut, r2t), mj.apply(jnp.asarray(u), r2j)) \
        <= TOL
    # the wrapper on a CPU tensor is the plain gather form
    assert torch.equal(mt(ut, rt), mt.apply_gather(ut, r2t))
    assert _rel(dt(rt), dj(jnp.asarray(r))) <= TOL
    ej = mj.energy_dr2(jnp.asarray(u), mj.sections(jnp.asarray(r)))
    et = mt.energy_dr2(ut, mt.sections(rt))
    assert len(et) == len(ej)
    for a, b in zip(et, ej):
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("warped", [True, False], ids=["warped", "unwarped"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scatter_matches_jax(case, warped, monkeypatch):
    """JAX's scatter ``matvec`` (selected by ``PLDSO_MATVEC=scatter``)
    against the port's ``apply_scatter``; the port's forms agree with
    each other too (both add each point's sides in edge order)."""
    js, ts = _pair(case, warped)
    u, r = _inputs(ts, seed=1)
    monkeypatch.setenv("PLDSO_MATVEC", "scatter")
    mj, _ = js.make_matvec()
    assert not hasattr(mj, "prepare")          # JAX's scatter form
    mt, _ = ts.make_matvec()
    ut, rt = torch.tensor(u), torch.tensor(r)
    got = mt.apply_scatter(ut, rt)
    assert _rel(got, mj(jnp.asarray(u), jnp.asarray(r))) <= TOL
    assert _rel(got, mt(ut, rt)) <= TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_vjp_r2_matches_jax_vjp(case, monkeypatch):
    monkeypatch.delenv("PLDSO_MATVEC", raising=False)
    js, ts = _pair(case)
    u, r = _inputs(ts, seed=2)
    lam = np.random.default_rng(3).normal(size=u.shape)
    mj, _ = js.make_matvec()
    mt, _ = ts.make_matvec()
    r2j = mj.prepare(jnp.asarray(r))
    _y, vjp = jax.vjp(lambda q: mj.apply(jnp.asarray(u), q), r2j)
    (want,) = vjp(jnp.asarray(lam))
    got = mt.apply_gather_vjp_r2(torch.tensor(lam), torch.tensor(u),
                                 mt.prepare(torch.tensor(r)))
    assert got.shape == tuple(want.shape)
    assert _rel(got, want) <= TOL
    # the wrapper's r^2-cotangent on a CPU tensor is this plain version
    assert torch.equal(mt.apply.vjp_r2(torch.tensor(lam), torch.tensor(u),
                                       mt.prepare(torch.tensor(r))), got)


def _map_nodes(sl, lat):
    coord_to_cg = {}
    for c in range(sl.nc):
        x, y, z = sl.class_pos[c]
        for idx in np.argwhere(sl.node_valid[c]):
            key = (round(x[tuple(idx)], 9), round(y[tuple(idx)], 9),
                   round(z[tuple(idx)], 9))
            coord_to_cg[key] = (c, tuple(idx))
    return [(i, *coord_to_cg[tuple(np.round(p, 9))])
            for i, p in enumerate(lat.nodes)]


def test_dense_cross_check_at_transformed_coordinates():
    """``tests/test_structured.py::test_structured_warped_matches_dense``
    on the port: the warped gather form, scatter form and diagonal
    against the dense stiffness of ``fem.operator.assemble_dense`` at the
    transformed nodes; the warped fields carry the nodes' unwarped
    positions for the mapping."""
    N = (3, 2, 2)
    lat = build_lattice({"geometry": {
        "cell_size": {"x": 1, "y": 1, "z": 1},
        "number_of_cells": dict(zip("xyz", N)),
        "radii": [0.05], "geom_types": ["Octet"]}})
    sl0 = TSL("Octet", N, (1, 1, 1), 1013.0, 0.3, dtype=torch.float64,
              device="cpu")
    sl = TSL("Octet", N, (1, 1, 1), 1013.0, 0.3, dtype=torch.float64,
             device="cpu", node_transform=twist)
    mapping = _map_nodes(sl0, lat)
    for c in range(sl.nc):
        np.testing.assert_array_equal(sl.class_pos_unwarped[c],
                                      sl0.class_pos[c])
    nodes_w = np.stack(twist(*lat.nodes.T), axis=1)
    K = assemble_dense(nodes_w, lat.edges, lat.radius, 1013.0, 0.3,
                       device="cpu").numpy()
    u_lat = np.random.default_rng(0).normal(size=(lat.num_nodes, 6))
    u_f = np.zeros((sl.nc, 6) + sl.grid)
    for i, c, g in mapping:
        u_f[(c, slice(None)) + g] = u_lat[i]
    ref = (K @ u_lat.reshape(-1)).reshape(-1, 6)
    mv, dg = sl.make_matvec()
    r = torch.full(N, 0.05, dtype=torch.float64)
    d = dg(r).numpy()
    for out in (mv(torch.tensor(u_f), r).numpy(),
                mv.apply_scatter(torch.tensor(u_f), r).numpy()):
        err = max(np.abs(out[(c, slice(None)) + g] - ref[i]).max()
                  for i, c, g in mapping)
        assert err < 1e-9, f"warped matvec err {err:.2e}"
    derr = max(np.abs(d[(c, slice(None)) + g]
                      - np.diag(K).reshape(-1, 6)[i]).max()
               for i, c, g in mapping)
    assert derr < 1e-9, f"warped diag err {derr:.2e}"


def test_warped_wrapper_counts_the_geometry():
    """On a warped lattice the wrapper is B1w: its names, no B2, and its
    bound counts the 10 padded geometry rows of every edge as read once."""
    _js, ts = _pair("octet_twist")
    mv, _ = ts.make_matvec()
    w = mv.apply
    assert w.warped
    assert tuple(w.geo.shape) == (len(ts.edges), 10) + tuple(
        g + 2 for g in ts.grid)
    assert torch.all(w.geo[:, 9] > 0)           # lengths, 1.0 in the padding
    X, Y, Z = ts.grid
    Fp, N = (X + 2) * (Y + 2) * (Z + 2), X * Y * Z
    n_e = len(ts.edges)
    assert w.work(8)[0] == 8 * ((ts.nc * 6 + 11 * n_e) * Fp + ts.nc * 6 * N)
    assert w.vjp_work(4)[0] == 4 * (2 * ts.nc * 6 + 12 * n_e) * Fp
    assert w._names == {torch.float32: StencilMatvec.name_w,
                        torch.float64: StencilMatvec.name_w_f64}
    _js0, ts0 = _pair("octet_twist", warped=False)
    w0 = ts0.make_matvec()[0].apply
    assert not w0.warped and w0.work(8)[0] < w.work(8)[0]
    assert w0.work(8)[1] == w.work(8)[1]         # the same operations
