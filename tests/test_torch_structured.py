"""Port parity: StructuredLattice host build and the plain torch operator
(_sections, prepare_gather, apply_gather, diag, energy_dr2) against the JAX
package, in float64 on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pylatticedso_tpu.parallel.structured import StructuredLattice as JSL
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice as TSL

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

TOL = 1e-12


def _keep(x, y, z):
    return ((x - 1.2) ** 2 + (y - 1.0) ** 2 + (z - 1.0) ** 2) <= 1.7 ** 2


def _erased(shape, lo, hi):
    v = np.ones(shape, bool)
    v[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = False
    return v


CASES = {
    "bcc": dict(geom="BCC", n=(2, 2, 2)),
    "octet": dict(geom="Octet", n=(3, 2, 2)),
    "hybrid3": dict(geom=["BCC", "Hybrid1", "Hybrid4"], n=(2, 1, 2)),
    "hybrid2_erased": dict(geom=["BCC", "Hybrid1"], n=(2, 2, 2),
                           cell_valid=_erased((2, 2, 2), (0, 0, 0), (1, 1, 1))),
    "bcc_erased": dict(geom="BCC", n=(3, 3, 2),
                       cell_valid=_erased((3, 3, 2), (0, 0, 0), (1, 1, 1))),
    "octet_trimmed": dict(geom="Octet", n=(3, 2, 2), node_keep=_keep),
}


def _pair(case, dtype=np.float64):
    c = CASES[case]
    kw = {k: c[k] for k in ("cell_valid", "node_keep") if k in c}
    js = JSL(c["geom"], c["n"], (1.0, 1.0, 1.0), 1013.0, 0.3,
             dtype=jnp.float64, **kw)
    ts = TSL(c["geom"], c["n"], (1.0, 1.0, 1.0), 1013.0, 0.3,
             dtype=torch.float64, device="cpu", **kw)
    return js, ts


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_build_equal(case):
    js, ts = _pair(case)
    np.testing.assert_array_equal(ts.class_keys, js.class_keys)
    assert ts.nc == js.nc and ts.grid == js.grid
    assert len(ts.edges) == len(js.edges)
    for ej, et in zip(js.edges, ts.edges):
        for k in ("ca", "cb", "oa", "ob", "ext", "creators"):
            assert et[k] == ej[k], k
        for k in ("t", "a1", "a2", "fa", "fb", "inst_valid"):
            np.testing.assert_array_equal(et[k], ej[k], err_msg=k)
        assert et["L"] == ej["L"]
    np.testing.assert_array_equal(ts.node_valid, js.node_valid)
    assert ts.n_nodes == js.n_nodes and ts.n_edges == js.n_edges
    for c in range(ts.nc):
        np.testing.assert_array_equal(ts.class_pos[c], js.class_pos[c])
    top = lambda x, y, z: z == float(js.num_cells[2])
    np.testing.assert_array_equal(ts.select_nodes(top), js.select_nodes(top))


def _inputs(js, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((js.nc, 6) + js.grid)
    r = 0.04 + 0.05 * rng.random((js.n_geom,) + tuple(js.num_cells))
    return u, r


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_matches_jax_f64(case):
    js, ts = _pair(case)
    jm, jd = js.make_matvec()
    tm, td = ts.make_matvec()
    u, r = _inputs(js, seed=len(case))
    ju, jr = jnp.asarray(u), jnp.asarray(r)
    tu, tr = torch.tensor(u), torch.tensor(r)

    for a, b in zip(jm.sections(jr), tm.sections(tr)):
        assert _rel(a, b.numpy()) <= TOL
    jaux, taux = jm.prepare(jr), tm.prepare(tr)
    assert float(np.abs(np.asarray(jaux)).max()) > 0
    assert _rel(jaux, taux.numpy()) <= TOL
    y_j = np.asarray(jm.apply(ju, jaux))
    assert np.abs(y_j).max() > 0
    assert _rel(y_j, tm.apply_gather(tu, taux).numpy()) <= TOL
    # the kernel wrapper on a CPU tensor is the gather form
    assert _rel(y_j, tm.apply(tu, taux).numpy()) <= TOL
    assert _rel(y_j, tm(tu, tr).numpy()) <= TOL
    assert _rel(jd(jr), td(tr).numpy()) <= TOL
    for a, b in zip(jm.energy_dr2(ju, jm.sections(jr)),
                    tm.energy_dr2(tu, tm.sections(tr))):
        assert _rel(a, b.numpy()) <= TOL


def test_scalar_and_3d_radius_broadcast():
    js, ts = _pair("octet")
    jm, _ = js.make_matvec()
    tm, _ = ts.make_matvec()
    u, _ = _inputs(js, 3)
    r3 = 0.04 + 0.05 * np.random.default_rng(4).random(js.num_cells)
    for r in (0.05, r3):
        a = jm(jnp.asarray(u), jnp.asarray(r))
        b = tm(torch.tensor(u), torch.as_tensor(r, dtype=torch.float64))
        assert _rel(a, b.numpy()) <= TOL


def test_declined_lattices_raise():
    """A warped lattice is no longer declined: its operator is JAX's (the
    full parity is tests/test_torch_warped.py); the main path still never
    falls back to the CPU."""
    warp = lambda x, y, z: (x, y, z + 0.1 * x)
    warped = TSL("BCC", (2, 2, 2), (1.0, 1.0, 1.0), 1013.0, 0.3,
                 dtype=torch.float64, device="cpu", node_transform=warp)
    wj = JSL("BCC", (2, 2, 2), (1.0, 1.0, 1.0), 1013.0, 0.3,
             dtype=jnp.float64, node_transform=warp)
    u = np.random.default_rng(5).normal(size=(warped.nc, 6) + warped.grid)
    got = warped.make_matvec()[0](torch.tensor(u), 0.05)
    want = np.asarray(wj.make_matvec()[0](jnp.asarray(u), 0.05))
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
    if not torch.cuda.is_available():
        # the main path never falls back to the CPU
        on_card = TSL("BCC", (2, 2, 2), (1.0, 1.0, 1.0), 1013.0, 0.3)
        with pytest.raises(RuntimeError, match="cuda"):
            on_card.make_matvec()
