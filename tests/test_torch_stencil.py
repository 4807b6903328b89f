"""B1 stencil kernel wrapper: the CPU plain path against the JAX Pallas
kernel (interpret mode) and the edge-side table against the JAX one.  The
kernel itself is tested on the card by tests/test_torch_gpu.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pylatticedso_tpu.parallel.structured import StructuredLattice as JSL
from pylatticedso_tpu.parallel.stencil_pallas import (_edge_sides,
                                                      make_pallas_matvec)
from pylatticedso_tpu_torch.kernels.stencil import (SIDE_DTYPE, edge_sides,
                                                    side_table)
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice as TSL

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

GEOMS = {"bcc": "BCC", "octet": "Octet",
         "hybrid": ["BCC", "Hybrid1", "Hybrid4"]}


def test_wrapper_cpu_matches_pallas_interpret(monkeypatch):
    """Octet n=4 as tests/test_stencil_pallas.py runs the TPU kernel."""
    monkeypatch.setenv("PLDSO_PALLAS_ONCE", "1")
    n = 4
    js = JSL("Octet", (n, n, n), (1.0, 1.0, 1.0), 1013.0, 0.3)
    mv, _ = js.make_matvec()
    prep_p, apply_p = make_pallas_matvec(js, mv.prepare, mv.apply, tile=1024,
                                         interpret=True, align8=True)
    rng = np.random.default_rng(0)
    u = rng.standard_normal((js.nc, 6) + js.grid).astype(np.float32)
    r = (0.04 + 0.05 * rng.random((n, n, n))).astype(np.float32)
    y_pallas = np.asarray(apply_p(jnp.asarray(u), prep_p(jnp.asarray(r))))

    ts = TSL("Octet", (n, n, n), (1.0, 1.0, 1.0), 1013.0, 0.3,
             dtype=torch.float32, device="cpu")
    tm, _ = ts.make_matvec()
    y = tm.apply(torch.from_numpy(u), tm.prepare(torch.from_numpy(r)))
    assert tm.apply.launches == 0          # the CPU path launches nothing
    err = np.abs(y.numpy() - y_pallas).max() / np.abs(y_pallas).max()
    assert err < 1e-5, err


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_edge_side_table_matches_jax(name):
    n = 3
    js = JSL(GEOMS[name], (n, n, n), (1.0, 1.0, 1.0), 1013.0, 0.3)
    ts = TSL(GEOMS[name], (n, n, n), (1.0, 1.0, 1.0), 1013.0, 0.3,
             device="cpu")
    Yp, Zp = js.grid[1] + 2, js.grid[2] + 2
    ref = _edge_sides(js, Yp, Zp)
    got = edge_sides(ts, Yp, Zp)
    assert len(got) == len(ref) == 2 * len(js.edges)
    for a, b in zip(ref, got):
        for k in ("ei", "side", "cs", "co", "du", "dr", "L"):
            assert a[k] == b[k], k
        for k in ("t", "a1", "a2"):
            np.testing.assert_array_equal(a[k], b[k])

    # the kernel's table: stable sort by self class, frames in f32
    table, class_start = side_table(ts)
    assert table.dtype == SIDE_DTYPE and SIDE_DTYPE.itemsize == 64
    assert class_start[0] == 0 and class_start[-1] == len(ref)
    order = sorted(range(len(ref)), key=lambda i: ref[i]["cs"])
    for j, i in enumerate(order):
        rec = ref[i]
        assert class_start[rec["cs"]] <= j < class_start[rec["cs"] + 1]
        assert (table["co"][j], table["du"][j], table["dr"][j],
                table["ei"][j], table["side"][j]) == (
            rec["co"], rec["du"], rec["dr"], rec["ei"], rec["side"])
        np.testing.assert_array_equal(table["t"][j],
                                      np.float32(rec["t"]))
        assert table["invL"][j] == np.float32(1.0 / rec["L"])


def test_launch_refuses_cpu_tensors():
    ts = TSL("BCC", (2, 2, 2), (1.0, 1.0, 1.0), 1013.0, 0.3, device="cpu")
    tm, _ = ts.make_matvec()
    up = torch.zeros((ts.nc, 6) + tuple(g + 2 for g in ts.grid))
    r2p = tm.prepare(torch.tensor(0.05))
    with pytest.raises(ValueError, match="CUDA"):
        tm.apply.launch(up, r2p)
    assert tm.apply.launches == 0
