"""B1's VJP (``kernels/stencil.py`` ``_B1``, the counterpart of the JAX
kernel's ``custom_vjp``, ``stencil_pallas.py:575-588``) on the CPU, where
its forward and u-cotangent are the plain gather form and its
r^2-cotangent the plain closed form ``apply_gather_vjp_r2``:

* ``torch.autograd.gradcheck`` in float64 (Octet n=2);
* the closed form against autograd of the gather form in float64, at
  every r^2 position (ghosts included), on three templates (1e-12);
* both cotangents against the JAX Pallas kernel's ``custom_vjp`` in
  interpret mode, float32 (1e-5, relative to each cotangent's largest
  value: the two sum in other orders).
The kernels themselves are held to these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu.parallel.stencil_pallas import make_pallas_matvec
from pylatticedso_tpu.parallel.structured import StructuredLattice as JSL
from pylatticedso_tpu_torch import convert
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice as TSL

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

GEOMS = {"bcc": "BCC", "octet": "Octet",
         "hybrid": ["BCC", "Hybrid1", "Hybrid4"]}


def _operands(ts, seed, dtype):
    rng = np.random.default_rng(seed)
    shape = (ts.nc, 6) + ts.grid
    u = torch.tensor(rng.standard_normal(shape), dtype=dtype)
    g = torch.tensor(rng.standard_normal(shape), dtype=dtype)
    r = torch.tensor(0.04 + 0.05 * rng.random((ts.n_geom,) + ts.num_cells),
                     dtype=dtype)
    return u, g, r


def test_gradcheck_f64():
    ts = TSL("Octet", (2, 2, 2), (1.0,) * 3, 1013.0, 0.3,
             dtype=torch.float64, device="cpu")
    mv, _ = ts.make_matvec()
    u, _g, r = _operands(ts, 0, torch.float64)
    r2p = mv.prepare(r).requires_grad_(True)
    assert torch.autograd.gradcheck(mv.apply, (u.requires_grad_(True), r2p))
    # and through prepare, to the radius itself
    rr = r.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x: mv.apply(u.detach(), mv.prepare(x)), (rr,))


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_closed_form_matches_autograd_of_gather(name):
    ts = TSL(GEOMS[name], (3, 2, 3), (1.0,) * 3, 1013.0, 0.3,
             dtype=torch.float64, device="cpu")
    mv, _ = ts.make_matvec()
    u, g, r = _operands(ts, len(name), torch.float64)
    r2p = mv.prepare(r).requires_grad_(True)
    (want,) = torch.autograd.grad(mv.apply_gather(u, r2p), r2p, g)
    got = mv.apply_gather_vjp_r2(g, u, r2p.detach())
    assert float(want.abs().max()) > 0
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-12, err
    # through the wrapper's backward: the same
    uq = u.clone().requires_grad_(True)
    mv.apply(uq, r2p).backward(g)
    assert torch.equal(r2p.grad, got)
    assert mv.apply.launches == mv.apply.launches_vjp == 0   # CPU: none


def test_cotangents_match_jax_custom_vjp():
    """Octet n=4, float32, as tests/test_stencil_pallas.py runs the TPU
    kernel."""
    n = 4
    js = JSL("Octet", (n,) * 3, (1.0,) * 3, 1013.0, 0.3)
    jm, _ = js.make_matvec()
    prep_p, apply_p = make_pallas_matvec(js, jm.prepare, jm.apply,
                                         interpret=True)
    ts = TSL("Octet", (n,) * 3, (1.0,) * 3, 1013.0, 0.3,
             dtype=torch.float32, device="cpu")
    mv, _ = ts.make_matvec()
    u, g, r = _operands(ts, 7, torch.float32)
    r2f = prep_p(jnp.asarray(r.numpy()[0]))
    _y, vjp = jax.vjp(apply_p, jnp.asarray(u.numpy()), r2f)
    gu_j, gr_j = vjp(jnp.asarray(g.numpy()))
    padded = tuple(x + 2 for x in ts.grid)
    gr_j = convert._field(np.asarray(gr_j), len(ts.edges), padded)
    uq = u.clone().requires_grad_(True)
    r2p = mv.prepare(r[0]).requires_grad_(True)
    mv.apply(uq, r2p).backward(g)
    for want, got in ((np.asarray(gu_j), uq.grad), (gr_j, r2p.grad)):
        assert np.abs(want).max() > 0
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, err
