"""Card-only tests of the port: the kernels B1-B5 against their plain
versions and the main path's routes at a small size.  They import no JAX,
so they run on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA card every test skips (the card is looked for inside each
test, never at import).
"""

import numpy as np
import pytest
import torch

from pylatticedso_tpu_torch import smoke
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice

GEOMS = {"bcc": "BCC", "octet": "Octet",
         "hybrid": ["BCC", "Hybrid1", "Hybrid4"]}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name,n", [("octet", 50), ("octet", 7),
                                    ("bcc", 5), ("hybrid", 6)])
def test_kernel_matches_plain_on_card(name, n):
    _need_card()
    ts = StructuredLattice(GEOMS[name], (n, n, n), (1.0, 1.0, 1.0), 1013.0,
                           0.3, dtype=torch.float32, device="cuda")
    tm, _ = ts.make_matvec()
    g = torch.Generator(device="cuda").manual_seed(n)
    u = torch.randn((ts.nc, 6) + ts.grid, generator=g, device="cuda")
    r = 0.04 + 0.05 * torch.rand((ts.n_geom, n, n, n), generator=g,
                                 device="cuda")
    aux = tm.prepare(r)
    y_plain = tm.apply_gather(u, aux)
    y = tm.apply(u, aux)
    y2 = tm.apply(u, aux)
    torch.cuda.synchronize()
    assert tm.apply.launches == 2
    assert torch.equal(y, y2)                     # no atomics: bitwise
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err < 1e-5, err
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.apply(u.double(), aux.double())


@pytest.mark.gpu
def test_main_path_small_on_card():
    _need_card()
    rep = smoke.main_path_phase(torch.device("cuda"), 8, steps=3,
                                windows=1)
    assert rep["bitwise"] and rep["finite"]
    assert all(x > 0 for x in rep["launches_per_level"])
    assert rep["compliance_rel_err"] <= 1e-5
    assert np.isfinite(rep["compliance"])


@pytest.mark.gpu
@pytest.mark.parametrize("name,n", [("octet", 50), ("octet", 13),
                                    ("octet", 7), ("hybrid", 6)])
def test_lo_and_fused_kernels_match_plain_on_card(name, n):
    """B2-B5 against their plain versions on the card, in f32 and bf16
    storage (B5 only where the routing marks the grid single)."""
    _need_card()
    from pylatticedso_tpu_torch.kernels.fused import cheb_static
    ts = StructuredLattice(GEOMS[name], (n, n, n), (1.0, 1.0, 1.0), 1013.0,
                           0.3, dtype=torch.float32, device="cuda")
    tm, diag = ts.make_matvec()
    B, fz = tm.apply, tm.apply.fused
    g = torch.Generator(device="cuda").manual_seed(n)
    shape = (ts.nc, 6) + ts.grid
    u = torch.randn(shape, generator=g, device="cuda")
    r = 0.04 + 0.05 * torch.rand((ts.n_geom, n, n, n), generator=g,
                                 device="cuda")
    aux = tm.prepare(r)
    u16, a16 = u.to(torch.bfloat16), aux.to(torch.bfloat16)
    y = B.lo(u16, a16)
    assert torch.equal(y, B.lo(u16, a16))          # bitwise repeat
    yp = B.plain_lo(u16, a16)
    assert B.launches_lo == 2
    assert float((y.float() - yp.float()).abs().max()
                 / yp.float().abs().max()) < 1e-2

    def rel(a, b):
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        return max(float((x.float() - w.float()).abs().max()
                         / w.float().abs().max()) for x, w in zip(a, b))

    # the level's own Jacobi diagonal and lmax keep the smoother bounded
    from pylatticedso_tpu_torch.parallel.multigrid import _estimate_lmax
    D = torch.where(diag(r) == 0, 1.0, diag(r))
    lmax = _estimate_lmax(lambda v: tm.apply(v, aux), D, shape,
                          torch.float32, iters=10)
    sc = fz.sc(lmax, 0.35)
    (c1, c2), (c1f, c2f) = cheb_static(0.35, 2)
    for io, tol in ((torch.float32, (1e-5, 2e-5)),
                    (torch.bfloat16, (1e-2, 1e-2))):
        P = lambda a: torch.nn.functional.pad(a, (1,) * 6).to(io)
        x, fd, r2 = P(u), P(1.0 / D), aux.to(io)
        b, d = P(torch.randn(shape, generator=g, device="cuda")), P(u / D)
        out = fz.residual(b, x, fd, r2)
        assert rel(out, fz.plain_residual(b, x, fd, r2)) < tol[0]
        for c1_, c2_, final in ((c1, c2, False), (c1f, c2f, True)):
            got = fz.cheb_run(x, b, d, fd, sc, r2, c1_, c2_, final)
            want = fz.plain_cheb_run(x, b, d, fd, sc, r2, c1_, c2_, final)
            assert rel(got, want) < tol[1]
        if fz.single_ok:
            for x0, deg in ((None, 24), (x, 2)):
                got = fz.cheb_full(b, x0, fd, sc, r2, 0.35, deg)
                want = fz.plain_cheb_full(b, x0, fd, sc, r2, 0.35, deg)
                assert rel(got, want) < tol[1]
                assert torch.equal(got, fz.cheb_full(b, x0, fd, sc, r2,
                                                     0.35, deg))
    torch.cuda.synchronize()
    assert fz.launches["residual"] == 2 and fz.launches["cheb_run"] == 4


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fused", "lo"])
def test_routes_small_on_card(route):
    _need_card()
    rep = smoke.main_path_phase(torch.device("cuda"), 8, route=route,
                                steps=3, windows=1)
    assert rep["bitwise"] and rep["finite"]
    assert rep["compliance_rel_err"] <= 1e-5
