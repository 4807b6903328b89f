"""Card-only tests of the port: the kernels B1 (float32, float64 and its
VJP), B2-B5, B3c-B5c, P1 and P2 against their plain versions, and the
main path's routes and the design-gradient paths at a small size.  They import no JAX,
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
    # B1 takes float32 or float64 of one type, never a mix
    with pytest.raises(ValueError, match="one type"):
        tm.apply(u.double(), aux)


@pytest.mark.gpu
@pytest.mark.parametrize("name,n", [("octet", 50), ("octet", 7),
                                    ("hybrid", 6)])
def test_f64_kernel_matches_plain_on_card(name, n):
    """B1's float64 instance against the float64 gather form (1e-12,
    relative to the plain result's largest value), bitwise on repeat."""
    _need_card()
    ts = StructuredLattice(GEOMS[name], (n, n, n), (1.0, 1.0, 1.0), 1013.0,
                           0.3, dtype=torch.float64, device="cuda")
    tm, _ = ts.make_matvec()
    g = torch.Generator(device="cuda").manual_seed(n)
    u = torch.randn((ts.nc, 6) + ts.grid, generator=g, device="cuda",
                    dtype=torch.float64)
    r = 0.04 + 0.05 * torch.rand((ts.n_geom, n, n, n), generator=g,
                                 device="cuda", dtype=torch.float64)
    aux = tm.prepare(r)
    y_plain = tm.apply_gather(u, aux)
    y = tm.apply(u, aux)
    assert torch.equal(y, tm.apply(u, aux))
    torch.cuda.synchronize()
    assert tm.apply.launches_f64 == 2 and tm.apply.launches == 0
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err <= 1e-12, err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_b1_backward_matches_autograd_on_card(dtype, tol):
    """B1's VJP through backward(): the u-cotangent (B1 on the cotangent)
    and the r^2-cotangent (its own kernel) against autograd of the plain
    gather form, each launched once during the backward."""
    _need_card()
    n = 13
    ts = StructuredLattice("Octet", (n, n, n), (1.0, 1.0, 1.0), 1013.0,
                           0.3, dtype=dtype, device="cuda")
    tm, _ = ts.make_matvec()
    g = torch.Generator(device="cuda").manual_seed(5)
    shape = (ts.nc, 6) + ts.grid
    u = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    lam = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    r = 0.04 + 0.05 * torch.rand((n, n, n), generator=g, device="cuda",
                                 dtype=dtype)
    aux = tm.prepare(r)
    uq, aq = u.clone().requires_grad_(True), aux.clone().requires_grad_(True)
    want = torch.autograd.grad(tm.apply_gather(uq, aq), (uq, aq), lam)
    uq, aq = u.clone().requires_grad_(True), aux.clone().requires_grad_(True)
    y = tm.apply(uq, aq)
    B = tm.apply
    counter = "launches_f64" if dtype == torch.float64 else "launches"
    before = (getattr(B, counter), B.launches_vjp)
    y.backward(lam)
    torch.cuda.synchronize()
    assert (getattr(B, counter) - before[0], B.launches_vjp - before[1]) \
        == (1, 1)
    for got, ref in zip((uq.grad, aq.grad), want):
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= tol, err
    # the r^2-cotangent sums in a fixed order: bitwise on repeat
    up, gp = torch.nn.functional.pad(u, (1,) * 6), \
        torch.nn.functional.pad(lam, (1,) * 6)
    assert torch.equal(B.launch_vjp(up, gp, aux), B.launch_vjp(up, gp, aux))


@pytest.mark.gpu
def test_probes_match_plain_on_card():
    """P1 (both kinds) and P2 bitwise equal to their plain versions."""
    _need_card()
    from pylatticedso_tpu_torch import probes
    xs = probes.inputs("cuda")
    for kind in ("1d", "2d"):
        assert torch.equal(probes.chain(xs["chain"], kind),
                           probes.plain_chain(xs["chain"], kind))
        # one launch of 20 x REPS repeats: the same values
        assert torch.equal(probes.chain(xs["chain"], kind,
                                        reps=20 * probes.REPS),
                           probes.plain_chain(xs["chain"], kind))
    assert torch.equal(probes.scale(xs["scale"]),
                       probes.plain_scale(xs["scale"]))
    assert probes.launches["chain"] >= 2 and probes.launches["scale"] >= 1


@pytest.mark.gpu
def test_design_paths_small_on_card():
    """The design-gradient paths (a)-(c) at n=8 under their gates."""
    _need_card()
    rep = smoke.design_phase(torch.device("cuda"), 8, steps=2, windows=1)
    assert rep["a"]["grad_rel_err"] <= smoke.IMPLICIT_VS_ANALYTIC_TOL
    assert rep["b"]["fd_rel_err"] <= smoke.FD_TOL
    assert rep["c"]["bitwise"] and rep["c"]["plain_gather_calls"] == 0


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
@pytest.mark.parametrize("route", ["fused", "lo", "fused-bf16c"])
def test_routes_small_on_card(route):
    _need_card()
    rep = smoke.main_path_phase(torch.device("cuda"), 8, route=route,
                                steps=3, windows=1)
    assert rep["bitwise"] and rep["finite"]
    assert rep["compliance_rel_err"] <= 1e-5


def _b5_level(cells, storage):
    """An Octet level of ``cells``^3 with the smoother's inputs, as the
    V-cycle holds them (its own diagonal and lmax keep the polynomial
    bounded), ghost-padded in ``storage``."""
    from pylatticedso_tpu_torch.parallel.multigrid import _estimate_lmax
    io = smoke.STORAGE[storage]
    ts = StructuredLattice("Octet", (cells,) * 3, (1.0, 1.0, 1.0), 1013.0,
                           0.3, dtype=torch.float32, device="cuda")
    tm, diag = ts.make_matvec()
    fz = tm.apply.fused
    g = torch.Generator(device="cuda").manual_seed(cells)
    shape = (ts.nc, 6) + ts.grid
    fixed = ts.select_nodes(lambda x, y, z: z == 0.0)
    fm = torch.as_tensor(np.ascontiguousarray(np.broadcast_to(
        (ts.node_valid & ~fixed)[:, None], shape), np.float32), device="cuda")
    u = torch.randn(shape, generator=g, device="cuda")
    b = torch.randn(shape, generator=g, device="cuda") * fm
    r = 0.04 + 0.05 * torch.rand((ts.n_geom, cells, cells, cells),
                                 generator=g, device="cuda")
    aux = tm.prepare(r)
    D = fm * diag(r) + (1.0 - fm)
    D = torch.where(D == 0, torch.ones_like(D), D)
    lmax = _estimate_lmax(lambda v: fm * tm.apply(fm * v, aux)
                          + (1.0 - fm) * v, D, shape, torch.float32, iters=5)
    P = lambda a: torch.nn.functional.pad(a, (1,) * 6).to(io)
    return fz, io, lmax, P(b), P(u * fm), P(fm / D), aux.to(io)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("cells", [7, 4, 2])
def test_b5_same_bits_for_every_cluster_and_layout_on_card(cells, storage):
    """B5 on the 50^3 hierarchy's single levels (7^3, 4^3, 2^3): within
    STORAGE_TOL of its plain version, bitwise on repeat, and the same bits
    under every cluster size and layout of d the card can run, the
    global-d layout included; at 7^3 the plan spreads the level over more
    than one SM."""
    _need_card()
    from pylatticedso_tpu_torch.kernels.fused import B5_CLUSTERS, B5_LAYOUTS
    fz, io, lmax, b, x, fd, r2 = _b5_level(cells, storage)
    assert fz.single_ok
    tol = smoke.STORAGE_TOL[storage]["B5"]
    cases = [(None, 2, 0.35), (x, 2, 0.35)]
    if cells == 2:
        cases.append((None, 24, 1.0 / 64.0))
    for x0, deg, frac in cases:
        sc = fz.sc(lmax, frac)
        run = lambda **kw: fz.cheb_full(b, x0, fd, sc, r2, frac, deg, **kw)
        want = run()
        plain = fz.plain_cheb_full(b, x0, fd, sc, r2, frac, deg)
        err = float((want.float() - plain.float()).abs().max()
                    / plain.float().abs().max())
        assert err <= tol, err
        assert torch.equal(want, run())
        plan = fz.b5_plan(io, x0 is not None, device=0)
        if cells == 7:
            assert plan["cluster"] > 1
        ran = set()
        for layout in B5_LAYOUTS:
            for cluster in B5_CLUSTERS:
                try:
                    fz.b5_plan(io, x0 is not None, cluster, layout, 0)
                except ValueError:
                    continue
                got = run(cluster=cluster, layout=layout)
                assert torch.equal(got, want), (cluster, layout)
                ran.add((cluster, layout))
        assert any(lay == "global" for _, lay in ran)
        assert len({c for c, _ in ran}) >= (3 if cells > 2 else 2)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_p2_bitwise_on_card():
    """P2 is x * 2 bit for bit, on values other than ones too."""
    _need_card()
    from pylatticedso_tpu_torch import probes
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(probes.SCALE_SHAPE, generator=g, device="cuda") * 1e30
    assert torch.equal(probes.scale(x), x * 2)


@pytest.mark.gpu
def test_launch_stream_follows_a_side_stream_on_card():
    """The launch helper's stream handle is the public current stream's,
    on a side stream too, and a kernel launched there runs after the
    producer queued before it on that stream."""
    _need_card()
    from pylatticedso_tpu_torch import probes
    from pylatticedso_tpu_torch.kernels import launch
    x = torch.zeros(probes.SCALE_SHAPE, device="cuda")
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    assert launch.stream(0) == torch.cuda.current_stream().cuda_stream
    with torch.cuda.stream(side):
        assert launch.stream(0) == torch.cuda.current_stream().cuda_stream \
            == side.cuda_stream
        torch.cuda._sleep(50_000_000)      # keep the side stream busy
        x.fill_(3.0)                       # the producer
        y = probes.scale(x)                # must see the 3s
    side.synchronize()
    assert torch.equal(y, torch.full_like(x, 6.0))
    assert launch.stream(0) == torch.cuda.current_stream().cuda_stream


def _slab_inputs(name, cells, dtype, seed):
    ts = StructuredLattice(GEOMS[name], cells, (1.0, 1.0, 1.0), 1013.0, 0.3,
                           dtype=dtype, device="cuda")
    tm, diag = ts.make_matvec()
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((ts.nc, 6) + ts.grid, generator=g, device="cuda",
                    dtype=dtype)
    r = 0.04 + 0.05 * torch.rand((ts.n_geom,) + tuple(cells), generator=g,
                                 device="cuda", dtype=dtype)
    return ts, tm, diag, u, r, tm.prepare(r)


def _repeat(run):
    """``run()`` twice: the same bits both times."""
    want = run()
    got = run()
    got, ref = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    return want


SLAB_CASES = [("octet", (c,) * 3) for c in smoke.level_cells(50)] \
    + [("octet", (5, 6, 7)), ("octet", (13, 13, 13)), ("bcc", (5, 6, 7)),
       ("hybrid", (6, 6, 6)), ("hybrid", (5, 6, 7))]


@pytest.mark.gpu
@pytest.mark.parametrize("name,cells", SLAB_CASES)
def test_slab_b1_b2_match_plain_on_card(name, cells):
    """B1 (float32, float64) and B2 against their plain versions on grids
    no slab divides, every 50^3 level and the 16-class hybrid; bitwise on
    repeat."""
    _need_card()
    pad = lambda a: torch.nn.functional.pad(a, (1,) * 6)
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        ts, tm, _, u, _, aux = _slab_inputs(name, cells, dtype, sum(cells))
        B = tm.apply
        up = pad(u)
        y = _repeat(lambda: B.launch(up, aux))
        want = tm.apply_gather(u, aux)
        err = float((y - want).abs().max() / want.abs().max())
        assert err <= tol, (dtype, err)
        if dtype == torch.float32:
            u16, a16 = u.to(torch.bfloat16), aux.to(torch.bfloat16)
            y16 = _repeat(lambda: B.launch(pad(u16), a16))
            want16 = B.plain_lo(u16, a16).float()
            err = float((y16.float() - want16).abs().max()
                        / want16.abs().max())
            assert err < 1e-2, err
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name,cells", SLAB_CASES)
def test_slab_b4_matches_plain_and_zeros_ghosts_on_card(name, cells,
                                                        monkeypatch):
    """B4 (float32 and bf16 storage, a step and the final emit) against
    its plain version; its outputs start from NaN-filled ``torch.empty``
    and every ghost point comes back zero; bitwise on repeat."""
    _need_card()
    from pylatticedso_tpu_torch.kernels.fused import cheb_static
    ts, tm, diag, u, r, aux = _slab_inputs(name, cells, torch.float32,
                                            7 + sum(cells))
    fz = tm.apply.fused
    g = torch.Generator(device="cuda").manual_seed(1)
    D = diag(r)
    D = torch.where(D == 0, torch.ones_like(D), D)
    sc = fz.sc(torch.tensor(8.0, device="cuda") * D.max(), 0.35)
    steps = cheb_static(0.35, 2)
    nan_empty = lambda t, **kw: torch.full_like(t, float("nan"), **kw)
    for io, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
        P = lambda a: torch.nn.functional.pad(a, (1,) * 6).to(io)
        x, d, fd = P(u), P(u / D), P(1.0 / D)
        rr = P(torch.randn(u.shape, generator=g, device="cuda"))
        r2 = aux.to(io)
        for final, (c1, c2) in ((False, steps[0]), (True, steps[1])):
            with monkeypatch.context() as m:
                m.setattr(torch, "empty_like", nan_empty)
                got = _repeat(lambda: fz.cheb_run(
                    x, rr, d, fd, sc, r2, c1, c2, final))
            got = got if isinstance(got, tuple) else (got,)
            want = fz.plain_cheb_run(x, rr, d, fd, sc, r2, c1, c2, final)
            want = want if isinstance(want, tuple) else (want,)
            for a, w in zip(got, want):
                assert not torch.isnan(a).any()
                inner = torch.zeros_like(a, dtype=torch.bool)
                inner[..., 1:-1, 1:-1, 1:-1] = True
                assert torch.all(a[~inner] == 0)
                err = float((a.float() - w.float()).abs().max()
                            / w.float().abs().max())
                assert err <= tol, (io, final, err)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name,cells", SLAB_CASES)
def test_slab_b3_matches_plain_and_zeros_ghosts_on_card(name, cells,
                                                        monkeypatch):
    """B3 on its slab plan (float32 and bf16 storage) against its plain
    version; its output starts from a NaN-filled ``torch.empty_like`` and
    every ghost point comes back zero; bitwise on repeat."""
    _need_card()
    ts, tm, diag, u, r, aux = _slab_inputs(name, cells, torch.float32,
                                            11 + sum(cells))
    fz = tm.apply.fused
    g = torch.Generator(device="cuda").manual_seed(2)
    D = diag(r)
    D = torch.where(D == 0, torch.ones_like(D), D)
    nan_empty = lambda t, **kw: torch.full_like(t, float("nan"), **kw)
    for io, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        P = lambda a: torch.nn.functional.pad(a, (1,) * 6).to(io)
        x, fm = P(u), P(1.0 / D)
        b = P(torch.randn(u.shape, generator=g, device="cuda"))
        r2 = aux.to(io)
        with monkeypatch.context() as m:
            m.setattr(torch, "empty_like", nan_empty)
            got = _repeat(lambda: fz.residual(b, x, fm, r2))
        want = fz.plain_residual(b, x, fm, r2)
        assert not torch.isnan(got).any()
        inner = torch.zeros_like(got, dtype=torch.bool)
        inner[..., 1:-1, 1:-1, 1:-1] = True
        assert torch.all(got[~inner] == 0)
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        assert err <= tol, (io, err)
    assert fz.b3_plan(torch.bfloat16, 0)["blocks_per_sm"] > 0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name,cells", SLAB_CASES)
def test_beam_r2_matches_plain_on_card(name, cells, monkeypatch):
    """The r^2-cotangent kernel (float32 and float64) against its plain
    closed form, its output NaN-filled before the launch so that every
    position must be written (the border anchors, whose endpoints leave
    the padded grid, write zero); g's ghost values are dropped (NaN there
    changes nothing); bitwise on repeat."""
    _need_card()
    pad = lambda a: torch.nn.functional.pad(a, (1,) * 6)
    nan_empty = lambda t, **kw: torch.full_like(t, float("nan"), **kw)
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        ts, tm, _, u, _, aux = _slab_inputs(name, cells, dtype,
                                            3 + sum(cells))
        B = tm.apply
        g = torch.randn(u.shape, generator=torch.Generator(
            device="cuda").manual_seed(9), device="cuda", dtype=dtype)
        up, gp = pad(u), pad(g)
        with monkeypatch.context() as m:
            m.setattr(torch, "empty_like", nan_empty)
            got = _repeat(lambda: B.launch_vjp(up, gp, aux))
            gnan = pad(g) + 0.0
            gnan[..., 0, :, :] = float("nan")
            gnan[..., -1, :, :] = float("nan")
            assert torch.equal(B.launch_vjp(up, gnan, aux), got)
        want = B.plain_vjp_r2(g, u, aux)
        assert not torch.isnan(got).any()
        assert torch.all(got[want == 0] == 0)
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= tol, (dtype, err)
        assert B.beam_plan(dtype, 0)["blocks_per_sm"] > 0
    torch.cuda.synchronize()


# ------------------------------------------------------------ optimizer
def _cantilever(n, geoms, radii):
    return {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                         "number_of_cells": dict(zip("xyz", n)),
                         "radii": radii, "geom_types": geoms},
            "boundary_conditions": {
                "Displacement": {"Fixed": {
                    "Surface": ["Xmin"],
                    "DOF": ["X", "Y", "Z", "RX", "RY", "RZ"],
                    "Value": [0, 0, 0, 0, 0, 0]}},
                "Force": {"Load": {"Surface": ["Xmax"], "DOF": ["Z"],
                                   "Value": [-0.1]}}}}


@pytest.mark.gpu
@pytest.mark.parametrize("geoms,radii", [(["Octet"], [0.05]),
                                         (["BCC", "Hybrid1"], [0.05, 0.04])])
def test_optimizer_problems_on_card_match_the_cpu(geoms, radii):
    """The structured problem (float64, Jacobi: B1<double> and the
    r^2-cotangent kernel, no plain gather) and the unstructured one on the
    card against the same problems on the CPU: value and gradient within
    1e-10; the same bits on repeat on the card."""
    _need_card()
    from pylatticedso_tpu_torch.design import build_lattice
    from pylatticedso_tpu_torch.opti.optimizer import OptimizationProblem
    from pylatticedso_tpu_torch.opti.structured_optimizer import \
        StructuredOptimizationProblem
    lat = build_lattice(_cantilever((3, 2, 2), geoms, radii))
    kw = dict(opt_params={"type": "unit_cell"}, constraints={})
    for cls in (StructuredOptimizationProblem, OptimizationProblem):
        card = cls(lat, device="cuda", **kw)
        cpu = cls(lat, device="cpu", **kw)
        x = 0.3 + 0.4 * np.random.default_rng(12).random(
            card.param.n_params)
        v, g = card._value_and_grad(x)
        vc, gc = cpu._value_and_grad(x)
        assert abs(float(v) - float(vc)) <= 1e-10 * abs(float(vc))
        err = float((g.cpu() - gc).abs().max() / gc.abs().max())
        assert err <= 1e-10, (cls.__name__, err)
        if cls is StructuredOptimizationProblem:
            apply = card._step.matvec.apply
            assert apply.launches_f64 > 0 and apply.launches_vjp > 0
            assert apply.launches == 0 and card._step.matvec.plain_calls == 0
            card._u_warm = None
        v2, g2 = card._value_and_grad(x)
        assert torch.equal(v, v2) and torch.equal(g, g2)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_unstructured_segment_sums_same_bits_on_card():
    """The unstructured operator's per-node sums (K.u, diag K, the
    endpoint gather's gradient, the node energies) add in one fixed order:
    the same bits on every call on the card, and within 1e-12 of the
    CPU's."""
    _need_card()
    from pylatticedso_tpu_torch.design import build_lattice
    from pylatticedso_tpu_torch.fem.operator import build_operator
    lat = build_lattice({"geometry": {
        "cell_size": {"x": 1, "y": 1, "z": 1},
        "number_of_cells": {"x": 6, "y": 6, "z": 6}, "radii": [0.05],
        "geom_types": ["Octet"]}})
    r = 0.03 + 0.05 * np.random.default_rng(13).random(lat.num_edges)
    op = build_operator(lat.nodes, lat.edges, r, 1013.0, 0.3, device="cuda")
    u = torch.randn((lat.num_nodes, 6), dtype=torch.float64, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(14))
    w = torch.randn_like(u)

    def once():
        uu = u.clone().requires_grad_(True)
        y = op.matvec(uu)
        (gu,) = torch.autograd.grad(torch.sum(w * y), uu)
        return y.detach(), op.diagonal(), gu

    first = once()
    for _ in range(3):
        for a, b in zip(first, once()):
            assert torch.equal(a, b)
    e1 = lat.node_energies(u.cpu().numpy(), device="cuda")
    assert np.array_equal(e1, lat.node_energies(u.cpu().numpy(),
                                                device="cuda"))
    opc = build_operator(lat.nodes, lat.edges, r, 1013.0, 0.3, device="cpu")
    y_cpu = opc.matvec(u.cpu())
    err = float((first[0].cpu() - y_cpu).abs().max() / y_cpu.abs().max())
    assert err <= 1e-12, err


@pytest.mark.gpu
def test_kriging_fit_raises_without_sklearn(monkeypatch):
    """The density model's fit needs scikit-learn, imported when fit is
    called: without it (as on the card's machine) it raises ImportError;
    a loaded model evaluates on the card."""
    _need_card()
    import sys
    from pylatticedso_tpu_torch.opti.density import KrigingDensity
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError):
        KrigingDensity.fit({(0.01,): 0.0075, (0.05,): 0.113, (0.1,): 0.378})
    model = KrigingDensity(
        X_train_scaled=np.array([[-1.0], [0.0], [1.0]]),
        alpha=np.array([0.5, -0.2, 0.1]), length_scale=np.array([0.6]),
        const=0.75, y_mean=0.16, y_std=0.12, scaler_mean=np.array([0.055]),
        scaler_scale=np.array([0.029]))
    v, g = model.mean_and_grad(np.array([0.05]), device="cuda")
    vc, gc = model.mean_and_grad(np.array([0.05]), device="cpu")
    assert v.is_cuda and abs(float(v) - float(vc)) <= 1e-14
    assert abs(float(g) - float(gc)) <= 1e-12 * abs(float(gc))


@pytest.mark.gpu
@pytest.mark.parametrize("name,cells", SLAB_CASES)
def test_bf16_compute_kernels_match_plain_on_card(name, cells, monkeypatch):
    """B3c and B4c (a step and the final emit) on their slab plans, and
    B5c where the routing marks the grid single, against their plain
    versions (the dense form in bf16, every operation rounded on its own):
    the same bits (0 elements differ; within 1e-2 besides, the CPU
    parity's tolerance), in f32 and bf16 storage; bitwise on repeat; ghosts
    written zero over NaN-filled outputs; the counts of elements whose bits
    differ are printed (run with -s)."""
    _need_card()
    from pylatticedso_tpu_torch.kernels.fused import cheb_static
    ts, tm, diag, u, r, aux = _slab_inputs(name, cells, torch.float32,
                                            17 + sum(cells))
    fz = tm.apply.fused
    assert fz.dense
    g = torch.Generator(device="cuda").manual_seed(3)
    D = diag(r)
    D = torch.where(D == 0, torch.ones_like(D), D)
    sc = fz.sc(torch.tensor(8.0, device="cuda") * D.max(), 0.35)
    steps = cheb_static(0.35, 2)
    nan_empty = lambda t, **kw: torch.full_like(t, float("nan"), **kw)
    differ = {}
    for io in (torch.float32, torch.bfloat16):
        P = lambda a: torch.nn.functional.pad(a, (1,) * 6).to(io)
        x, d, fd = P(u), P(u / D), P(1.0 / D)
        rr = P(torch.randn(u.shape, generator=g, device="cuda"))
        r2 = aux.to(io)
        runs = {"B3c": (lambda: fz.residual(rr, x, fd, r2, "bf16"),
                        lambda: fz.plain_residual(rr, x, fd, r2, "bf16"))}
        for final, (c1, c2) in ((False, steps[0]), (True, steps[1])):
            runs[f"B4c {'final' if final else 'step'}"] = (
                lambda c1=c1, c2=c2, final=final: fz.cheb_run(
                    x, rr, d, fd, sc, r2, c1, c2, final, "bf16"),
                lambda c1=c1, c2=c2, final=final: fz.plain_cheb_run(
                    x, rr, d, fd, sc, r2, c1, c2, final, "bf16"))
        if fz.single_ok:
            for x0, deg in ((None, 2), (x, 2)):
                runs[f"B5c x0={x0 is not None}"] = (
                    lambda x0=x0, deg=deg: fz.cheb_full(
                        rr, x0, fd, sc, r2, 0.35, deg, compute="bf16"),
                    lambda x0=x0, deg=deg: fz.plain_cheb_full(
                        rr, x0, fd, sc, r2, 0.35, deg, "bf16"))
        for key, (run, plain) in runs.items():
            with monkeypatch.context() as m:
                m.setattr(torch, "empty_like", nan_empty)
                got = _repeat(run)
            got = got if isinstance(got, tuple) else (got,)
            want = plain()
            want = want if isinstance(want, tuple) else (want,)
            n = 0
            for a, w in zip(got, want):
                assert not torch.isnan(a).any()
                inner = torch.zeros_like(a, dtype=torch.bool)
                inner[..., 1:-1, 1:-1, 1:-1] = True
                assert torch.all(a[~inner] == 0)
                err = float((a.float() - w.float()).abs().max()
                            / w.float().abs().max())
                assert err <= 1e-2, (io, key, err)
                n += smoke._bits_differ(a, w)
            differ[(str(io), key)] = n
            assert n == 0, (io, key, n)
    print(f"\n{name} {cells}: elements whose bits differ from the plain "
          f"version's {differ}")
    assert fz.launches["residual_bf16c"] == 4
    assert fz.launches["cheb_run_bf16c"] == 8
    assert fz.launches["residual"] == fz.launches["cheb_run"] == 0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("cells", [7, 4, 2])
def test_b5c_same_bits_for_every_cluster_and_layout_on_card(cells, storage):
    """B5c on the 50^3 hierarchy's single levels: the same bits as its
    plain version (and within 1e-2 of it, the CPU parity's tolerance),
    bitwise on repeat and the same bits under every cluster size, layout
    of d and group size G the card can run."""
    _need_card()
    from pylatticedso_tpu_torch.kernels.fused import (B5_CLUSTERS,
                                                      B5_LAYOUTS, B5C_GROUPS)
    fz, io, lmax, b, x, fd, r2 = _b5_level(cells, storage)
    assert fz.single_ok and fz.dense
    cases = [(None, 2, 0.35), (x, 2, 0.35)]
    if cells == 2:
        cases.append((None, 24, 1.0 / 64.0))
    for x0, deg, frac in cases:
        sc = fz.sc(lmax, frac)
        run = lambda **kw: fz.cheb_full(b, x0, fd, sc, r2, frac, deg,
                                        compute="bf16", **kw)
        want = run()
        plain = fz.plain_cheb_full(b, x0, fd, sc, r2, frac, deg, "bf16")
        err = float((want.float() - plain.float()).abs().max()
                    / plain.float().abs().max())
        assert err <= smoke.STORAGE_TOL[storage]["B5c"], err
        assert smoke._bits_differ(want, plain) == 0
        assert torch.equal(want, run())
        ran = set()
        for layout in B5_LAYOUTS:
            for cluster in B5_CLUSTERS:
                for group in B5C_GROUPS:
                    try:
                        fz.b5_plan(io, x0 is not None, cluster, layout, 0,
                                   "bf16", group)
                    except ValueError:
                        continue
                    assert torch.equal(run(cluster=cluster, layout=layout,
                                           group=group), want), \
                        (cluster, layout, group)
                    ran.add((cluster, layout, group))
        assert any(lay == "global" for _, lay, _ in ran)
        assert {g for _, _, g in ran} == set(B5C_GROUPS)
    assert fz.launches["cheb_full_bf16c"] > 0 and \
        fz.launches["cheb_full"] == 0
    torch.cuda.synchronize()


def _bench2(n):
    """bench.py's second mode at n^3 (``smoke_statics.bench2_config``)."""
    from pylatticedso_tpu_torch.design import build_lattice
    from pylatticedso_tpu_torch.fem.bc import apply_boundary_conditions
    from pylatticedso_tpu_torch.smoke_statics import bench2_config
    lat = build_lattice(bench2_config(n))
    return lat, apply_boundary_conditions(lat)


@pytest.mark.gpu
@pytest.mark.parametrize("precond", ["block_jacobi", "jacobi"])
def test_sharded_step_on_card_matches_the_cpu(precond):
    """The edge-sharded step (float64) on the card against the CPU: step
    and step.chunked within 1e-10 (c, g, u), the same CG iterations, and
    the same bits on repeat on the card."""
    _need_card()
    from pylatticedso_tpu_torch.parallel.sharding import (
        ShardedLattice, make_compliance_step, make_mesh)
    lat, bc = _bench2(5)
    out = {}
    for dev in ("cuda", "cpu"):
        shl = ShardedLattice(make_mesh(devices=[dev]), lat.nodes, lat.edges,
                             1013.0, 0.3, dtype=torch.float64)
        step = make_compliance_step(shl, ~bc.fixed, bc.f_applied, tol=1e-11,
                                    maxiter=5000, preconditioner=precond)
        r = shl.radius_padded(lat.radius)
        c, g = step(r)
        cc, gc, u, _ = step.chunked(r, chunk=128)
        out[dev] = (c, g, cc, gc, u, step.chunked.last_iterations)
        if dev == "cuda":
            c2, g2 = step(r)
            cc2, gc2, u2, _ = step.chunked(r, chunk=128)
            for a, b in zip((c, g, cc, gc, u), (c2, g2, cc2, gc2, u2)):
                assert torch.equal(a, b)
    for a, b in zip(out["cuda"][:5], out["cpu"][:5]):
        err = float((a.cpu() - b).abs().max() / b.abs().max())
        assert err <= 1e-10, err
    assert out["cuda"][5] == out["cpu"][5]
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_sharded_f32_step_same_bits_on_card():
    """The float32 chunked step of bench.py's second mode: a warm step
    repeated from the same (r, u) gives the same bits."""
    _need_card()
    from pylatticedso_tpu_torch.parallel.sharding import (
        ShardedLattice, make_compliance_step, make_mesh)
    lat, bc = _bench2(8)
    shl = ShardedLattice(make_mesh(), lat.nodes, lat.edges, 1013.0, 0.3)
    step = make_compliance_step(shl, ~bc.fixed, bc.f_applied, tol=1e-6)
    r = shl.radius_padded(lat.radius)
    _, _, u, _ = step.chunked(r)
    a = step.chunked(r * 1.001, u)
    b = step.chunked(r * 1.001, u)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    assert a[2].dtype == torch.float32 and step.chunked.last_converged


@pytest.mark.gpu
def test_statics_and_homogenization_on_card_match_the_cpu():
    """``solve_fem`` (plain and penalized), ``solve_fem_cell`` and
    ``homogenize_cell`` in float64 on the card against the CPU within
    1e-10, the same bits on repeat on the card."""
    _need_card()
    from pylatticedso_tpu_torch.design import build_lattice
    from pylatticedso_tpu_torch.fem.homogenization import homogenize_cell
    from pylatticedso_tpu_torch.fem.statics import solve_fem
    from pylatticedso_tpu_torch.sim.boundary_order import boundary_node_order
    from pylatticedso_tpu_torch.sim.utils_simulation import solve_fem_cell
    from pylatticedso_tpu_torch.smoke_statics import (OCTET_CELL,
                                                      flexion_config)
    lat = build_lattice(flexion_config((2, 1, 1)))
    cell = build_lattice(OCTET_CELL)
    nb = len(boundary_node_order(cell.nodes, [0, 1, 0, 1, 0, 1]))
    u_b = np.random.default_rng(15).normal(size=(nb, 6)) * 1e-3
    runs = [lambda d: solve_fem(lat, subdivide_h=0.25, device=d),
            lambda d: solve_fem(lat, penalization=True, device=d),
            lambda d: solve_fem_cell(cell, 0, u_b, target_h=0.1, device=d)]
    for fn in runs:
        a, b, c = fn("cuda"), fn("cuda"), fn("cpu")
        assert np.array_equal(a.u, b.u) and np.array_equal(a.reaction,
                                                           b.reaction)
        for x, y in ((a.u, c.u), (a.reaction, c.reaction)):
            assert np.abs(x - y).max() <= 1e-10 * np.abs(y).max()
        assert abs(a.compliance - c.compliance) <= 1e-10 * abs(c.compliance)
    h, h2 = homogenize_cell(cell, device="cuda"), homogenize_cell(
        cell, device="cuda")
    hc = homogenize_cell(cell, device="cpu")
    assert np.array_equal(h.C, h2.C)
    assert np.abs(h.C - hc.C).max() <= 1e-10 * np.abs(hc.C).max()


def _ddm_lattice(cells=(2, 1, 1)):
    from pylatticedso_tpu_torch.design import build_lattice
    from pylatticedso_tpu_torch.smoke_ddm import tpb_config
    return build_lattice(tpb_config(cells))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_solve_ddm_on_card_matches_the_cpu(dtype):
    """``solve_ddm`` on the penalized three-point-bending lattice: the
    float64 system on the card within 1e-10 of the CPU's, the float32
    operator (the card's default) with the refined solve within 1e-8; the
    same bits on repeat on the card."""
    _need_card()
    from pylatticedso_tpu_torch.ddm.solver import build_ddm_system, solve_ddm
    lat = _ddm_lattice()
    sys_ = build_ddm_system(lat, dtype=None if dtype == torch.float32
                            else dtype, device="cuda")
    assert sys_.S[0].dtype == dtype
    cpu = solve_ddm(lat, tol=1e-12, device="cpu")
    a = solve_ddm(lat, system=sys_, tol=1e-12)
    b = solve_ddm(lat, system=sys_, tol=1e-12)
    assert np.array_equal(a.u, b.u) and a.compliance == b.compliance
    tol = 1e-10 if dtype == torch.float64 else 1e-8
    assert np.abs(a.u - cpu.u).max() <= tol * np.abs(cpu.u).max()
    assert abs(a.compliance - cpu.compliance) <= tol * abs(cpu.compliance)


@pytest.mark.gpu
def test_chained_schur_on_card_matches_the_cpu():
    """The chained condensation of the three-geometry cell over a batch of
    radii: within 1e-12 of the CPU's, the same bits on repeat (the
    junction assembly is an ordered sum)."""
    _need_card()
    from pylatticedso_tpu_torch.ddm.schur import (discretize_cell_chained,
                                                  schur_batch_chained)
    lat = _ddm_lattice()
    disc = discretize_cell_chained(lat, 0, share_weights=True)
    mus = np.random.default_rng(16).uniform(0.01, 0.1, size=(64, 3))
    a = schur_batch_chained(disc, mus, 1013.0, 0.3, device="cuda")
    b = schur_batch_chained(disc, mus, 1013.0, 0.3, device="cuda")
    c = schur_batch_chained(disc, mus, 1013.0, 0.3, device="cpu")
    assert torch.equal(a, b)
    assert float((a.cpu() - c).abs().max() / c.abs().max()) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "matrix_free"])
def test_surrogate_value_and_gradient_same_bits_on_card(dense, monkeypatch,
                                                        tmp_path):
    """A surrogate-DDM value-and-gradient on the card repeated from the
    same theta and warm start gives the same bits (the gathers' gradients
    and the dense interface matrix are ordered sums), on both refined
    branches, and agrees with the CPU's plain float64 solve."""
    _need_card()
    from pylatticedso_tpu_torch.opti import ddm_optimizer
    monkeypatch.chdir(tmp_path)
    if not dense:
        monkeypatch.setattr(ddm_optimizer, "DENSE_MAX_DOF", 0)
    lat = _ddm_lattice()
    kw = dict(opt_params={"type": "unit_cell"}, constraints={},
              cg_tol=1e-11, cg_maxiter=2000, grid_step=0.0225)
    prob = ddm_optimizer.DDMOptimizationProblem(lat, device="cuda", **kw)
    assert prob.refined and (prob._dense is not None) == dense
    x = np.clip(prob.param.x0 + 0.05, 0.0, 1.0)
    u0 = torch.zeros((lat.num_nodes, 6), dtype=torch.float64, device="cuda")
    (va, ua), ga = prob._vg_aux(x, u0)
    (vb, ub), gb = prob._vg_aux(x, u0)
    assert torch.equal(va, vb) and torch.equal(ga, gb) and torch.equal(ua, ub)
    cpu = ddm_optimizer.DDMOptimizationProblem(
        lat, device="cpu", surrogate=ddm_optimizer.SchurSurrogate(
            prob._surrogate.basis, prob._surrogate.alpha,
            prob._surrogate.samples, device="cpu"), **kw)
    (vc, _), gc = cpu._vg_aux(x, u0.cpu())
    assert abs(float(va) - float(vc)) <= 1e-9 * abs(float(vc))
    assert float((ga.cpu() - gc).abs().max() / gc.abs().max()) <= 1e-6


WARPED = [("octet", 50), ("octet", 7), ("bcc", 5), ("hybrid", 4)]


def _warped(name, n, dtype):
    from pylatticedso_tpu_torch.smoke_warped import taper_twist
    ts = StructuredLattice(GEOMS[name], (n, n, n), (1.0, 1.0, 1.0), 1013.0,
                           0.3, dtype=dtype, device="cuda",
                           node_transform=taper_twist(n))
    tm, _ = ts.make_matvec()
    g = torch.Generator(device="cuda").manual_seed(n)
    shape = (ts.nc, 6) + ts.grid
    u = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    lam = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    r = 0.04 + 0.05 * torch.rand((ts.n_geom, n, n, n), generator=g,
                                 device="cuda", dtype=dtype)
    return ts, tm, u, lam, tm.prepare(r)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("name,n", WARPED)
def test_warped_kernel_matches_plain_on_card(name, n, dtype, tol):
    """B1w (float32, float64) against the warped gather form, bitwise on
    repeat, counted as B1w and never as B1; no bf16-I/O form."""
    _need_card()
    _ts, tm, u, _lam, aux = _warped(name, n, dtype)
    B = tm.apply
    y = B(u, aux)
    assert torch.equal(y, B(u, aux))
    y_plain = tm.apply_gather(u, aux)
    torch.cuda.synchronize()
    f64 = dtype == torch.float64
    assert (B.launches_warped_f64 if f64 else B.launches_warped) == 2
    assert B.launches == B.launches_f64 == B.launches_lo == 0
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err <= tol, err
    with pytest.raises(ValueError, match="B1w"):
        B.lo(u.to(torch.bfloat16), aux.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("name,n", WARPED)
def test_warped_r2_cotangent_matches_plain_on_card(name, n, dtype, tol):
    """The warped r^2-cotangent kernel against its plain closed form, the
    same bits on repeat, writing every padded position; through autograd
    it runs in B1w's backward."""
    _need_card()
    _ts, tm, u, lam, aux = _warped(name, n, dtype)
    B = tm.apply
    got = B.vjp_r2(lam, u, aux)
    assert torch.equal(got, B.vjp_r2(lam, u, aux))
    want = B.plain_vjp_r2(lam, u, aux)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= tol, err
    assert B.launches_vjp_warped == 2 and B.launches_vjp == 0
    r2 = aux.clone().requires_grad_(True)
    (gr,) = torch.autograd.grad(torch.sum(lam * B(u, r2)), r2)
    assert torch.equal(gr, got)
    assert B.launches_vjp_warped == 3


@pytest.mark.gpu
def test_sdf_on_card_matches_the_cpu():
    """The solid mesh's signed distance on the card against the CPU (each
    point's terms rounded in float32 in either order), chunked over points
    x beams with the same bits as one chunk."""
    _need_card()
    from pylatticedso_tpu_torch.design import build_lattice
    from pylatticedso_tpu_torch.io import solid_mesh
    lat = build_lattice({"geometry": {
        "cell_size": {"x": 1, "y": 1, "z": 1},
        "number_of_cells": {"x": 2, "y": 2, "z": 2},
        "radii": [0.05], "geom_types": ["Octet"]}})
    sdf, o, h = solid_mesh.lattice_sdf_grid(lat, 48, device="cuda")
    sdf_c, o_c, h_c = solid_mesh.lattice_sdf_grid(lat, 48, device="cpu")
    np.testing.assert_array_equal(o, o_c)
    assert np.abs(sdf - sdf_c).max() <= 2e-6
    G = np.stack(np.meshgrid(*[o[k] + h[k] * np.arange(sdf.shape[k])
                               for k in range(3)], indexing="ij"),
                 axis=-1).reshape(-1, 3)
    p1, p2 = lat.nodes[lat.edges[:, 0]], lat.nodes[lat.edges[:, 1]]
    small = solid_mesh._capsule_sdf(G, p1, p2, lat.radius, device="cuda",
                                    max_bytes=12 * 64 * 1024)
    np.testing.assert_array_equal(small, sdf.reshape(-1))


# ------------------------------------------------------------ the mesh
def _virtual_mesh(n_shard, n_dp=1):
    from pylatticedso_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(n_shard=n_shard, n_dp=n_dp,
                     devices=["cuda:0"] * (n_shard * n_dp))


@pytest.mark.gpu
@pytest.mark.parametrize("warped", [False, True], ids=["B1", "B1w"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_slab_kernel_matches_plain_on_card(warped, dtype, tol):
    """B1 / B1w on every slab of a ["cuda:0"] * 4 mesh against its plain
    version on the same halo-exchanged slab, the slabs gathered the bits
    of the one-device launch, a repeat the same bits."""
    _need_card()
    from pylatticedso_tpu_torch.parallel.slabs import SlabLevel
    from pylatticedso_tpu_torch.smoke_warped import taper_twist
    cells = (11, 6, 5)
    ts = StructuredLattice("Octet", cells, (1.0, 1.0, 1.0), 1013.0, 0.3,
                           dtype=dtype, device="cuda",
                           node_transform=taper_twist(5) if warped else None)
    tm, _ = ts.make_matvec()
    g = torch.Generator(device="cuda").manual_seed(11)
    u = torch.randn((ts.nc, 6) + ts.grid, generator=g, device="cuda",
                    dtype=dtype)
    r = 0.04 + 0.05 * torch.rand(cells, generator=g, device="cuda",
                                 dtype=dtype)
    aux = tm.prepare(r)
    free = torch.ones((ts.nc, 6) + ts.grid, dtype=dtype, device="cuda")
    devs = _virtual_mesh(4).devices[0]
    sl = SlabLevel(tm, ts, free, devs, 0)
    up, a = sl.exchange(sl.scatter(u)), sl.padded_r2(aux)
    outs = []
    for op, p, ak in zip(sl.ops, up.parts, a.parts):
        got = op.apply_padded(p, ak)
        assert torch.equal(got, op.apply_padded(p, ak))
        want = op.plain_padded(p, ak)
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= tol, err
        outs.append(got)
    counter = "launches_warped" if warped else "launches"
    if dtype == torch.float64:
        counter += "_f64"
    assert [getattr(op, counter) for op in sl.ops] == [2] * 4
    assert torch.equal(torch.cat(outs, dim=2), tm.apply(u, aux))


@pytest.mark.gpu
def test_collectives_on_card():
    """all_reduce_sum: every destination the bits of p0 + p1 + p2 + p3;
    halo_exchange: the slices of the gathered field; gather o scatter the
    identity."""
    _need_card()
    from pylatticedso_tpu_torch.parallel import mesh as M
    devs = _virtual_mesh(4).devices[0]
    g = torch.Generator(device="cuda").manual_seed(5)
    parts = [torch.randn(1000, generator=g, device="cuda") * 10 ** k
             for k in range(4)]
    want = parts[0] + parts[1] + parts[2] + parts[3]
    for s in M.all_reduce_sum(parts, devs):
        assert torch.equal(s, want)
    x = torch.randn((2, 6, 8, 3, 3), generator=g, device="cuda")
    sx = M.scatter(x, devs, 2)
    assert torch.equal(M.gather(sx, "cuda:0"), x)
    full = torch.nn.functional.pad(x, (1, 1, 1, 1, 1, 1))
    ex = M.halo_exchange(sx.map(
        lambda p: torch.nn.functional.pad(p, (1, 1, 1, 1, 1, 1))))
    for k, p in enumerate(ex.parts):
        assert torch.equal(p, full[:, :, 2 * k:2 * k + 4])


@pytest.mark.gpu
@pytest.mark.parametrize("precond", ["jacobi", "mg"])
def test_sharded_structured_step_on_card(precond):
    """The slab-sharded step on ["cuda:0"] * 4: f64 within 1e-10 / 1e-8 of
    the one-device implicit step, the same bits on repeat."""
    _need_card()
    from pylatticedso_tpu_torch.parallel.structured import (
        make_structured_compliance_step, shard_structured_step)
    N = 7
    sl = StructuredLattice("BCC", (N, 2, 2), (1.0, 1.0, 1.0), 1013.0, 0.3,
                           dtype=torch.float64, device="cuda")
    free = sl.select_nodes(lambda x, y, z: x > 1e-9)
    f = sl.node_field().astype(np.float64)
    f[:, 2][sl.select_nodes(lambda x, y, z: x > N - 1e-9)] = -0.1
    step = make_structured_compliance_step(
        sl, free, f, tol=1e-10, maxiter=500, precond=precond,
        mg_opts={"nu": 2, "coarse_degree": 8, "smooth_frac": 0.25,
                 "power_iters": 5} if precond == "mg" else None)
    r = torch.full((N, 2, 2), 0.05, dtype=torch.float64, device="cuda")
    c0, g0, u0 = step.value_and_grad(r, torch.zeros_like(step.operands[1]))
    sstep = shard_structured_step(step, _virtual_mesh(4, 2))
    c1, g1, u1 = sstep(r)
    c2, g2, u2 = sstep(r)
    assert torch.equal(c1, c2) and torch.equal(g1, g2) \
        and torch.equal(u1.gather(), u2.gather())
    assert abs(float(c1 - c0)) <= 1e-10 * abs(float(c0))
    assert float((g1 - g0).abs().max() / g0.abs().max()) <= 1e-8
    assert sum(op.launches_f64 for op in sstep.runner.op.ops) > 0


@pytest.mark.gpu
def test_edge_sharded_step_on_card():
    """The edge-sharded step on a 2 x 4 mesh of cuda:0: step and batch
    within 1e-10 of one device (f64), the same bits on repeat."""
    _need_card()
    from pylatticedso_tpu_torch.multichip import _small_problem
    from pylatticedso_tpu_torch.parallel.sharding import (
        ShardedLattice, make_compliance_step, make_mesh)
    lat, bc = _small_problem("cuda")
    out = []
    for mesh in (make_mesh(devices=["cuda:0"]), _virtual_mesh(4, 2)):
        shl = ShardedLattice(mesh, lat.nodes, lat.edges, 1013.0, 0.3,
                             dtype=torch.float64)
        step = make_compliance_step(shl, ~bc.fixed, bc.f_applied, tol=1e-12,
                                    maxiter=2000)
        r = shl.radius_padded(lat.radius)
        out.append((step(r), step.batch(torch.stack([r, 1.2 * r])),
                    step(r)))
    (a, ab, a2), (b, bb, b2) = out
    assert torch.equal(b[0], b2[0]) and torch.equal(b[1], b2[1])
    for x, y in ((a[0], b[0]), (ab[0], bb[0])):
        assert float((x - y).abs().max() / y.abs().max()) <= 1e-10
    for x, y in ((a[1], b[1]), (ab[1], bb[1])):
        assert float((x - y).abs().max() / y.abs().max()) <= 1e-10
