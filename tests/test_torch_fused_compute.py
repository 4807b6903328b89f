"""Port parity of the fused smoother's bf16-compute instances (B3c, B4c,
B5c: ``PLDSO_MG_FUSED_COMPUTE=bf16``) against the JAX package's
(``make_stencil_acc(T, ct=jnp.bfloat16)``, Pallas kernels in interpret
mode): the dense form's coefficient pack, each kernel's plain version in
f32 and bf16 storage, and the fused V-cycle (the cold CG iterations under
bf16 compute are held to JAX's in tests/test_torch_bf16_iterations.py,
route ``fused-bf16c``).

The port's plain dense form repeats JAX's bf16 operations in JAX's order,
and XLA on the CPU rounds each bf16 product and sum on its own as torch
does, so the kernels' plain versions are held to JAX's bits.  Each result
is also held more than 1e-7 (relative to its largest value) away from the
f32-compute result, which shows that the bf16 arithmetic is engaged.
One operation departs: XLA's CPU code fuses the f32 Chebyshev update's
multiply and add (d1 = fma(c1, d, (c2 inv_delta) r1 fd)), which torch and
the kernels round one by one, so in f32 storage B4c's and B5c's results
differ from JAX's by f32 ulps (bf16 storage rounds them away); there the
result is held to 1e-2 (the bf16 kernels' limit) and to a tenth of its
distance from the f32-compute result.  The V-cycle in bf16 storage gives
JAX's bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu.parallel import multigrid as jmg
from pylatticedso_tpu.parallel.stencil_pallas import (_edge_sides,
                                                      _pack_dense_coefs)
from pylatticedso_tpu.parallel.structured import StructuredLattice as JSL
from pylatticedso_tpu_torch import convert
from pylatticedso_tpu_torch.kernels import fused as tfused
from pylatticedso_tpu_torch.kernels.stencil import edge_sides
from pylatticedso_tpu_torch.parallel import multigrid as tmg
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice as TSL

from test_torch_fused import (HYBRID, IO, Pair, _chain, jax_state, rel, tnp,
                              with_storage)

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

ENGAGED = 1e-7          # least distance from the f32-compute result


@pytest.fixture
def bf16_compute(monkeypatch):
    monkeypatch.setenv("PLDSO_MG_FUSED_COMPUTE", "bf16")


@pytest.fixture(scope="module")
def bcc():
    return Pair()


# ----------------------------------------------------------- the dense form
@pytest.mark.parametrize("geom", ["Octet", "BCC", "hybrid"])
def test_dense_pack_matches_jax(geom):
    """The port's copy of ``_pack_dense_coefs`` gives JAX's table and
    term lists on the same sides; the device records hold those columns
    rounded to bf16 from the float32 table, in the side table's order, one
    slot per source, zeros in a slot without a term (never slot 0)."""
    g = HYBRID if geom == "hybrid" else geom
    js = JSL(g, (3,) * 3, (1.0,) * 3, 1013.0, 0.3)
    ts = TSL(g, (3,) * 3, (1.0,) * 3, 1013.0, 0.3, device="cpu")
    G = 1013.0 / (2.0 * 1.3)
    jrecs, trecs = _edge_sides(js, 5, 5), edge_sides(ts, 5, 5)
    jt = _pack_dense_coefs(jrecs, 1013.0, G, js.kappa)
    tt = tfused.pack_dense_coefs(trecs, 1013.0, G, ts.kappa)
    assert jt.dtype == tt.dtype == np.float32
    np.testing.assert_array_equal(jt, tt)
    for a, b in zip(jrecs, trecs):
        assert (a["dense_a"], a["dense_b"]) == (b["dense_a"], b["dense_b"])
    form = tfused.DenseForm(ts)
    bits = np.asarray(jnp.asarray(jt[:6].T).astype(jnp.bfloat16)
                      .view(jnp.uint16))
    order = sorted(range(len(trecs)), key=lambda i: trecs[i]["cs"])
    for row, i in zip(form.table, order):
        r = trecs[i]
        want = np.zeros((tfused.DENSE_COLS, 6), np.uint16)
        want[:2] = bits[:2]
        for src, k, j in r["dense_a"]:
            want[2 + (k if src == "d" else 6 + k)] = bits[j]
        for srow, j in r["dense_b"]:
            want[2 + tfused.DENSE_A + srow] = bits[j]
        np.testing.assert_array_equal(row["col"], want)
        assert want[2].any() and want[2 + tfused.DENSE_A].any()


def test_bf16_compute_rule():
    """bf16 compute only where the level's matvec takes the dense form
    (every level of the 50^3 Octet hierarchy; never at float64); the
    variable is read as each call is made, and an explicit request on a
    level without the dense form raises."""
    for n in (50, 25, 13, 7, 4, 2):
        ts = TSL("Octet", (n,) * 3, (1.0,) * 3, 1013.0, 0.3,
                 dtype=torch.float32, device="cpu")
        assert tfused.dense_form(ts), n
    fz = TSL("BCC", (2,) * 3, (1.0,) * 3, 1013.0, 0.3, dtype=torch.float32,
             device="cpu").make_matvec()[0].apply.fused
    f64 = TSL("BCC", (2,) * 3, (1.0,) * 3, 1013.0, 0.3, dtype=torch.float64,
              device="cpu").make_matvec()[0].apply.fused
    mp = pytest.MonkeyPatch()
    try:
        assert fz.compute_type() == f64.compute_type() == "f32"
        mp.setenv("PLDSO_MG_FUSED_COMPUTE", "bf16")
        assert fz.compute_type() == "bf16" and f64.compute_type() == "f32"
        mp.setenv("PLDSO_MG_FUSED_COMPUTE", "f32")
        assert fz.compute_type() == "f32"
    finally:
        mp.undo()
    assert fz.compute_type("bf16") == "bf16"
    with pytest.raises(ValueError, match="dense form"):
        f64.compute_type("bf16")
    with pytest.raises(ValueError, match="compute"):
        fz.compute_type("f16")
    assert fz.counter("residual", "bf16") == "residual_bf16c"
    assert set(fz.launches) == set(tfused.KERNELS)


# ------------------------------------------------------------ kernel parity
def _engaged(want_bf16c, got_f32c):
    assert rel(want_bf16c, got_f32c) > ENGAGED


def _matches(got, want_j, f32c, storage):
    """The port's result against JAX's: the same bits, except where XLA's
    CPU code fuses the f32 Chebyshev update's multiply and add, d1 =
    fma(c1, d, (c2 inv_delta) r1 fd), which the port (and the kernel)
    round one by one: in f32 storage B4c's and B5c's outputs carry that
    difference of an f32 ulp on and on.  There the result is held to 1e-2
    and to a tenth of its distance from the f32-compute result (the
    port's, held to JAX's within 2e-5 in tests/test_torch_fused.py)."""
    _engaged(want_j, f32c)
    if storage == "bf16":
        np.testing.assert_array_equal(got, want_j)
    else:
        assert rel(want_j, got) <= min(1e-2, rel(want_j, f32c) / 10)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_residual_bf16_compute_matches_jax(bcc, bf16_compute, storage):
    """B3c: the same bits as JAX's in either storage (its update has no
    multiply-add)."""
    p = bcc
    io = IO[storage][0]
    args_t = (p.t(p.b, storage), p.t(p.u, storage), p.t(p.fm, storage),
              p.tr2(storage))
    got_j = p.back_j(p.jfz.residual(io)(p.j(p.b, storage),
                                        p.j(p.u, storage),
                                        p.j(p.fm, storage), p.jr2(storage)))
    out = p.tfz.residual(*args_t)
    assert out.dtype == IO[storage][1]
    np.testing.assert_array_equal(p.back_t(out), got_j)
    _engaged(got_j, p.back_t(p.tfz.residual(*args_t, compute="f32")))


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_cheb_run_bf16_compute_matches_jax(bcc, bf16_compute, storage):
    """B3c, then B4c's first step and its final emit (degree 2, from x0),
    every intermediate x, r, d held to JAX's (``_matches``)."""
    p = bcc
    jio, tio = IO[storage]
    frac, lmax, deg = 0.25, 3.0, 2
    fdinv = p.fm / p.D
    sc_j = p.jfz.sc(2.0 / ((1 + frac) * jnp.float32(lmax)),
                    2.0 / ((1 - frac) * jnp.float32(lmax)))
    sc_t = p.tfz.sc(torch.tensor(lmax, dtype=torch.float32), frac)

    def jrun(x, r, d, fd, sc, r2, c1, c2, final):
        return p.jfz.cheb_run(jio, c1, c2, final)(x, r, d, fd, sc, r2)

    out_j, seen_j = _chain(
        jrun, sc_j, p.j(p.b, storage), p.j(p.u, storage),
        p.j(fdinv, storage), p.j(p.fm, storage), p.jr2(storage),
        p.jfz.residual(jio), frac, deg, jnp.zeros_like,
        lambda a: a.astype(jnp.float32), lambda a: a.astype(jio))

    def chain_t(compute):
        run = lambda *a: p.tfz.cheb_run(*a, compute=compute)
        res = lambda *a: p.tfz.residual(*a, compute=compute)
        return _chain(run, sc_t, p.t(p.b, storage), p.t(p.u, storage),
                      p.t(fdinv, storage), p.t(p.fm, storage),
                      p.tr2(storage), res, frac, deg, torch.zeros_like,
                      lambda a: a.to(torch.float32), lambda a: a.to(tio))

    out_t, seen_t = chain_t(None)
    out_32, seen_32 = chain_t("f32")
    assert len(seen_t) == deg - 1
    for vj, vt, v32 in zip(seen_j, seen_t, seen_32):
        for a, b, c in zip(vj, vt, v32):
            assert b.dtype == tio
            _matches(p.back_t(b), p.back_j(a), p.back_t(c), storage)
    _matches(p.back_t(out_t), p.back_j(out_j), p.back_t(out_32), storage)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("deg,with_x0", [(2, False), (1, True)])
def test_cheb_full_bf16_compute_matches_jax(bcc, bf16_compute, storage, deg,
                                            with_x0):
    """B5c: x, r and d in float32 across the steps, d rounded to bf16 at
    every stencil read."""
    p = bcc
    jio, tio = IO[storage]
    frac = 0.25
    fdinv = p.fm / p.D
    sc_j = p.jfz.sc(2.0 / ((1 + frac) * jnp.float32(3.0)),
                    2.0 / ((1 - frac) * jnp.float32(3.0)))
    sc_t = p.tfz.sc(torch.tensor(3.0), frac)
    full = p.jfz.cheb_full(jio, frac, deg, with_x0)
    if with_x0:
        out_j = full(p.j(p.b, storage), p.j(p.u, storage),
                     p.j(fdinv, storage), sc_j, p.jr2(storage))
    else:
        out_j = full(p.j(p.b, storage), p.j(fdinv, storage), sc_j,
                     p.jr2(storage))
    args = (p.t(p.b, storage), p.t(p.u, storage) if with_x0 else None,
            p.t(fdinv, storage), sc_t, p.tr2(storage), frac, deg)
    out_t = p.tfz.cheb_full(*args)
    assert out_t.dtype == tio
    _matches(p.back_t(out_t), p.back_j(out_j),
             p.back_t(p.tfz.cheb_full(*args, compute="f32")), storage)


# ------------------------------------------------- the V-cycle and CG
def test_fused_vcycle_bf16_compute_matches_jax(monkeypatch):
    """BCC n=4, nu=(1, 1), coarse degree 6, bf16 storage (the bench's),
    from one JAX state: the port's fused V-cycle under bf16 compute (B5c
    on both levels, B3c mid-cycle, the transfers in bf16) gives JAX's
    bits, and lies away from its own f32-compute V-cycle."""
    hj, sj, ht, v = jax_state("BCC", 4, monkeypatch)
    sj = with_storage(sj, "bf16")
    st = convert.precond_state_from_jax(
        jax.tree_util.tree_map(np.asarray, sj), dtype=torch.float32,
        device="cpu")
    opts = dict(nu=(1, 1), coarse_degree=6)
    M = tmg.mg_apply(ht, st, fused=True, **opts)
    m32 = tnp(M(torch.tensor(v)))
    monkeypatch.setenv("PLDSO_MG_FUSED_COMPUTE", "bf16")
    mt = tnp(M(torch.tensor(v)))
    mj = np.asarray(jmg.mg_apply(hj, sj, fused=True, **opts)(
        jnp.asarray(v)))
    assert np.abs(mj).max() > 0 and rel(mj, m32) > ENGAGED
    np.testing.assert_array_equal(mt, mj)
