"""Port parity of the fused multigrid smoother against the JAX package:
the routing (which levels run B5, which B3 + B4), the plain versions of
kernels B3 (residual), B4 (one Chebyshev step) and B5 (a whole smoother)
against the JAX Pallas kernels in interpret mode, the whole fused V-cycle
from one JAX state carried over by ``convert.precond_state_from_jax``, and
the port's refusals where the JAX package would fall back.

Tolerances: float32 storage 1e-5 for B3 and 2e-5 for B4, B5 and the
V-cycle (``tests/test_stencil_pallas.py``: the two sides sum the stencil in
another order); bf16 storage 1e-2 between the two bf16 results (both round
the same f32 values at the same points, so they differ by a few bf16 ulps,
2^-8 relative, where an order-of-summation difference flips a rounding)
and 3e-2 for the V-cycle (``tests/test_stencil_pallas.py:89``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pylatticedso_tpu.parallel import multigrid as jmg
from pylatticedso_tpu.parallel.stencil_pallas import make_pallas_matvec
from pylatticedso_tpu.parallel.structured import StructuredLattice as JSL
from pylatticedso_tpu_torch import convert
from pylatticedso_tpu_torch.kernels import fused as tfused
from pylatticedso_tpu_torch.parallel import multigrid as tmg
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice as TSL

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

HYBRID = ["BCC", "Hybrid1", "Hybrid4"]
PAD = (1, 1, 1, 1, 1, 1)
IO = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def rel(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def tnp(t):
    return t.to(torch.float64).numpy()


# ------------------------------------------------------------------ routing
ROUTES = ([("Octet", n, s) for n in (50, 25, 13, 7, 4, 2)
           for s in ("bf16", "f32")]
          + [("BCC", 4, "bf16"), ("hybrid", 4, "bf16"),
             ("hybrid", 6, "bf16")])


@pytest.mark.parametrize("geom,n,storage", ROUTES)
def test_routing_matches_jax(geom, n, storage, monkeypatch):
    """ok and single_ok of the port's routing equal the JAX fused
    smoother's, as built by ``make_matvec`` under ``PLDSO_MATVEC=pallas``
    (construction only: no kernel runs)."""
    monkeypatch.setenv("PLDSO_MATVEC", "pallas")
    monkeypatch.setenv("PLDSO_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PLDSO_MG_FUSED_DTYPE", storage)
    g = HYBRID if geom == "hybrid" else geom
    js = JSL(g, (n,) * 3, (1.0,) * 3, 1013.0, 0.3)
    fz = getattr(js.make_matvec()[0].apply, "fused", None)
    # no fused attribute: the gather-form matvec; ok False: no single_ok
    want = (True, fz.single_ok) if fz is not None and fz.ok \
        else (False, False)
    ts = TSL(g, (n,) * 3, (1.0,) * 3, 1013.0, 0.3, device="cpu")
    assert tfused.route(ts) == want
    if geom == "Octet":        # the 50^3 hierarchy: B5 from 7 cells down
        # (f32 storage: the fine level has no fused smoother in JAX)
        assert want == ((storage == "bf16" or n < 50), n <= 7)


def test_cheb_static_and_sc():
    cs = tfused.cheb_static(0.35, 3)
    assert len(cs) == 3 and all(np.isfinite(cs).ravel())
    ts = TSL("BCC", (2,) * 3, (1.0,) * 3, 1013.0, 0.3, device="cpu")
    fz = ts.make_matvec()[0].apply.fused
    lmax = torch.tensor(3.0, dtype=torch.float64)
    sc = fz.sc(lmax, 0.25)
    assert sc.dtype == torch.float32 and tuple(sc.shape) == (2,)
    want = np.float32(2.0) / (np.float32(1.25) * np.float32(3.0))
    assert float(sc[0]) == float(want)


# ------------------------------------------------------------ kernel parity
class Pair:
    """One lattice in both packages (float32), with the JAX Pallas fused
    smoother (interpret mode) and the port's, and numpy inputs."""

    def __init__(self, geom="BCC", n=4, seed=0):
        self.js = JSL(geom, (n,) * 3, (1.0,) * 3, 1013.0, 0.3)
        mv, _ = self.js.make_matvec()
        self.jprep, japply = make_pallas_matvec(self.js, mv.prepare,
                                                mv.apply, interpret=True)
        self.jfz = japply.fused
        self.ts = TSL(geom, (n,) * 3, (1.0,) * 3, 1013.0, 0.3,
                      dtype=torch.float32, device="cpu")
        self.tmv, _ = self.ts.make_matvec()
        self.tfz = self.tmv.apply.fused
        rng = np.random.default_rng(seed)
        shape = (self.js.nc, 6) + self.js.grid
        fixed = self.js.select_nodes(lambda x, y, z: z == 0.0)
        self.fm = np.broadcast_to((self.js.node_valid & ~fixed)[:, None],
                                  shape).astype(np.float32)
        self.u = rng.standard_normal(shape).astype(np.float32) * self.fm
        self.b = rng.standard_normal(shape).astype(np.float32) * self.fm
        self.D = (1.0 + rng.random(shape)).astype(np.float32)
        self.r = (0.04 + 0.05 * rng.random((n,) * 3)).astype(np.float32)

    def j(self, a, storage):
        return self.jfz.to_flat(jnp.asarray(a), IO[storage][0])

    def t(self, a, storage):
        return F.pad(torch.tensor(a), PAD).to(IO[storage][1])

    def jr2(self, storage):
        return self.jfz.repad_r2(self.jprep(jnp.asarray(self.r)),
                                 IO[storage][0])

    def tr2(self, storage):
        return self.tmv.prepare(torch.tensor(self.r)).to(IO[storage][1])

    def back_j(self, flat):
        return np.asarray(self.jfz.from_flat(flat))

    @staticmethod
    def back_t(v):
        return tnp(v[..., 1:-1, 1:-1, 1:-1])


@pytest.fixture(scope="module")
def bcc():
    return Pair()


def _tol(storage, f32_tol):
    return f32_tol if storage == "f32" else 1e-2


def _zero_ghosts(v):
    inner = torch.zeros_like(v)
    inner[..., 1:-1, 1:-1, 1:-1] = v[..., 1:-1, 1:-1, 1:-1]
    return torch.equal(inner, v)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_residual_matches_jax(bcc, storage):
    p = bcc
    io = IO[storage][0]
    got_j = p.back_j(p.jfz.residual(io)(p.j(p.b, storage),
                                        p.j(p.u, storage),
                                        p.j(p.fm, storage),
                                        p.jr2(storage)))
    out = p.tfz.residual(p.t(p.b, storage), p.t(p.u, storage),
                         p.t(p.fm, storage), p.tr2(storage))
    assert out.dtype == IO[storage][1] and _zero_ghosts(out)
    assert np.abs(got_j).max() > 0
    assert rel(got_j, p.back_t(out)) <= _tol(storage, 1e-5)


def _chain(cheb_run, sc, b, x0, fdinv, fm, r2, residual, frac, deg,
           zeros, f32, to_io):
    """B3 + a chain of B4 launches, as ``_FusedVCycle`` runs them on a
    multi-program level; every intermediate (x, r, d) is kept."""
    if x0 is None:
        x, r = zeros(b), b
    else:
        x, r = x0, residual(b, x0, fm, r2)
    d = to_io(f32(r) * f32(fdinv) * sc[0])
    seen = []
    for k, (c1, c2) in enumerate(tfused.cheb_static(frac, deg)):
        final = k == deg - 1
        out = cheb_run(x, r, d, fdinv, sc, r2, c1, c2, final)
        if final:
            return out, seen
        x, r, d = out
        seen.append((x, r, d))


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("deg,with_x0", [(1, False), (2, True), (3, False)])
def test_cheb_run_matches_jax(bcc, storage, deg, with_x0):
    p = bcc
    jio, tio = IO[storage]
    frac = 0.25
    lmax = 3.0
    fdinv = p.fm / p.D
    sc_j = p.jfz.sc(2.0 / ((1 + frac) * jnp.float32(lmax)),
                    2.0 / ((1 - frac) * jnp.float32(lmax)))
    sc_t = p.tfz.sc(torch.tensor(lmax, dtype=torch.float32), frac)
    np.testing.assert_array_equal(np.asarray(sc_j), sc_t.numpy())
    x0 = p.u if with_x0 else None

    def jrun(x, r, d, fd, sc, r2, c1, c2, final):
        return p.jfz.cheb_run(jio, c1, c2, final)(x, r, d, fd, sc, r2)

    out_j, seen_j = _chain(
        jrun, sc_j, p.j(p.b, storage),
        None if x0 is None else p.j(x0, storage), p.j(fdinv, storage),
        p.j(p.fm, storage), p.jr2(storage), p.jfz.residual(jio), frac, deg,
        jnp.zeros_like, lambda a: a.astype(jnp.float32),
        lambda a: a.astype(jio))
    out_t, seen_t = _chain(
        p.tfz.cheb_run, sc_t, p.t(p.b, storage),
        None if x0 is None else p.t(x0, storage), p.t(fdinv, storage),
        p.t(p.fm, storage), p.tr2(storage), p.tfz.residual, frac, deg,
        torch.zeros_like, lambda a: a.to(torch.float32), lambda a: a.to(tio))
    tol = _tol(storage, 2e-5)
    for vj, vt in zip(seen_j, seen_t):
        for a, b in zip(vj, vt):
            assert b.dtype == tio and _zero_ghosts(b)
            assert rel(p.back_j(a), p.back_t(b)) <= tol
    assert out_t.dtype == tio and _zero_ghosts(out_t)
    assert np.abs(p.back_j(out_j)).max() > 0
    assert rel(p.back_j(out_j), p.back_t(out_t)) <= tol


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("deg,with_x0", [(3, False), (2, True)])
def test_cheb_full_matches_jax(bcc, storage, deg, with_x0):
    p = bcc
    jio, tio = IO[storage]
    frac = 0.25
    fdinv = p.fm / p.D
    sc_j = p.jfz.sc(2.0 / ((1 + frac) * jnp.float32(3.0)),
                    2.0 / ((1 - frac) * jnp.float32(3.0)))
    sc_t = p.tfz.sc(torch.tensor(3.0), frac)
    assert p.jfz.single_ok and p.tfz.single_ok
    full = p.jfz.cheb_full(jio, frac, deg, with_x0)
    if with_x0:
        out_j = full(p.j(p.b, storage), p.j(p.u, storage),
                     p.j(fdinv, storage), sc_j, p.jr2(storage))
    else:
        out_j = full(p.j(p.b, storage), p.j(fdinv, storage), sc_j,
                     p.jr2(storage))
    out_t = p.tfz.cheb_full(p.t(p.b, storage),
                            p.t(p.u, storage) if with_x0 else None,
                            p.t(fdinv, storage), sc_t, p.tr2(storage), frac,
                            deg)
    assert out_t.dtype == tio and _zero_ghosts(out_t)
    assert np.abs(p.back_j(out_j)).max() > 0
    assert rel(p.back_j(out_j), p.back_t(out_t)) <= _tol(storage, 2e-5)


# ------------------------------------------------------------- the V-cycle
def jax_state(geom, n, monkeypatch, seed=3):
    """A JAX Pallas-layout fused state (f32 storage) and both packages'
    hierarchies for the same lattice, clamped at z = 0."""
    monkeypatch.setenv("PLDSO_MATVEC", "pallas")
    monkeypatch.setenv("PLDSO_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PLDSO_MG_FUSED_DTYPE", "f32")
    monkeypatch.setenv("PLDSO_MG_FUSED", "1")
    js = JSL(geom, (n,) * 3, (1.0,) * 3, 1013.0, 0.3)
    fixed = js.select_nodes(lambda x, y, z: z == 0.0)
    free = np.broadcast_to((js.node_valid & ~fixed)[:, None],
                           (js.nc, 6) + js.grid)
    hj = jmg.build_mg_hierarchy(js, free)
    rshape = (n,) * 3 if js.n_geom == 1 else (js.n_geom,) + (n,) * 3
    rng = np.random.default_rng(seed)
    r0 = jnp.asarray(0.04 + 0.03 * rng.random(rshape), jnp.float32)
    sj = jmg.mg_precond_state(hj, r0, power_iters=3)
    assert all(fo is not None for fo in sj["fused"])
    ts = TSL(geom, (n,) * 3, (1.0,) * 3, 1013.0, 0.3, dtype=torch.float32,
             device="cpu")
    ht = tmg.build_mg_hierarchy(ts, free)
    assert [lvl.fused.single_ok for lvl in ht["levels"]] == \
        [lvl.matvec.apply.fused.single_ok for lvl in hj["levels"]]
    v = rng.standard_normal((js.nc, 6) + js.grid).astype(np.float32) \
        * np.asarray(hj["levels"][0].free)
    return hj, sj, ht, v


def with_storage(sj, storage):
    """The same JAX state with its fused operands in ``storage``: the JAX
    package rounds the f32 operands to the storage dtype, so rounding the
    f32-storage state's operands gives its bf16-storage state."""
    jio = IO[storage][0]
    fused = [{k: jnp.asarray(v, jio) for k, v in fo.items()}
             for fo in sj["fused"]]
    return dict(sj, fused=fused)


def check_vcycle(hj, sj, ht, v, jax_storages=("f32", "bf16")):
    """Port M(v) against JAX M(v) from the same state, fused, nu=(1, 1),
    coarse degree 6, for each storage of ``jax_storages``; the port's
    f32-storage M also against its unfused M, and its bf16-storage M more
    than 1e-6 away from the f32 one (the bf16 storage is engaged)."""
    opts = dict(nu=(1, 1), coarse_degree=6)
    mt = {}
    for storage in ("f32", "bf16"):
        sjs = with_storage(sj, storage)
        st = convert.precond_state_from_jax(
            jax.tree_util.tree_map(np.asarray, sjs), dtype=torch.float32,
            device="cpu")
        mt[storage] = tnp(tmg.mg_apply(ht, st, fused=True, **opts)(
            torch.tensor(v)))
        if storage == "f32":
            unfused = tmg.mg_apply(ht, st, fused=False, lo_smoother=False,
                                   **opts)(torch.tensor(v))
            assert rel(tnp(unfused), mt[storage]) <= 2e-5
        if storage in jax_storages:
            mj = np.asarray(jmg.mg_apply(hj, sjs, fused=True, **opts)(
                jnp.asarray(v)))
            assert np.abs(mj).max() > 0
            tol = 2e-5 if storage == "f32" else 3e-2
            assert rel(mj, mt[storage]) <= tol
    assert rel(mt["f32"], mt["bf16"]) > 1e-6


def test_fused_vcycle_all_single_matches_jax(monkeypatch):
    """BCC n=4: every level runs its smoother in one B5 launch."""
    hj, sj, ht, v = jax_state("BCC", 4, monkeypatch)
    assert all(lvl.fused.single_ok for lvl in ht["levels"])
    check_vcycle(hj, sj, ht, v)


# ---------------------------------------------------------- no fallback
@pytest.fixture(scope="module")
def bcc_port():
    ts = TSL("BCC", (4,) * 3, (1.0,) * 3, 1013.0, 0.3, dtype=torch.float32,
             device="cpu")
    fixed = ts.select_nodes(lambda x, y, z: z == 0.0)
    free = np.broadcast_to((ts.node_valid & ~fixed)[:, None],
                           (ts.nc, 6) + ts.grid)
    ht = tmg.build_mg_hierarchy(ts, free)
    r = torch.full((4,) * 3, 0.05)
    return ht, r


def test_fused_request_without_operands_raises(bcc_port, monkeypatch):
    ht, r = bcc_port
    monkeypatch.delenv("PLDSO_MG_FUSED", raising=False)
    st = tmg.mg_precond_state(ht, r, power_iters=1)
    assert st["fused"] == [None] * len(ht["levels"])
    with pytest.raises(RuntimeError, match="no fused"):
        tmg.mg_apply(ht, st, fused=True)
    # the environment switch, with one level's operands missing
    st = tmg.mg_precond_state(ht, r, power_iters=1, fused=True)
    st["fused"][-1] = None
    monkeypatch.setenv("PLDSO_MG_FUSED", "1")
    with pytest.raises(RuntimeError, match=r"levels \[1\]"):
        tmg.mg_apply(ht, st)


def test_fused_bf16_compute_is_refused(bcc_port, monkeypatch):
    """``PLDSO_MG_FUSED_COMPUTE=bf16`` is no longer refused: the fused
    V-cycle runs its bf16-compute instances (B3c-B5c, plain versions
    here), read as each kernel is called, within the JAX package's own
    bf16-compute bound of the f32-compute V-cycle and above 1e-7 from it
    (``tests/test_stencil_pallas.py:251-268``; the comparison with JAX's
    V-cycle is in ``tests/test_torch_fused_compute.py``).  What is still
    refused is a fused request the state cannot meet, as before."""
    ht, r = bcc_port
    # a state whose lmax bounds the spectrum (with one power iteration the
    # Chebyshev sweeps grow M by 1e5 and amplify every rounding)
    st = tmg.mg_precond_state(ht, r, power_iters=10, fused=True)
    lvl0 = ht["levels"][0]
    v = torch.tensor(np.random.default_rng(5).standard_normal(
        (lvl0.slat.nc, 6) + lvl0.slat.grid), dtype=torch.float32) * lvl0.free
    M = tmg.mg_apply(ht, st, fused=True)
    m32 = tnp(M(v))
    monkeypatch.setenv("PLDSO_MG_FUSED_COMPUTE", "bf16")
    m16 = tnp(M(v))
    assert np.isfinite(m16).all() and 1e-7 < rel(m32, m16) < 8e-2
    monkeypatch.delenv("PLDSO_MG_FUSED_COMPUTE")
    np.testing.assert_array_equal(tnp(M(v)), m32)
    monkeypatch.setenv("PLDSO_MG_FUSED_COMPUTE", "bf16")
    with pytest.raises(RuntimeError, match="fall back"):
        tmg.mg_apply(ht, dict(st, fused=[None] * len(st["fused"])),
                     fused=True)


def test_lo_request_without_operands_raises(bcc_port):
    """A lo request runs B2 only on the levels whose state has bf16
    operands and smooths the others in full precision (the JAX rule,
    ``multigrid.py:496-499``): with none, it is the f32 V-cycle; with the
    coarse level's missing, it differs from both."""
    ht, r = bcc_port
    st = tmg.mg_precond_state(ht, r, power_iters=1)
    assert all(a is not None for a in st["auxs_lo"])
    v = torch.ones((ht["levels"][0].slat.nc, 6) + ht["levels"][0].slat.grid)
    v = v * ht["levels"][0].free
    m32 = tmg.mg_apply(ht, st, lo_smoother=False, fused=False)(v)
    m_lo = tmg.mg_apply(ht, st, lo_smoother=True, fused=False)(v)
    none = dict(st, auxs_lo=[None] * len(st["auxs_lo"]))
    assert torch.equal(tmg.mg_apply(ht, none, lo_smoother=True,
                                    fused=False)(v), m32)
    part = dict(st, auxs_lo=st["auxs_lo"][:-1] + [None])
    m_part = tmg.mg_apply(ht, part, lo_smoother=True, fused=False)(v)
    assert not torch.equal(m_part, m32) and not torch.equal(m_part, m_lo)


def test_b5_refuses_a_multi_program_level():
    ts = TSL(HYBRID, (6,) * 3, (1.0,) * 3, 1013.0, 0.3, dtype=torch.float32,
             device="cpu")
    fz = ts.make_matvec()[0].apply.fused
    assert fz.ok and not fz.single_ok
    z = torch.zeros((ts.nc, 6) + tuple(g + 2 for g in ts.grid))
    with pytest.raises(ValueError, match="single"):
        fz.cheb_full(z, None, z, torch.ones(2), z, 0.25, 2)
