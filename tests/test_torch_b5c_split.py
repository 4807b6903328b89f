"""B5c's side-parallel form, replayed in torch on the CPU: the kernel
(``csrc/mg_fused.cu`` ``mg_cheb_full_dense_kernel``) gives each item a
group of G lanes; lane j computes the dense rows of every G-th side of the
item's class apart, and the group adds all the rows into a bf16 zero in
table order (``kernels/fused.py`` ``b5c_side_order``); d is rounded to
bf16 once, when its owner publishes it, and read as bf16 pairs.  The
replay does the same with ``DenseForm.rows`` (every side's row apart) and
must give the bits of ``FusedSmoother.plain_cheb_full(..., "bf16")``, the
plain version the kernel is held to on the card, for Octet, BCC and the
hybrid (whose classes have 8 to 14 sides), in float32 and bf16 storage,
at every G.  No kernel, no JAX."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pylatticedso_tpu_torch import smoke
from pylatticedso_tpu_torch.kernels.fused import (B5C_GROUPS, b5c_side_order,
                                                  cheb_static)
from pylatticedso_tpu_torch.parallel.multigrid import _estimate_lmax
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

GEOMS = {"octet": ("Octet", 3), "bcc": ("BCC", 4),
         "hybrid": (smoke.HYBRID, 3)}
BF = torch.bfloat16
PAD = (1,) * 6
FRAC = smoke.MG_OPTS["smooth_frac"]
# (degree, spectrum fraction, with x0): one phase, the V-cycle's smoother
# with its x0 residual, the coarsest level's sweep
VARIANTS = {"degree 1": (1, FRAC, False), "degree 2, x0": (2, FRAC, True),
            "degree 24": (smoke.MG_OPTS["coarse_degree"], 1.0 / 64.0, False)}


def _level(name, storage):
    """A single level's smoother inputs, ghost-padded in ``storage``, as
    the V-cycle holds them (its own diagonal and lmax)."""
    geom, cells = GEOMS[name]
    sl = StructuredLattice(geom, (cells,) * 3, (1.0, 1.0, 1.0), smoke.E_MOD,
                           smoke.NU, dtype=torch.float32, device="cpu")
    with smoke._env(PLDSO_MG_FUSED_DTYPE="bf16"):
        mv, diag = sl.make_matvec()
    fz = mv.apply.fused
    assert fz.dense and fz.single_ok
    rng = np.random.default_rng(cells + len(name))
    shape = (sl.nc, 6) + sl.grid
    fixed = sl.select_nodes(lambda x, y, z: z == 0.0)
    fm = torch.as_tensor(np.ascontiguousarray(np.broadcast_to(
        (sl.node_valid & ~fixed)[:, None], shape), np.float32))
    u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) * fm
    r = torch.from_numpy((0.04 + 0.05 * rng.random(
        (sl.n_geom,) + (cells,) * 3)).astype(np.float32))
    r2 = mv.prepare(r)
    D = fm * diag(r) + (1.0 - fm)
    D = torch.where(D == 0, torch.ones_like(D), D)
    lmax = _estimate_lmax(lambda v: fm * mv.apply(fm * v, r2)
                          + (1.0 - fm) * v, D, shape, torch.float32,
                          iters=smoke.MG_OPTS["power_iters"])
    io = smoke.STORAGE[storage]
    P = lambda a: F.pad(a, PAD).to(io)
    return fz, lmax, P(b), P(u * fm), P(fm / D), r2.to(io)


def _class_start(fz):
    return fz.mv.tables(torch.device("cpu"))[1].tolist()


def _k_split(fz, up: torch.Tensor, r2: torch.Tensor, group: int):
    """K u as B5c's groups form it: every side's row apart, then per class
    the rows added into a bf16 zero in the order its group adds them;
    each row taken from the lane and step the kernel computes it at."""
    form = fz.dense_form
    rows = form.rows(up.to(BF), r2.to(BF))[torch.tensor(form.table_order)]
    cs = _class_start(fz)
    kmax = -(-max(b - a for a, b in zip(cs, cs[1:])) // group)
    acc = torch.zeros((fz.nc, 6) + fz.grid, dtype=BF)
    for c in range(fz.nc):
        a = torch.zeros((6,) + fz.grid, dtype=BF)
        for s, lane, k in b5c_side_order(group, cs[c], cs[c + 1], kmax):
            assert cs[c] + k * group + lane == s
            a = a + rows[s]
        acc[c] = a
    return acc.to(torch.float32)


def _replay(fz, b, x0, fd, sc, r2, frac, degree, group):
    """B5c's arithmetic, one value at a time as the kernel's lanes do it:
    x, r, d and fd in float32; d published (rounded to bf16) once a
    phase, its ghosts zero; the pointwise update as ``cheb_d_rn``."""
    io = b.dtype
    w = lambda v: v[..., 1:-1, 1:-1, 1:-1].to(torch.float32)
    bw, fdw = w(b), w(fd)
    inv_theta, inv_delta = sc[0], sc[1]
    if x0 is not None:
        x = w(x0)
        r = bw - _k_split(fz, x0, r2, group)
    else:
        x = torch.zeros_like(bw)
        r = bw
    d = (r * fdw) * inv_theta
    for c1, c2 in cheb_static(frac, degree):
        published = F.pad(d, PAD).to(BF)
        kd = _k_split(fz, published, r2, group)
        c2i = torch.tensor(c2, dtype=torch.float32) * inv_delta
        x = x + d
        r = r - kd
        d = torch.tensor(c1, dtype=torch.float32) * d + (c2i * r) * fdw
    return F.pad(x + d, PAD).to(io)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(GEOMS))
def test_split_rows_give_the_plain_bits(name, storage, variant):
    degree, frac, with_x0 = VARIANTS[variant]
    fz, lmax, b, x, fd, r2 = _level(name, storage)
    sc = fz.sc(lmax, frac)
    x0 = x if with_x0 else None
    want = fz.plain_cheb_full(b, x0, fd, sc, r2, frac, degree, "bf16")
    # the CPU wrapper is the plain version
    assert torch.equal(fz.cheb_full(b, x0, fd, sc, r2, frac, degree,
                                    compute="bf16"), want)
    assert torch.isfinite(want.to(torch.float32)).all()
    for group in B5C_GROUPS:
        got = _replay(fz, b, x0, fd, sc, r2, frac, degree, group)
        assert smoke._bits_differ(got, want) == 0, group


def test_hybrid_classes_have_uneven_side_counts():
    """The hybrid check case gives the groups classes of 8, 10 and 14
    sides: at G = 4 or 6 a class's last step leaves lanes without a side,
    and classes of one warp need different numbers of steps."""
    fz = _level("hybrid", "bf16")[0]
    cs = _class_start(fz)
    counts = sorted({b - a for a, b in zip(cs, cs[1:])})
    assert counts == [8, 10, 14]
    assert any(n % g for n in counts for g in B5C_GROUPS)
