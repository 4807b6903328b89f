"""The dense form's compute-once facts (``kernels/fused.py`` ``DenseForm``),
on which a kernel that computes each template edge's strains and forces
once per edge instance (the TPU kernel's ``edge_once``,
``stencil_pallas.py:379-400``) rests: both sides of an edge carry the same
K and E columns, so E and Sd = K E are the same bits whichever side
computes them; a torch replay that computes Sd once per edge instance
over the padded grid and then adds every side's row in table order gives
the bits of ``DenseForm.plain`` (which ``tests/test_torch_fused_compute.py``
holds to JAX's ``ct=bf16`` kernels) from the table's own bf16 columns, in
float32 and bf16 storage; and ``ops_per_point`` counts that compute-once
work, against the per-side form's.  No kernel, no JAX."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pylatticedso_tpu_torch import smoke
from pylatticedso_tpu_torch.kernels.fused import DENSE_A, DENSE_B, DenseForm
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

GEOMS = {"octet": "Octet", "bcc": "BCC", "hybrid": smoke.HYBRID}
BF = torch.bfloat16
K_E = 2 + DENSE_A            # K's two columns, then E's nine slots


def _lattice(name, cells):
    return StructuredLattice(GEOMS[name], cells, (1.0, 1.0, 1.0),
                             smoke.E_MOD, smoke.NU, dtype=torch.float32,
                             device="cpu")


def _order(recs):
    """The side table's order of the records (stably by self class), as
    ``DenseForm.table`` holds them."""
    return sorted(range(len(recs)), key=lambda i: recs[i]["cs"])


def _cols(form, row) -> torch.Tensor:
    """The bf16 columns [17, 6] of ``form.table``'s row ``row``."""
    bits = np.ascontiguousarray(form.table["col"][row]).astype(np.int16)
    return torch.from_numpy(bits).view(BF)


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_both_sides_carry_the_same_strain_columns(name):
    """An edge's two side records hold the same K and E columns, bit for
    bit, and the same E terms: E and Sd depend on the edge instance only
    (d = uB - uA, p3 = uA[3:] + uB[3:] and r^2 at the anchor are the same
    from either side)."""
    form = DenseForm(_lattice(name, (3, 3, 3)))
    row = {i: j for j, i in enumerate(_order(form.recs))}
    for e in range(len(form.recs) // 2):
        a, b = form.recs[2 * e], form.recs[2 * e + 1]
        assert [k[:2] for k in a["dense_a"]] == [k[:2] for k in b["dense_a"]]
        ca = form.table["col"][row[2 * e]][:K_E]
        cb = form.table["col"][row[2 * e + 1]][:K_E]
        assert np.array_equal(ca, cb)
        assert a["ei"] == b["ei"] == e and (a["side"], b["side"]) == (0, 1)


def _replay_once(form: DenseForm, grid, up: torch.Tensor,
                 r2p: torch.Tensor) -> torch.Tensor:
    """K u in the dense form, Sd computed once per edge instance: for each
    template edge, at every anchor some interior point reads (padded
    1 - max(oa, ob) .. N - min(oa, ob) per axis), d, p3, K, E (every slot,
    a missing term as a zero column) and Sd = K E; then per class its
    sides in table order, each adding its row from Sd at the point minus
    its own offset.  u and r^2 are rounded to bf16 as they are read."""
    X, Y, Z = grid
    N = (X, Y, Z)
    u, r2 = up.to(BF), r2p.to(BF)
    recs = form.recs
    order = _order(recs)
    row_of = {i: j for j, i in enumerate(order)}
    sd, lo_of = {}, {}
    for e in range(len(recs) // 2):
        ra = recs[2 * e]
        oa = [-v for v in ra["dr3"]]
        ob = [-v for v in recs[2 * e + 1]["dr3"]]
        lo = [1 - max(a, b) for a, b in zip(oa, ob)]
        hi = [n - min(a, b) for n, a, b in zip(N, oa, ob)]
        box = lambda o: tuple(slice(l + v, h + v + 1)
                              for l, h, v in zip(lo, hi, o))
        uA = u[(ra["cs"], slice(None)) + box(oa)]
        uB = u[(ra["co"], slice(None)) + box(ob)]
        rr = r2[(ra["ei"],) + box((0, 0, 0))]
        col = _cols(form, row_of[2 * e])
        c = lambda q: col[q].view(6, 1, 1, 1)
        K = rr * c(0) + (rr * rr) * c(1)
        d = uB - uA
        p3 = uA[3:] + uB[3:]
        src = torch.cat([d, p3])                  # d0..d5, p0..p2
        E = src[0] * c(2)
        for s in range(1, DENSE_A):
            E = E + src[s] * c(2 + s)
        sd[e], lo_of[e] = K * E, lo
    out = torch.zeros((form.nc, 6, X, Y, Z), dtype=BF)
    for j, i in enumerate(order):
        r = recs[i]
        own = [-v for v in r["dr3"]]
        # the interior points' anchors in the edge's anchor box
        at = tuple(slice(1 - o - l, n + 1 - o - l)
                   for o, l, n in zip(own, lo_of[r["ei"]], N))
        S = sd[r["ei"]][(slice(None),) + at]
        col = _cols(form, j)
        rows = S[0] * col[K_E].view(6, 1, 1, 1)
        for k in range(1, DENSE_B):
            rows = rows + S[k] * col[K_E + k].view(6, 1, 1, 1)
        out[r["cs"]] = out[r["cs"]] + rows
    return out


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("name,cells", [
    ("octet", (4, 4, 4)), ("octet", (3, 5, 6)), ("bcc", (5, 6, 7)),
    ("hybrid", (4, 4, 4)), ("hybrid", (6, 6, 6))])
def test_compute_once_gives_the_plain_bits(name, cells, storage):
    """Sd once per edge instance, the rows per side in table order: the
    bits of DenseForm.plain (0 elements differ), from inputs made with a
    numpy seed, in float32 storage (rounded to bf16 as read) and bf16."""
    sl = _lattice(name, cells)
    rng = np.random.default_rng(sum(cells) + len(name))
    u = rng.standard_normal((sl.nc, 6) + sl.grid).astype(np.float32)
    r = (0.04 + 0.05 * rng.random((sl.n_geom,) + tuple(cells))).astype(
        np.float32)
    mv, _ = sl.make_matvec()
    r2 = mv.prepare(torch.from_numpy(r))
    up = F.pad(torch.from_numpy(u), (1,) * 6)
    if storage == "bf16":
        up, r2 = up.to(BF), r2.to(BF)
    form = mv.apply.fused.dense_form
    want = form.plain(up.to(BF), r2.to(BF))
    got = _replay_once(form, sl.grid, up, r2)
    differ = int((got.view(torch.int16) != want.view(torch.int16)).sum())
    assert differ == 0


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_ops_per_point_counts_the_compute_once_form(name):
    """ops_per_point is the compute-once count (each edge's d, p3, K, E
    and Sd once, 28 + 12 a; each side's row and acc add, 12 b), below the
    per-side count (every side's own d, p3, K, E and Sd) that the slab
    kernels issue."""
    form = DenseForm(_lattice(name, (2, 2, 2)))
    recs = form.recs
    once = sum(28 + 12 * len(recs[2 * e]["dense_a"])
               + 12 * (len(recs[2 * e]["dense_b"])
                       + len(recs[2 * e + 1]["dense_b"]))
               for e in range(len(recs) // 2))
    per_side = sum(28 + 12 * len(r["dense_a"]) + 12 * len(r["dense_b"])
                   for r in recs)
    assert form.ops_per_point() == once < per_side
