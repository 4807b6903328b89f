"""The r^2-cotangent kernel's host side (``kernels/stencil.py``
``beam_plan``, ``beam_table`` and the side table with the grid's offsets),
held to the kernel's index mapping and arithmetic
(``csrc/stencil_matvec.cu`` ``stencil_vjp_r2_kernel``), emulated in
numpy:

* the launch covers every (edge, padded r^2 position) once;
* a beam's endpoint tests (from the packed 3-D offsets) drop exactly the
  sides the one-thread-per-side-pair kernel skipped (its flat range and
  interior tests), and every read of a beam the kernel computes lies inside
  the padded grid, at the element the flat layout names;
* the beam formula, evaluated in float64 as the kernel evaluates it,
  matches the plain closed form ``apply_gather_vjp_r2`` to 1e-12.

Host build only: no kernel, no JAX."""

import numpy as np
import pytest
import torch

from pylatticedso_tpu_torch import smoke
from pylatticedso_tpu_torch.kernels.stencil import (
    BEAM_RUN, SIDE_DTYPE, SIDE_DTYPE_F64, SLAB_THREADS,
    beam_plan, beam_table, edge_sides, stencil_reach)
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

GEOMS = {"octet": "Octet", "bcc": "BCC", "hybrid": smoke.HYBRID}
# every MG level's cells of the 50^3 hierarchy, and grids no run divides
CELLS = [(c,) * 3 for c in smoke.level_cells(50)] + [(5, 6, 7), (13, 13, 13),
                                                     (3, 9, 40)]


def _lattice(name, cells=(2, 2, 2), dtype=torch.float32):
    return StructuredLattice(GEOMS[name], cells, (1.0, 1.0, 1.0),
                             smoke.E_MOD, smoke.NU, dtype=dtype,
                             device="cpu")


def _unpack(o):
    """The kernel's unpacking of a packed offset: bytes minus one."""
    return np.array([((int(o) >> (8 * a)) & 0xFF) - 1 for a in range(3)])


def _launch(plan, grid, n_e):
    """The launcher's grid and the kernel's thread mapping: per (edge
    block, run block, thread), the edge and the flat point of a plane the
    thread takes and whether it is live; the padded planes are blockIdx.z,
    one each."""
    X, Y, Z = grid
    P = (Y + 2) * (Z + 2)
    run = plan["run"]
    per = SLAB_THREADS // run
    t = np.arange(plan["threads"])[None, None, :]
    bx = np.arange(-(-n_e // per))[:, None, None]
    by = np.arange(-(-P // run))[None, :, None]
    e = bx * per + t // run + 0 * by
    f = by * run + t % run + 0 * bx
    return e, f, (e < n_e) & (f < P), np.arange(X + 2)


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_beam_launch_covers_every_position_once(name):
    """Over a plane's blocks, the threads take every (edge, flat point)
    pair once, and the planes are every padded plane once: every (edge,
    padded r^2 position) once, on every level of the 50^3 hierarchy and
    on grids no run divides."""
    sl = _lattice(name)
    n_e = len(sl.edges)
    plan = beam_plan(n_e, stencil_reach(sl))
    assert plan["threads"] == SLAB_THREADS and plan["run"] == BEAM_RUN
    assert plan["edges"] * plan["run"] == SLAB_THREADS
    assert plan["groups"] == -(-n_e // plan["edges"])
    for cells in CELLS:
        grid = tuple(c + 1 for c in cells)
        e, f, live, planes = _launch(plan, grid, n_e)
        P = (grid[1] + 2) * (grid[2] + 2)
        count = np.zeros((n_e, P), np.int64)
        np.add.at(count, (e[live], f[live]), 1)
        assert np.all(count == 1), (cells, plan)
        assert np.array_equal(planes, np.arange(grid[0] + 2))


def _parent_in(Q, dr, grid):
    """The one-thread-per-side-pair kernel's test of one side at padded
    positions Q: its output point q = Q - dr in the flat range and
    interior."""
    X, Y, Z = grid
    Yp, Zp = Y + 2, Z + 2
    Fp = (X + 2) * Yp * Zp
    q = Q - dr
    z, y, x = q % Zp, (q // Zp) % Yp, q // (Yp * Zp)
    return (q >= 0) & (q < Fp) & (x >= 1) & (x <= X) & (y >= 1) & (y <= Y) \
        & (z >= 1) & (z <= Z)


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_beam_reads_stay_inside_or_are_skipped(name):
    """For every (edge, padded position) of small grids: the kernel's
    endpoint tests equal the parent's range and interior tests of side A
    and side B; a beam with an interior endpoint reads u and g only inside
    the padded grid, at the rows of its endpoints' classes; the beam
    table names each edge's side A."""
    for cells in ((4, 5, 6), (1, 3, 2)):
        sl = _lattice(name, cells)
        grid = sl.grid
        X, Y, Z = grid
        Xp, Yp, Zp = X + 2, Y + 2, Z + 2
        Fp = Xp * Yp * Zp
        mv, _ = sl.make_matvec()
        B = mv.apply
        table = B.tables("cpu")[0].numpy().view(SIDE_DTYPE)
        beams = beam_table(sl)
        assert np.array_equal(beams, B._beams)
        recs = edge_sides(sl, Yp, Zp)
        Q = np.arange(Fp)
        px, py, pz = Q // (Yp * Zp), (Q // Zp) % Yp, Q % Zp
        for e, (row, ca, oa, ob) in enumerate(beams):
            sd = table[row]
            assert sd["ei"] == e and sd["side"] == 0
            assert ca == recs[2 * e]["cs"] and sd["co"] == recs[2 * e]["co"]
            ends = []
            for o in (oa, ob):
                o3 = _unpack(o)
                x, y, z = px + o3[0], py + o3[1], pz + o3[2]
                inside = (x >= 1) & (x <= X) & (y >= 1) & (y <= Y) \
                    & (z >= 1) & (z <= Z)
                ends.append((inside, (x, y, z)))
            (inA, pA), (inB, pB) = ends
            assert np.array_equal(inA, _parent_in(Q, recs[2 * e]["dr"],
                                                  grid))
            assert np.array_equal(inB, _parent_in(Q, recs[2 * e + 1]["dr"],
                                                  grid))
            live = inA | inB
            for p3 in (pA, pB):
                for v, ext in zip(p3, (Xp, Yp, Zp)):
                    assert v[live].min() >= 0 and v[live].max() < ext
            # the kernel's flat addresses against the 3-D endpoints
            qA = Q + e * Fp - int(sd["dr"])
            rA = int(ca) * 6 * Fp + qA
            rB = qA + int(sd["du"])
            flat = lambda p3: (p3[0] * Yp + p3[1]) * Zp + p3[2]
            assert np.array_equal(rA[live],
                                  int(ca) * 6 * Fp + flat(pA)[live])
            assert np.array_equal(rB[live],
                                  int(sd["co"]) * 6 * Fp + flat(pB)[live])


def _emulate(B, u, g, r2p):
    """The kernel's arithmetic in float64 numpy: per edge, every anchor
    with an interior endpoint forms the beam's strains and r^2-derivative
    row once and dots them with g at both endpoints (g of a non-interior
    endpoint taken as zero); the rest write 0."""
    X, Y, Z = B.grid
    Xp, Yp, Zp = X + 2, Y + 2, Z + 2
    Fp = Xp * Yp * Zp
    pad = lambda a: np.pad(a.numpy(), [(0, 0)] * 2 + [(1, 1)] * 3)
    up, gp = pad(u).reshape(-1), pad(g).reshape(-1)
    r2 = r2p.numpy().reshape(-1)
    table = B.tables("cpu", torch.float64)[0].numpy().view(SIDE_DTYPE_F64)
    E, kG, G2 = B.consts
    pi = np.pi
    Q = np.arange(Fp)
    px, py, pz = Q // (Yp * Zp), (Q // Zp) % Yp, Q % Zp
    out = np.zeros(B.n_e * Fp)
    for e, (row, ca, oa, ob) in enumerate(B._beams):
        sd = table[row]
        ins = []
        for o in (oa, ob):
            o3 = _unpack(o)
            x, y, z = px + o3[0], py + o3[1], pz + o3[2]
            ins.append((x >= 1) & (x <= X) & (y >= 1) & (y <= Y)
                       & (z >= 1) & (z <= Z))
        live = ins[0] | ins[1]
        inA, inB = ins[0][live], ins[1][live]
        Ql = Q[live]
        qA = Ql + e * Fp - int(sd["dr"])
        rA, rB = int(ca) * 6 * Fp + qA, qA + int(sd["du"])
        a = [up[rA + k * Fp] for k in range(6)]
        b = [up[rB + k * Fp] for k in range(6)]
        la = [np.where(inA, gp[rA + k * Fp], 0.0) for k in range(6)]
        lb = [np.where(inB, gp[rB + k * Fp], 0.0) for k in range(6)]
        r2v = r2[e * Fp + Ql]
        t, n1, n2 = sd["t"], sd["a1"], sd["a2"]
        invL = sd["invL"]
        du = [b[k] - a[k] for k in range(3)]
        th = [a[k + 3] + b[k + 3] for k in range(3)]
        dt = [b[k + 3] - a[k + 3] for k in range(3)]
        dot = lambda v, w: v[0] * w[0] + v[1] * w[1] + v[2] * w[2]
        ev = [dot(du, t) * invL,
              dot(du, n1) * invL - dot(th, n2) * 0.5,
              dot(du, n2) * invL + dot(th, n1) * 0.5,
              dot(dt, t) * invL, dot(dt, n1) * invL, dot(dt, n2) * invL]
        dI = (pi * 0.5) * r2v
        s = [(E * pi) * ev[0], (kG * pi) * ev[1], (kG * pi) * ev[2],
             G2 * dI * ev[3], E * dI * ev[4], E * dI * ev[5]]
        hl = sd["halfL"]
        fu = [s[0] * t[k] + s[1] * n1[k] + s[2] * n2[k] for k in range(3)]
        ms = [hl * (s[2] * n1[k] - s[1] * n2[k]) for k in range(3)]
        md = [s[3] * t[k] + s[4] * n1[k] + s[5] * n2[k] for k in range(3)]
        acc = 0.0                               # the kernel's order
        for k in range(3):
            acc = acc + (lb[k] - la[k]) * fu[k]
        for k in range(3):
            acc = acc + (la[k + 3] + lb[k + 3]) * ms[k]
        for k in range(3):
            acc = acc + (lb[k + 3] - la[k + 3]) * md[k]
        out[e * Fp + Ql] = acc
    return out.reshape((B.n_e, Xp, Yp, Zp))


@pytest.mark.parametrize("name,cells", [("octet", (4, 3, 2)),
                                        ("bcc", (3, 4, 4)),
                                        ("hybrid", (2, 3, 2))])
def test_beam_formula_matches_plain_vjp_r2(name, cells):
    """The beam formula, emulated in float64 as the kernel evaluates it
    (the one side table with the grid's offsets, the beam table), equals
    the plain closed form at every padded r^2 position to 1e-12 of its
    largest value, zeros included: a sign or an endpoint out of place
    fails here before the card."""
    sl = _lattice(name, cells, torch.float64)
    mv, _ = sl.make_matvec()
    rng = np.random.default_rng(len(name) + sum(cells))
    shape = (sl.nc, 6) + sl.grid
    u = torch.tensor(rng.standard_normal(shape))
    g = torch.tensor(rng.standard_normal(shape))
    r = torch.tensor(0.04 + 0.05 * rng.random((sl.n_geom,) + tuple(cells)))
    r2p = mv.prepare(r)
    want = mv.apply_gather_vjp_r2(g, u, r2p).numpy()
    got = _emulate(mv.apply, u, g, r2p)
    assert np.abs(want).max() > 0
    assert np.array_equal(got == 0, want == 0)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-12, err


def test_beam_plan_refusals():
    """A template that reaches past the ghost padding, or has no edge,
    has no beam plan; the wrapper's plan is the rule's and is cached."""
    with pytest.raises(ValueError, match="reaches"):
        beam_plan(24, (1, 2, 1))
    with pytest.raises(ValueError, match="edges"):
        beam_plan(0, (1, 1, 1))
    sl = _lattice("hybrid", (3, 4, 5))
    B = sl.make_matvec()[0].apply
    for io in (torch.float32, torch.float64):
        plan = B.beam_plan(io)
        assert plan == beam_plan(len(sl.edges), (1, 1, 1))
        assert B.beam_plan(io) is plan
