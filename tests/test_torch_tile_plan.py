"""The slab kernels' host plan (``kernels/stencil.py`` ``slab_plan``),
held to the index mapping of B1, B3 and B4 (``csrc/stencil_matvec.cu``,
``csrc/mg_fused.cu``, the slab body in ``csrc/stencil_body.cuh``),
emulated in numpy: the slabs cover every output point once, every side's
reads from a computed point stay inside the padded grid (the ghost
padding is the kernels' halo), the side table's grid offsets reach the
same operands as the flat shifts, and the plan's limits are the source's.
The kernels take the plan as it is, so a plan that lost a point or read
past the grid would give a wrong operator on the card.  Host build only:
no kernel, no JAX."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pylatticedso_tpu_torch import smoke
from pylatticedso_tpu_torch.kernels.stencil import (
    BEAM_RUN, SIDE_DTYPE_F64, SLAB_HALO, SLAB_THREADS,
    edge_sides, side_table, slab_plan, stencil_reach)
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "pylatticedso_tpu_torch" / "csrc"
GEOMS = {"octet": "Octet", "bcc": "BCC", "hybrid": smoke.HYBRID}
# every MG level's cells of the 50^3 hierarchy, and grids no slab divides
CELLS = [(c,) * 3 for c in smoke.level_cells(50)] + [(5, 6, 7), (13, 13, 13),
                                                     (3, 9, 40)]


def _lattice(name, cells=(2, 2, 2)):
    return StructuredLattice(GEOMS[name], cells, (1.0, 1.0, 1.0),
                             smoke.E_MOD, smoke.NU, dtype=torch.float32,
                             device="cpu")


def _blocks(plan, grid, padded):
    """The launchers' grid: (runs per plane, planes), over the interior
    planes (B1) or the padded ones (B3, B4)."""
    X, Y, Z = grid
    return -(-((Y + 2) * (Z + 2)) // plan["run"]), X + 2 if padded else X


def _points(plan, grid, padded):
    """Per (block, thread) of a launch, as the kernels map them: the
    padded point (x, y, z), the thread's class, and whether it computes
    (B1: an interior point; B3, B4: any padded point, ghosts written
    zero)."""
    X, Y, Z = grid
    Yp, Zp = Y + 2, Z + 2
    runs, planes = _blocks(plan, grid, padded)
    t = np.arange(plan["threads"])
    c, r = t // plan["run"], t % plan["run"]
    bx, by = np.meshgrid(np.arange(runs), np.arange(planes), indexing="ij")
    bx, by = bx.reshape(-1, 1), by.reshape(-1, 1)
    f = bx * plan["run"] + r                    # flat (y, z) of the plane
    x = by + (0 if padded else 1)               # B1's planes are interior
    y, z = f // Zp, f % Zp
    inside = f < Yp * Zp
    if padded:
        live = inside
    else:
        live = inside & (y >= 1) & (y <= Y) & (z >= 1) & (z <= Z)
    return (x + 0 * f, y, z), c + 0 * f, live


def _cover(plan, grid, nc, padded):
    """How many times the launch computes each (class, padded point)."""
    (x, y, z), c, live = _points(plan, grid, padded)
    assert c.max() == nc - 1                    # every thread has a class
    count = np.zeros((nc,) + tuple(e + 2 for e in grid), np.int64)
    np.add.at(count, (c[live], x[live], y[live], z[live]), 1)
    return count


def _assert_cover(plan, nc, kernels=("B1", "B4")):
    for cells in CELLS:
        grid = tuple(c + 1 for c in cells)
        inner = np.zeros((nc,) + tuple(e + 2 for e in grid), np.int64)
        inner[:, 1:-1, 1:-1, 1:-1] = 1
        if "B1" in kernels:
            assert np.array_equal(_cover(plan, grid, nc, False), inner), \
                (cells, plan)
        if {"B3", "B4"} & set(kernels):
            assert np.all(_cover(plan, grid, nc, True) == 1), (cells, plan)


@pytest.mark.parametrize("name,kernels", [
    pytest.param(n, ("B1", "B4"), id=n) for n in sorted(GEOMS)] + [
    pytest.param(n, ("B3",), id=f"{n}-B3") for n in sorted(GEOMS)])
def test_slabs_cover_every_point_once(name, kernels):
    """B1 computes every interior (class, point) once and nothing else; B3
    and B4 every padded one once (ghosts written zero); on every level of
    the 50^3 hierarchy and on grids no run divides, under the template's
    plan (B3's own: the wrapper's, asked for B3)."""
    sl = _lattice(name)
    plan = slab_plan(sl.nc, stencil_reach(sl))
    if "B3" in kernels:
        fz = sl.make_matvec()[0].apply.fused
        assert fz.b3_plan(torch.bfloat16) == fz.b3_plan(torch.float32) \
            == plan
    _assert_cover(plan, sl.nc, kernels)


@pytest.mark.parametrize("nc", [1, 3, 5, 24, SLAB_THREADS])
def test_slabs_cover_any_class_count(nc):
    """The rule's plan covers every point once for class counts whose
    blocks fall short of SLAB_THREADS (3, 5, 24) and at its ends."""
    plan = slab_plan(nc, (1, 1, 1))
    assert plan["threads"] <= SLAB_THREADS < 2 * plan["threads"]
    _assert_cover(plan, nc)


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_reads_stay_in_the_padded_grid(name):
    """From every point a slab computes, each side's other endpoint
    (q + du) and r^2 anchor (q + dr) lie inside the padded grid: the
    ghost padding holds the template's reach; and the table's grid
    offsets (co * 6 * Fp + du, ei * Fp + dr) land on the same flat
    element as the row and the shift do."""
    grid = (6, 7, 8)
    sl = StructuredLattice(GEOMS[name], tuple(g - 1 for g in grid),
                           (1.0,) * 3, smoke.E_MOD, smoke.NU,
                           dtype=torch.float32, device="cpu")
    reach = stencil_reach(sl)
    assert reach == (1, 1, 1)
    plan = slab_plan(sl.nc, reach)
    recs = edge_sides(sl, grid[1] + 2, grid[2] + 2)
    Xp, Yp, Zp = (g + 2 for g in grid)
    Fp = Xp * Yp * Zp
    for padded in (False, True):
        (x, y, z), _g, live = _points(plan, grid, padded)
        inner = live & (x >= 1) & (x <= grid[0]) & (y >= 1) \
            & (y <= grid[1]) & (z >= 1) & (z <= grid[2])
        for r in recs:
            for vec in (r["du3"], r["dr3"]):
                for a, (p, e) in enumerate(zip((x, y, z), (Xp, Yp, Zp))):
                    moved = p[inner] + vec[a]
                    assert moved.min() >= 0 and moved.max() < e
    # the grid offsets of the B1/B4 table against the flat layout
    mv, _ = sl.make_matvec()
    table, _ = side_table(sl)
    q = (2 * Yp + 3) * Zp + 4                   # an interior point
    for j, rec in enumerate(table):
        du = int(rec["co"]) * 6 * Fp + int(rec["du"])
        dr = int(rec["ei"]) * Fp + int(rec["dr"])
        other = np.unravel_index(q + du, (sl.nc * 6, Xp, Yp, Zp))
        assert other[0] == rec["co"] * 6
        anchor = np.unravel_index(q + dr, (len(sl.edges), Xp, Yp, Zp))
        assert anchor[0] == rec["ei"]
    dev = mv.apply.tables("cpu")[0].numpy()
    got = dev.view(table.dtype)
    assert np.array_equal(got["du"], table["co"] * 6 * Fp + table["du"])
    assert np.array_equal(got["dr"], table["ei"] * Fp + table["dr"])


def test_rule():
    """The rule gives each class of a point its own thread in blocks of
    SLAB_THREADS: runs of 32 points for Octet (4 classes), 64 for BCC, 8
    for the 16-class hybrid; other class counts take the largest power of
    two of points that fits."""
    for name, run in (("octet", 32), ("bcc", 64), ("hybrid", 8)):
        sl = _lattice(name)
        plan = slab_plan(sl.nc, stencil_reach(sl))
        assert plan["run"] == run
        assert plan["threads"] == sl.nc * run == SLAB_THREADS
        assert plan["halo"] == (SLAB_HALO,) * 3
    for nc, run in ((1, 128), (3, 32), (5, 16), (40, 2), (128, 1)):
        plan = slab_plan(nc, (1, 1, 1))
        assert (plan["run"], plan["threads"]) == (run, nc * run)


def test_refusals():
    """A reach beyond the ghost padding raises, and so does a template of
    more classes than a block holds threads; so does the wrapper for a
    grid beyond 32-bit indexing."""
    with pytest.raises(ValueError, match="reaches"):
        slab_plan(4, (2, 1, 1))
    with pytest.raises(ValueError, match="reaches"):
        slab_plan(4, (1, 1, 3))
    for nc in (0, SLAB_THREADS + 1, 600):
        with pytest.raises(ValueError, match="classes"):
            slab_plan(nc, (1, 1, 1))
    sl = _lattice("octet")
    mv, _ = sl.make_matvec()
    mv.apply.grid = (900, 900, 900)
    with pytest.raises(ValueError, match="32 bits"):
        mv.apply.slab_plan(torch.float32)


def test_wrapper_plan_is_the_rule():
    """StencilMatvec.slab_plan is slab_plan of the lattice's template, the
    same for every storage dtype, and cached."""
    sl = _lattice("hybrid", (3, 4, 5))
    mv, _ = sl.make_matvec()
    B = mv.apply
    for io in (torch.float32, torch.bfloat16, torch.float64):
        plan = B.slab_plan(io)
        assert plan == slab_plan(sl.nc, stencil_reach(sl))
        assert B.slab_plan(io) is plan
    assert B.reach == (1, 1, 1)


def test_limits_are_the_kernel_source_limits():
    """The host's limits are the ones the kernels are compiled with: the
    halo and the block size, which bounds every slab kernel's launch (B1,
    B3, B4) and the r^2-cotangent's; the launchers check the host's plan
    against the same rule, and B3 and B4 launch over the padded planes."""
    body = (CSRC / "stencil_body.cuh").read_text()
    define = lambda text, name: int(
        re.search(rf"#define {name} (\d+)", text).group(1))
    assert define(body, "SLAB_HALO") == SLAB_HALO
    assert define(body, "SLAB_THREADS") == SLAB_THREADS
    assert "nc * run <= SLAB_THREADS" in body
    for src, kernel in (("stencil_matvec.cu", "stencil_matvec_kernel"),
                        ("stencil_matvec.cu", "stencil_vjp_r2_kernel"),
                        ("mg_fused.cu", "mg_residual_kernel"),
                        ("mg_fused.cu", "mg_cheb_run_kernel")):
        text = (CSRC / src).read_text()
        assert re.search(r"__launch_bounds__\(SLAB_THREADS\)\s*\n"
                         + kernel + r"\(", text), kernel
        assert "slab_plan_ok(run, nc)" in text, src
    fused = (CSRC / "mg_fused.cu").read_text()
    assert fused.count("slab_plan_ok(run, nc)") == 2       # B3 and B4
    assert fused.count("const dim3 grid(((Y + 2) * (Z + 2) + run - 1) / run,"
                       " X + 2);") == 1                    # B3
    assert "const dim3 grid(((s.Y + 2) * (s.Z + 2) + run - 1) / run, " \
           "s.X + 2);" in fused                            # B4
    matvec = (CSRC / "stencil_matvec.cu").read_text()
    assert define(matvec, "BEAM_RUN") == BEAM_RUN
    assert "#define BEAM_EDGES (SLAB_THREADS / BEAM_RUN)" in matvec
    assert "grid((n_e + BEAM_EDGES - 1) / BEAM_EDGES" in matvec
    # the one side table: no plain-offset table, no second K.u body
    for src in ("stencil_body.cuh", "stencil_matvec.cu", "mg_fused.cu"):
        text = (CSRC / src).read_text()
        assert not re.search(r"\bstencil_acc", text), src
        assert not re.search(r"\binterior\(", text), src
        assert "long long q" not in text, src
    assert SIDE_DTYPE_F64.itemsize % 16 == 0       # 16-byte records
