"""B5's host-side launch plan (``kernels/fused.py``): the cluster-size
rule, the partition of a level's interior items over the cluster's blocks
and threads, and where d and r^2 live.  The kernel takes
the plan as it is, so a plan that lost or repeated an item would give a
wrong smoother on the card; these run on the CPU, at the levels of the
50^3 hierarchies (host build only, no kernel)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pylatticedso_tpu_torch import smoke
from pylatticedso_tpu_torch.kernels.fused import (
    B5_CLUSTERS, B5_ITEMS_PER_BLOCK, B5_LAYOUTS, B5_MAX_DEGREE, B5_MAX_IPT,
    B5_MAX_THREADS, B5_Q_BITS, B5_SMEM_LAYOUT, B5_SMEM_LIMIT,
    B5C_BCAST_ITEMS, B5C_GROUPS, B5C_MAX_THREADS, DENSE_DTYPE, SOURCE,
    b5_items, b5_partition, b5_plan, b5_smem_bytes, b5c_groups, b5c_lanes,
    b5c_side_order, route)
from pylatticedso_tpu_torch.kernels.stencil import SIDE_DTYPE
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

GEOMS = {"octet": "Octet", "hybrid": smoke.HYBRID}


def _single_levels(geom, n=50):
    """(lattice, storage itemsize) of every level of the n^3 hierarchy
    that the routing gives to B5, in either storage."""
    out = []
    for cells in smoke.level_cells(n):
        if cells > 13:             # never single in either geometry
            continue
        sl = StructuredLattice(geom, (cells,) * 3, (1.0, 1.0, 1.0),
                               smoke.E_MOD, smoke.NU, dtype=torch.float32,
                               device="cpu")
        for storage, itemsize in (("bf16", 2), ("f32", 4)):
            with smoke._env(PLDSO_MG_FUSED_DTYPE=storage):
                if route(sl)[1]:
                    out.append((sl, itemsize))
    return out


def _decode(items):
    return items >> B5_Q_BITS, items & ((1 << B5_Q_BITS) - 1)


@pytest.mark.parametrize("name", ["octet", "hybrid"])
def test_partition_covers_every_interior_item_once_in_order(name):
    levels = _single_levels(GEOMS[name])
    # 50^3 Octet: 7^3, 4^3 and 2^3 in both storages; the hybrid: 4^3, 2^3
    assert sorted({sl.num_cells[0] for sl, _ in levels}) == \
        ([2, 4, 7] if name == "octet" else [2, 4])
    for sl, itemsize in levels:
        X, Y, Z = sl.grid
        Yp, Zp = Y + 2, Z + 2
        items = b5_items(sl.nc, sl.grid)
        c, q = _decode(items.astype(np.int64))
        # every interior (class, point) once, in ascending order
        assert items.size == sl.nc * X * Y * Z
        assert np.all(np.diff(items) > 0)
        x, y, z = q // (Yp * Zp), (q // Zp) % Yp, q % Zp
        assert x.min() == 1 and x.max() == X and y.min() == 1 \
            and y.max() == Y and z.min() == 1 and z.max() == Z
        assert np.array_equal(np.bincount(c), np.full(sl.nc, X * Y * Z))
        n_sides = 2 * len(sl.edges)
        planned = 0
        for cluster in B5_CLUSTERS:
            try:
                plan = b5_plan(sl.nc, sl.grid, len(sl.edges), n_sides,
                               itemsize, cluster)
            except ValueError:
                # only where the cluster is too small for the level's
                # items, or larger than their count
                assert -(-items.size // cluster) > \
                    B5_MAX_THREADS * B5_MAX_IPT or cluster > items.size
                continue
            planned += 1
            assert plan["cluster"] == cluster
            assert plan["threads"] <= B5_MAX_THREADS
            assert plan["threads"] * plan["ipt"] >= plan["per_block"]
            parts = b5_partition(plan)
            assert len(parts) == cluster
            # blocks own contiguous, ascending shares, together every item
            # exactly once
            start = 0
            for part in parts:
                assert np.array_equal(np.sort(part),
                                      np.arange(start, start + part.size))
                assert part.size <= plan["per_block"]
                start += part.size
            assert start == items.size
            assert np.array_equal(np.sort(np.concatenate(parts)),
                                  np.arange(items.size))
            # every thread slot holds at most one item per j, and a block's
            # threads cover its share with ipt slots each
            for part in parts:
                slot = (part - part.min()) % plan["threads"]
                assert np.all(np.bincount(slot) <= plan["ipt"])
        assert planned >= 3


@pytest.mark.parametrize("name", ["octet", "hybrid"])
def test_cluster_rule_and_layout(name):
    """The rule's cluster is the smallest that leaves at most
    B5_ITEMS_PER_BLOCK items to a block (capped at 16); d goes to shared
    memory exactly where it fits one block; r^2 joins it where it fits."""
    for sl, itemsize in _single_levels(GEOMS[name]):
        n_items = sl.nc * np.prod(sl.grid)
        n_sides = 2 * len(sl.edges)
        plan = b5_plan(sl.nc, sl.grid, len(sl.edges), n_sides, itemsize)
        want = next((c for c in B5_CLUSTERS
                     if -(-n_items // c) <= B5_ITEMS_PER_BLOCK),
                    B5_CLUSTERS[-1])
        assert plan["cluster"] == want
        Fp = int(np.prod([g + 2 for g in sl.grid]))
        size = lambda lay, r2s: b5_smem_bytes(lay, sl.nc, Fp, n_sides,
                                              len(sl.edges), r2s, itemsize)
        fits = size(B5_SMEM_LAYOUT, False) <= B5_SMEM_LIMIT
        assert plan["layout"] == (B5_SMEM_LAYOUT if fits else "global")
        assert plan["r2_smem"] == (size(plan["layout"], True)
                                   <= B5_SMEM_LIMIT)
        assert plan["smem_bytes"] <= B5_SMEM_LIMIT
        if sl.num_cells[0] == 7:          # the 50^3 Octet's 7^3 level
            assert (plan["cluster"], plan["threads"], plan["ipt"]) == \
                (8, 256, 1)
        forced = b5_plan(sl.nc, sl.grid, len(sl.edges), n_sides, itemsize,
                         layout="global")
        assert forced["layout"] == "global" \
            and forced["smem_bytes"] <= plan["smem_bytes"]


def test_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="cluster 3"):
        b5_plan(4, (8, 8, 8), 24, 48, 2, cluster=3)
    with pytest.raises(ValueError, match="do not fit"):
        b5_plan(4, (8, 8, 8), 24, 48, 2, cluster=1)     # 2,048 items
    with pytest.raises(ValueError, match="layout"):
        b5_plan(4, (8, 8, 8), 24, 48, 2, layout="tiles")
    # a level whose d cannot sit in one block's shared memory
    big = b5_plan(1, (20, 20, 20), 3, 6, 4)      # d: 255 KB
    assert big["layout"] == "global"
    with pytest.raises(ValueError, match="shared memory"):
        b5_plan(1, (20, 20, 20), 3, 6, 4, layout=B5_SMEM_LAYOUT)


def test_plan_limits_are_the_kernel_source_limits():
    """The plan's limits are the ones the kernel is compiled with (the
    launcher refuses a plan beyond them, and the item encoding must
    agree)."""
    text = (Path(__file__).resolve().parents[1] / SOURCE).read_text()
    define = lambda name: int(re.search(rf"#define {name} (\d+)",
                                        text).group(1))
    assert define("B5_MAX_THREADS") == B5_MAX_THREADS
    assert define("B5_MAX_IPT") == B5_MAX_IPT
    assert define("B5_Q_BITS") == B5_Q_BITS
    assert define("B5_MAX_CLUSTER") == B5_CLUSTERS[-1]
    assert define("MAX_DEGREE") == B5_MAX_DEGREE
    a, b = re.search(r"static const int MAX_SMEM = (\d+) \* (\d+);",
                     text).groups()
    assert int(a) * int(b) == B5_SMEM_LIMIT
    assert define("B5C_MAX_THREADS") == B5C_MAX_THREADS
    assert define("B5C_MAX_GROUP") == B5C_GROUPS[-1]
    enum = dict(re.findall(r"(B5_\w+) = (\d+)",
                           re.search(r"enum \{([^}]*)\}", text).group(1)))
    assert {k: int(v) for k, v in enum.items()} == \
        {f"B5_{k.upper()}": v for k, v in B5_LAYOUTS.items()}


# ------------------------------------------------------------------ B5c
def _class_start(sl):
    counts = np.bincount([r for r in _side_classes(sl)], minlength=sl.nc)
    return np.concatenate([[0], np.cumsum(counts)]).tolist()


def _side_classes(sl):
    from pylatticedso_tpu_torch.kernels.stencil import edge_sides
    X, Y, Z = sl.grid
    return [r["cs"] for r in edge_sides(sl, Y + 2, Z + 2)]


@pytest.mark.parametrize("name", ["octet", "hybrid"])
def test_b5c_groups_own_every_item_once(name):
    """B5c's partition: at every cluster size and G the plan accepts,
    whole warps of 32 // G groups, one item slot per group and slot j;
    every interior item owned by exactly one group, blocks in contiguous
    ascending shares; every lane of a group names the same group, the
    lanes past a warp's last whole group none."""
    for sl, itemsize in _single_levels(GEOMS[name]):
        items = b5_items(sl.nc, sl.grid)
        n_sides = 2 * len(sl.edges)
        cs = _class_start(sl)
        most = max(b - a for a, b in zip(cs, cs[1:]))
        planned = 0
        for cluster in B5_CLUSTERS:
            for group in B5C_GROUPS:
                try:
                    plan = b5_plan(sl.nc, sl.grid, len(sl.edges), n_sides,
                                   itemsize, cluster, compute="bf16",
                                   group=group, max_sides=most)
                except ValueError:
                    continue
                planned += 1
                assert plan["group"] == group and plan["compute"] == "bf16"
                assert plan["kmax"] == -(-most // group)
                assert plan["threads"] % 32 == 0
                assert plan["threads"] <= B5C_MAX_THREADS
                assert b5c_groups(plan) * plan["ipt"] >= plan["per_block"]
                # no fewer slots would do: ipt is the smallest that fits
                if plan["ipt"] > 1:
                    assert -(-(-(-plan["per_block"] // (plan["ipt"] - 1)))
                             // (32 // group)) * 32 > B5C_MAX_THREADS
                parts = b5_partition(plan)
                start = 0
                for part in parts:
                    assert np.array_equal(
                        np.sort(part), np.arange(start, start + part.size))
                    start += part.size
                assert start == items.size
                lanes = b5c_lanes(plan)
                g, j = lanes[:, 0], lanes[:, 1]
                assert np.all(j < group)
                owned = g[g >= 0]
                assert np.array_equal(np.unique(owned),
                                      np.arange(b5c_groups(plan)))
                assert np.all(np.bincount(owned) == group)
                # a group's lanes are consecutive lanes of one warp
                t = np.arange(plan["threads"])
                for k in np.unique(owned):
                    ts = t[g == k]
                    assert np.array_equal(np.diff(ts), np.ones(group - 1))
                    assert len(set(ts // 32)) == 1
                    assert np.array_equal(j[g == k], np.arange(group))
        assert planned >= 6


@pytest.mark.parametrize("name", ["octet", "hybrid"])
def test_b5c_every_side_once_in_table_order(name):
    """Every side of a class is computed by exactly one lane of its group
    (lane (s - s_begin) % G at step (s - s_begin) // G), and the group adds
    the rows in table order, for Octet's classes of 12 sides and the
    hybrid's of 8, 10 and 14; the steps every lane of a warp takes are the
    most any class needs."""
    sl = _single_levels(GEOMS[name])[0][0]
    cs = _class_start(sl)
    counts = [b - a for a, b in zip(cs, cs[1:])]
    assert sorted(set(counts)) == ([12] if name == "octet" else [8, 10, 14])
    for group in B5C_GROUPS:
        kmax = -(-max(counts) // group)
        for c in range(sl.nc):
            order = b5c_side_order(group, cs[c], cs[c + 1], kmax)
            assert [s for s, _, _ in order] == list(range(cs[c], cs[c + 1]))
            for s, lane, k in order:
                assert (lane, k) == divmod(s - cs[c], group)[::-1]
                assert lane < group and k < kmax


def test_b5c_rule_and_shared_memory():
    """B5c's rule per level of the 50^3 Octet hierarchy (cluster and G),
    and its shared memory as the kernel carves it: the side table,
    class_start, the dense records, d as bf16 pairs (layout bcast), the
    block's items' x, r, d, fd in float, every thread's rows (3 words for
    each of its kmax sides), r^2 where it fits."""
    levels = {sl.num_cells[0]: (sl, isz)
              for sl, isz in _single_levels("Octet") if isz == 2}
    n_sides = 48
    for cells, (sl, isz) in sorted(levels.items()):
        plan = b5_plan(sl.nc, sl.grid, len(sl.edges), n_sides, isz,
                       compute="bf16", max_sides=12)
        f32 = b5_plan(sl.nc, sl.grid, len(sl.edges), n_sides, isz)
        assert (plan["cluster"], plan["group"]) == B5C_RULE[cells]
        assert (f32["group"], f32["compute"]) == (1, "f32")
        Fp = int(np.prod([g + 2 for g in sl.grid]))
        bcast = plan["per_block"] <= B5C_BCAST_ITEMS
        assert plan["layout"] == ("bcast" if bcast else "global")
        want = (_al(n_sides * SIDE_DTYPE.itemsize) + _al(4 * (sl.nc + 1))
                + _al(n_sides * DENSE_DTYPE.itemsize)
                + (_al(4 * sl.nc * 3 * Fp) if bcast else 0)
                + _al(96 * plan["per_block"])
                + _al(12 * plan["kmax"] * plan["threads"])
                + (_al(isz * len(sl.edges) * Fp) if plan["r2_smem"] else 0))
        assert plan["kmax"] == -(-12 // plan["group"]) and plan["r2_smem"]
        assert plan["smem_bytes"] == want == b5_smem_bytes(
            plan["layout"], sl.nc, Fp, n_sides, len(sl.edges), True, isz,
            "bf16", plan["per_block"], plan["threads"], plan["kmax"])
        # d in bf16 pairs: half of B5's float copy
        assert b5_smem_bytes("bcast", sl.nc, Fp, n_sides, 0, False, isz,
                             "bf16") \
            - b5_smem_bytes("global", sl.nc, Fp, n_sides, 0, False, isz,
                            "bf16") == _al(4 * sl.nc * 3 * Fp)
        assert b5_smem_bytes("bcast", sl.nc, Fp, n_sides, 0, False, isz) \
            - b5_smem_bytes("global", sl.nc, Fp, n_sides, 0, False, isz) \
            == _al(4 * sl.nc * 6 * Fp)


def test_b5c_plan_refusals():
    bf16c = {"compute": "bf16", "max_sides": 12}
    with pytest.raises(ValueError, match="group 5"):
        b5_plan(4, (8, 8, 8), 24, 48, 2, group=5, **bf16c)
    with pytest.raises(ValueError, match="max_sides"):
        b5_plan(4, (8, 8, 8), 24, 48, 2, compute="bf16")
    # 2,048 items on one block of 1,024 threads in groups of 12 (2 a warp)
    with pytest.raises(ValueError, match="do not fit"):
        b5_plan(4, (8, 8, 8), 24, 48, 2, cluster=1, group=12, **bf16c)
    # the items' state, the rows and d's pairs pass one block's shared
    # memory
    with pytest.raises(ValueError, match="shared memory"):
        b5_plan(4, (8, 8, 8), 24, 48, 2, cluster=1, group=1,
                layout="bcast", **bf16c)
    with pytest.raises(ValueError, match="cluster 3"):
        b5_plan(4, (8, 8, 8), 24, 48, 2, cluster=3, **bf16c)
    # B5's plan takes no group
    assert b5_plan(4, (8, 8, 8), 24, 48, 2, cluster=8, group=4)["group"] \
        == 1


def _al(n):
    return (n + 15) // 16 * 16


# the rule's (cluster, G) per single level of the 50^3 Octet hierarchy:
# the fastest, or within 2% of it, of the card's sweep over every cluster,
# layout and G (kernels/fused.py B5C_GROUP_RULE)
B5C_RULE = {7: (16, 4), 4: (16, 6), 2: (16, 12)}
