"""The fused V-cycle's M (``parallel/multigrid.py`` ``_FusedVCycle``) and its
CUDA graph.

On the CPU, where kernels B3-B5 run their plain versions: a dropped M
holds no reference cycle, so the state it read goes at once, not at the
next garbage collection; the graph never engages; the launch counters a
capture takes back and a replay adds (ints and dicts of ints) round trip.
On the card (``-m gpu``, no JAX imported, each test skips without a card):
the graphed M gives the eager M's bits over successive applications in
both storages, a new M on the state replays the same graph, another
compute type makes another entry, B3-B5's launch counts equal the eager
run's, a profiled graphed M holds the eager M's fused kernel events, PCG
with it takes the same iterations to the same x, and a new state captures
anew with the old graph's memory given back.

    python -m pytest --noconftest -m gpu tests/test_torch_fused_vcycle.py
"""

import collections
import gc
import weakref

import numpy as np
import pytest
import torch

from pylatticedso_tpu_torch.fem.solve import pcg
from pylatticedso_tpu_torch.parallel import multigrid as mg
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice
from pylatticedso_tpu_torch.utils.timing import timing

OPTS = {"coarse_degree": 24, "smooth_frac": 0.35}


def _problem(n, device="cpu"):
    """An Octet lattice clamped on z = 0, its hierarchy and a fused MG
    state (the storage of ``PLDSO_MG_FUSED_DTYPE``, bf16 by default) at a
    seeded radius field."""
    sl = StructuredLattice("Octet", (n,) * 3, (1.0,) * 3, 1013.0, 0.3,
                           dtype=torch.float32, device=device)
    fixed = sl.select_nodes(lambda x, y, z: z == 0.0)
    free = np.broadcast_to((sl.node_valid & ~fixed)[:, None],
                           (sl.nc, 6) + sl.grid)
    h = mg.build_mg_hierarchy(sl, free)
    rng = np.random.default_rng(n)
    radius = torch.as_tensor(0.04 + 0.02 * rng.random((n,) * 3),
                             dtype=torch.float32, device=device)
    with torch.no_grad():
        st = mg.mg_precond_state(h, radius, power_iters=5, fused=True)
    return sl, h, st


def _residual(sl, h, seed):
    rng = np.random.default_rng(seed)
    free = h["levels"][0].free
    return free * torch.as_tensor(
        rng.standard_normal((sl.nc, 6) + sl.grid), dtype=torch.float32,
        device=free.device)


def test_dropped_fused_m_frees_its_state_at_once():
    """M holds no reference cycle: with the garbage collector off, the
    state's fused operands and diagonals go when the state and its last M
    do."""
    sl, h, st = _problem(8)
    alive = [weakref.ref(st["fused"][lvl][k])
             for lvl in range(len(h["levels"]))
             for k in ("fdinv", "fm", "r2")]
    alive += [weakref.ref(d) for d in st["Ds"]]
    M = mg.mg_apply(h, st, nu=(1, 2), fused=True, **OPTS)
    with torch.no_grad():
        M(_residual(sl, h, 0))
    gc.disable()
    try:
        del st, M
        assert all(w() is None for w in alive)
    finally:
        gc.enable()


def test_cpu_never_captures():
    """On the CPU the fused M runs eagerly: no graph entry, no capture or
    replay span under a profiler."""
    from torch.profiler import ProfilerActivity, profile
    sl, h, st = _problem(8)
    M = mg.mg_apply(h, st, nu=(1, 2), fused=True, **OPTS)
    before = timing.count("mg.graph.capture"), timing.count("mg.graph.replay")
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        for seed in range(3):
            M(_residual(sl, h, seed))
    assert (timing.count("mg.graph.capture"),
            timing.count("mg.graph.replay")) == before
    assert all(not slot for slot in st["graphs"].values())


class _Counted:
    COUNTERS = ("n", "by_key")

    def __init__(self):
        self.n, self.by_key = 3, {"a": 1}


def test_counters_round_trip():
    """What a capture counts is taken back and kept; each replay adds it:
    int counters and dicts of ints alike, a key made during the capture
    included."""
    ws = [_Counted(), _Counted()]
    before = mg._counts(ws)
    ws[0].n += 2
    ws[1].by_key["a"] += 1
    ws[1].by_key["b"] = 4
    made = {k: n - before.get(k, 0) for k, n in mg._counts(ws).items()
            if n != before.get(k, 0)}
    assert made == {(0, "n", None): 2, (1, "by_key", "a"): 1,
                    (1, "by_key", "b"): 4}
    mg._add(ws, {k: -n for k, n in made.items()})
    assert (ws[0].n, ws[1].by_key) == (3, {"a": 1, "b": 0})
    mg._add(ws, made)
    mg._add(ws, made)
    assert (ws[0].n, ws[1].by_key) == (7, {"a": 3, "b": 8})


# ----------------------------------------------------------------- card
N = 13                # levels 14^3 on B3 + B4, then 8^3, 5^3, 3^3 on B5


def _card(storage=None, monkeypatch=None):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if storage is not None:
        monkeypatch.setenv("PLDSO_MG_FUSED_DTYPE", storage)
    sl, h, st = _problem(N, "cuda")
    assert [lvl.fused.single_ok for lvl in h["levels"]] == \
        [False, True, True, True]
    return sl, h, st


def _eager(h, st, rs, **opts):
    """M's outputs with autograd on: the graph never engages."""
    M = mg.mg_apply(h, st, fused=True, **dict(OPTS, nu=(1, 2), **opts))
    with torch.enable_grad():
        return [M(r) for r in rs]


def _graphed(h, st, rs, **opts):
    M = mg.mg_apply(h, st, fused=True, **dict(OPTS, nu=(1, 2), **opts))
    with torch.no_grad():
        return [M(r) for r in rs]


def _entries(st):
    (slot,) = [v for k, v in st["graphs"].items() if k[0] == "fused"]
    return slot


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["bf16", "f32"])
def test_graphed_equals_eager_bitwise(storage, monkeypatch):
    sl, h, st = _card(storage, monkeypatch)
    rs = [_residual(sl, h, seed) for seed in range(3)]
    want = _eager(h, st, rs)
    assert not _entries(st)
    got = _graphed(h, st, rs)
    (g,) = _entries(st).values()
    assert g.graph is not None
    for w, g_ in zip(want, got):
        assert g_.dtype == torch.float32
        assert torch.equal(w, g_)
    # a new M on the same state replays the same graph
    again = _graphed(h, st, rs[::-1])
    assert list(_entries(st).values()) == [g]
    for w, g_ in zip(want[::-1], again):
        assert torch.equal(w, g_)


@pytest.mark.gpu
def test_compute_type_makes_another_entry(monkeypatch):
    sl, h, st = _card()
    rs = [_residual(sl, h, seed) for seed in range(3)]
    _graphed(h, st, rs)
    monkeypatch.setenv("PLDSO_MG_FUSED_COMPUTE", "bf16")
    want = _eager(h, st, rs)
    got = _graphed(h, st, rs)
    assert len(_entries(st)) == 2
    for w, g_ in zip(want, got):
        assert torch.equal(w, g_)


@pytest.mark.gpu
def test_launch_counts_equal_eager():
    sl, h, st = _card()
    rs = [_residual(sl, h, seed) for seed in range(4)]
    fzs = [lvl.fused for lvl in h["levels"]]

    def counts(run):
        for fz in fzs:
            for attr in fz.COUNTERS:
                getattr(fz, attr).clear() if attr.startswith("b5") else \
                    getattr(fz, attr).update(dict.fromkeys(getattr(fz, attr),
                                                           0))
        run(h, st, rs)
        return [[dict(getattr(fz, a)) for a in fz.COUNTERS] for fz in fzs]

    eager = counts(_eager)
    assert counts(_graphed) == eager
    assert eager[0][0]["residual"] == 2 * len(rs)
    assert eager[0][1]["cheb_run"] == 2 * len(rs)


@pytest.mark.gpu
def test_profiled_graph_holds_the_eager_kernels():
    from torch.profiler import ProfilerActivity, profile
    sl, h, st = _card()
    rs = [_residual(sl, h, seed) for seed in range(3)]
    _graphed(h, st, rs[:2])                   # eager, then the capture

    def kernels(run):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(h, st, rs[2:])
            torch.cuda.synchronize()
        return collections.Counter(
            e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and e.duration_ns() > 0)

    eager, graphed = kernels(_eager), kernels(_graphed)
    fused = lambda c: {k: n for k, n in c.items() if "mg_" in k}
    # B3 on every level above the coarsest (level 0 twice), level 0's two
    # B4 final emits, B5 twice on levels 1-2 and once on the coarsest
    assert sum(fused(eager).values()) == 4 + 2 + 5
    assert fused(graphed) == fused(eager)
    # the input's pad (a cast, a fill and a copy) becomes one copy, and a
    # replaying M builds no spectrum bounds
    assert sum(graphed.values()) < sum(eager.values())


@pytest.mark.gpu
def test_pcg_same_iterations_same_x():
    sl, h, st = _card()
    lvl = h["levels"][0]
    radius = st["radii"][0]
    aux = lvl.prepare(radius)
    A = lambda u: lvl.A_aux(u, radius, aux)
    b = _residual(sl, h, 7)
    M = lambda: mg.mg_apply(h, st, nu=(1, 2), fused=True, **OPTS)
    with torch.enable_grad():
        want = pcg(A, b, M=M(), maxiter=200, tol=1e-6)
    with torch.no_grad():
        got = pcg(A, b, M=M(), maxiter=200, tol=1e-6)
    (g,) = _entries(st).values()
    assert g.graph is not None
    assert got.iterations == want.iterations > 2
    assert torch.equal(got.x, want.x)


@pytest.mark.gpu
def test_new_state_captures_anew_and_frees_the_old():
    sl, h, st = _card()
    rs = [_residual(sl, h, seed) for seed in range(3)]
    radius = st["radii"][0]
    del st
    allocated = []
    for k in range(4):
        with torch.no_grad():
            st = mg.mg_precond_state(h, radius * (1.0 + 0.01 * k),
                                     power_iters=5, fused=True)
        _graphed(h, st, rs)
        (g,) = _entries(st).values()
        assert g.graph is not None
        del st, g
        gc.collect()
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated())
    assert allocated[1:] == allocated[:1] * 3
