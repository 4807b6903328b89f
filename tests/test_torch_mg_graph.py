"""The unfused V-cycle's levels below the fine one as one CUDA graph per MG
state (``parallel/multigrid.py``).

On the CPU: the graph never engages (no capture span under a profiler, no
graph made), a state holding a ``parallel.mesh.Sharded`` anywhere keeps the
cycle eager, the cache separates the V-cycle's options, and an entry is
made anew for a state whose tensors differ.  On the card (``-m gpu``, no
JAX imported, each test skips without a card): the graphed M gives the
eager M's bits over successive applications, a new state captures anew and
the old graph's memory comes back, B1's per-level launch counts equal the
eager run's, a profiled graphed M holds the eager M's kernel events, and
PCG with it takes the same iterations to the same x.

    python -m pytest --noconftest -m gpu tests/test_torch_mg_graph.py
"""

import collections
import gc
import weakref

import numpy as np
import pytest
import torch

from pylatticedso_tpu_torch.fem.solve import pcg
from pylatticedso_tpu_torch.parallel import multigrid as mg
from pylatticedso_tpu_torch.parallel.mesh import scatter
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice
from pylatticedso_tpu_torch.utils.timing import timing

OPTS = {"nu": (1, 2), "coarse_degree": 24, "smooth_frac": 0.35}


def _problem(n, dtype, device):
    """An Octet lattice clamped on z = 0, its hierarchy, a radius field and
    the MG operator's fine-level residual shape."""
    sl = StructuredLattice("Octet", (n,) * 3, (1.0,) * 3, 1013.0, 0.3,
                           dtype=dtype, device=device)
    fixed = sl.select_nodes(lambda x, y, z: z == 0.0)
    free = np.broadcast_to((sl.node_valid & ~fixed)[:, None],
                           (sl.nc, 6) + sl.grid)
    h = mg.build_mg_hierarchy(sl, free)
    rng = np.random.default_rng(n)
    radius = torch.as_tensor(0.04 + 0.02 * rng.random((n,) * 3), dtype=dtype,
                             device=device)
    return sl, h, radius


def _state(h, radius):
    with torch.no_grad():
        return mg.mg_precond_state(h, radius, power_iters=5)


def _residuals(sl, h, k, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    free = h["levels"][0].free
    return [free * torch.as_tensor(rng.standard_normal((sl.nc, 6) + sl.grid),
                                   dtype=dtype, device=device)
            for _ in range(k)]


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


# ------------------------------------------------------------------ CPU
def test_cpu_never_captures():
    sl, h, radius = _problem(8, torch.float32, "cpu")
    assert len(h["levels"]) == 3
    st = _state(h, radius)
    M = mg.mg_apply(h, st, **OPTS)
    before = {n: timing.count(n) for n in
              ("mg.graph.capture", "mg.graph.replay", "mg.level.1")}
    with torch.no_grad():
        outs = _profiled(lambda: [M(r) for r in _residuals(
            sl, h, 3, torch.float32, "cpu")])
    assert timing.count("mg.graph.capture") == before["mg.graph.capture"]
    assert timing.count("mg.graph.replay") == before["mg.graph.replay"]
    assert timing.count("mg.level.1") == before["mg.level.1"] + 3
    # a slot for the options, and nothing in it: no graph was made
    assert [dict(v) for v in st["graphs"].values()] == [{}]
    assert all(bool(torch.isfinite(o).all()) for o in outs)


@pytest.mark.parametrize("key", mg._OPERANDS[:4])
@pytest.mark.parametrize("level", [0, 2])
def test_sharded_state_stays_eager(key, level):
    """A ``Sharded`` value on any level of any of the state's lists keeps
    the whole cycle below the fine level eager (the slab-sharded step's
    gathered coarse levels included), and the state gets no graphs."""
    _, h, radius = _problem(8, torch.float32, "cpu")
    st = _state(h, radius)
    options = (tuple(OPTS["nu"]), 24, 0.35, False)
    assert mg._coarse_slot(dict(st), options) == {}
    held = dict(st, **{key: list(st[key])})
    v = held[key][level]
    v = v.reshape(1) if v.ndim == 0 else v
    held[key][level] = scatter(v, ["cpu"], 0)
    assert mg._coarse_slot(held, options) is None
    assert "graphs" not in held


def test_one_level_stays_eager():
    _, h, radius = _problem(3, torch.float32, "cpu")
    assert len(h["levels"]) == 1
    assert mg._coarse_slot(_state(h, radius), (1, 24, 0.25, False)) is None


@pytest.mark.parametrize("option,other", [
    ("nu", 2), ("coarse_degree", 12), ("smooth_frac", 0.25),
    ("lo_smoother", True)])
def test_cache_key_separates_options(option, other):
    """Each of the V-cycle's options has a slot of its own in the state's
    graphs; the same options share one."""
    sl, h, radius = _problem(8, torch.float32, "cpu")
    st = _state(h, radius)
    base = dict(OPTS, lo_smoother=False)
    r = _residuals(sl, h, 1, torch.float32, "cpu")[0]
    with torch.no_grad():
        a = mg.mg_apply(h, st, **base)(r)
        mg.mg_apply(h, st, **base)(r)
        b = mg.mg_apply(h, st, **dict(base, **{option: other}))(r)
    assert len(st["graphs"]) == 2
    key = lambda o: (tuple(o["nu"]) if isinstance(o["nu"], tuple)
                     else (o["nu"],), o["coarse_degree"],
                     float(o["smooth_frac"]), o["lo_smoother"])
    assert set(st["graphs"]) == {key(base),
                                 key(dict(base, **{option: other}))}
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())


def test_dropped_m_frees_its_state_at_once():
    """M holds no reference cycle: with the garbage collector off, the
    state's tensors go when the state and its last M do (a state a design
    does not pile up until the next collection)."""
    sl, h, radius = _problem(8, torch.float32, "cpu")
    st = _state(h, radius)
    alive = [weakref.ref(st[k][lvl]) for k in ("Ds", "auxs")
             for lvl in range(len(h["levels"]))]
    M = mg.mg_apply(h, st, **OPTS)
    with torch.no_grad():
        M(_residuals(sl, h, 1, torch.float32, "cpu")[0])
    gc.disable()
    try:
        del st, M
        assert all(w() is None for w in alive)
    finally:
        gc.enable()


def test_entry_made_anew_for_other_tensors():
    """An entry records the tensors it reads; a state with other tensors at
    the same options (a copy with one replaced) does not reuse it."""
    ops = tuple(torch.zeros(2) for _ in range(3))
    g = mg._CoarseGraph(ops)
    assert g.reads(ops) and g.reads(tuple(ops))
    other = ops[:2] + (torch.zeros(2),)
    assert not g.reads(other)
    assert g.reads(ops)


# ----------------------------------------------------------------- card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


N = 16                                # 4 levels: 16, 8, 4, 2 cells a side


def _card(dtype):
    _need_card()
    sl, h, radius = _problem(N, dtype, "cuda")
    assert len(h["levels"]) == 4
    return sl, h, radius


def _eager(h, st, rs, **opts):
    """M's outputs with autograd on: the graph never engages."""
    M = mg.mg_apply(h, st, **dict(OPTS, **opts))
    with torch.enable_grad():
        return [M(r) for r in rs]


def _graphed(h, st, rs, **opts):
    M = mg.mg_apply(h, st, **dict(OPTS, **opts))
    with torch.no_grad():
        return [M(r) for r in rs]


def _graph_of(st):
    (slot,) = st["graphs"].values()
    (g,) = slot.values()
    return g


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,lo", [(torch.float32, False),
                                      (torch.float32, True),
                                      (torch.float64, False)])
def test_graphed_equals_eager_bitwise(dtype, lo):
    sl, h, radius = _card(dtype)
    st = _state(h, radius)
    rs = _residuals(sl, h, 3, dtype, "cuda")
    want = _eager(h, st, rs, lo_smoother=lo)
    assert st["graphs"] == {} or all(
        not slot for slot in st["graphs"].values())
    got = _graphed(h, st, rs, lo_smoother=lo)
    assert _graph_of(st).graph is not None
    for w, g_ in zip(want, got):
        assert torch.equal(w, g_)
    # a new M on the same state replays the same graph
    g0 = _graph_of(st).graph
    again = _graphed(h, st, rs[::-1], lo_smoother=lo)
    assert _graph_of(st).graph is g0
    for w, g_ in zip(want[::-1], again):
        assert torch.equal(w, g_)


@pytest.mark.gpu
def test_new_state_captures_anew_and_frees_the_old():
    sl, h, radius = _card(torch.float32)
    rs = _residuals(sl, h, 3, torch.float32, "cuda")
    allocated, reserved = [], []
    for k in range(4):
        st = _state(h, radius * (1.0 + 0.01 * k))
        _graphed(h, st, rs)
        assert _graph_of(st).graph is not None
        del st
        gc.collect()
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated())
        reserved.append(torch.cuda.memory_reserved())
    # each state's graph and static buffers go with it
    assert allocated[1:] == allocated[:1] * 3
    # the graphs share one pool: no memory is held back per design
    assert reserved[2:] == reserved[1:2] * 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,lo", [(torch.float32, False),
                                      (torch.float32, True),
                                      (torch.float64, False)])
def test_launch_counts_equal_eager(dtype, lo):
    sl, h, radius = _card(dtype)
    rs = _residuals(sl, h, 4, dtype, "cuda")
    ws = [lvl.matvec.apply for lvl in h["levels"]]

    def counts(run):
        for w in ws:
            for c in w.COUNTERS:
                setattr(w, c, 0)
        run(h, _state(h, radius), rs, lo_smoother=lo)
        return [[getattr(w, c) for c in w.COUNTERS] for w in ws]

    eager = counts(_eager)
    assert counts(_graphed) == eager
    assert all(sum(row) > 0 for row in eager)


@pytest.mark.gpu
def test_profiled_graph_holds_the_eager_kernels():
    from torch.profiler import ProfilerActivity, profile
    sl, h, radius = _card(torch.float32)
    st = _state(h, radius)
    rs = _residuals(sl, h, 3, torch.float32, "cuda")
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
    assert sum(eager.values()) > 100
    assert graphed == eager


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pcg_same_iterations_same_x(dtype):
    sl, h, radius = _card(dtype)
    lvl = h["levels"][0]
    aux = lvl.prepare(radius)
    A = lambda u: lvl.A_aux(u, radius, aux)
    b = _residuals(sl, h, 1, dtype, "cuda", seed=7)[0]
    st = _state(h, radius)
    M = mg.mg_apply(h, st, **OPTS)
    with torch.enable_grad():
        want = pcg(A, b, M=M, maxiter=200, tol=1e-6)
    with torch.no_grad():
        got = pcg(A, b, M=mg.mg_apply(h, st, **OPTS), maxiter=200,
                  tol=1e-6)
    assert _graph_of(st).graph is not None
    assert got.iterations == want.iterations > 2
    assert torch.equal(got.x, want.x)
