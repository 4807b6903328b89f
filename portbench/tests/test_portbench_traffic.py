"""The traffic generator: the same seed gives the same designs, another
seed others; the projection holds the budget and the bounds; the descent
follows the users' projected-gradient driver, and its runs restart cold."""

import json

import pytest
import torch

from portbench.harness import spec
from portbench.harness.traffic import Stream

MIXES = {n: json.loads((spec.BENCH_DIR / "traffic" / f"{n}.json").read_text())
         for n in ("descent", "explore")}
SEED = 2 ** 31 + 977


def _points(n=6):
    c = torch.arange(n, dtype=torch.float64)
    g = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1)
    return g.reshape(-1, 3) + 0.5


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_same_seed_same_designs(mix):
    a = Stream(MIXES[mix], _points(), 6, SEED)
    b = Stream(MIXES[mix], _points(), 6, SEED)
    for k in range(3):
        assert torch.equal(a.design(k), b.design(k))
    others = [Stream(MIXES[mix], _points(), 6, SEED + d).design(0)
              for d in range(1, 6)]
    assert any(not torch.equal(a.design(0), o) for o in others)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_every_seed_sends_the_same_designs(mix):
    """The same designs up to a symmetry that keeps the loads, in another
    order: the same values at the same points' images."""
    pool = MIXES[mix]["pool"]

    def values(seed):
        s = Stream(MIXES[mix], _points(), 6, seed)
        return sorted(tuple(torch.sort(s.design(k).double()).values.tolist())
                      for k in range(pool))
    a, b = values(SEED), values(SEED + 3)
    for x, y in zip(a, b):
        assert max(abs(u - v) for u, v in zip(x, y)) < 1e-7


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_projection_holds_budget_and_bounds(mix):
    p = MIXES[mix]
    s = Stream(p, _points(), 6, SEED)
    for k in range(4):
        r = s.design(k).double()
        assert float(r.min()) >= p["r_min"] and float(r.max()) <= p["r_max"]
        assert abs(float((r * r).mean()) - p["mean_r2"]) < 1e-6 * p["mean_r2"]
    wide = torch.linspace(-1.0, 1.0, 500, dtype=torch.float64)
    r = s.project(wide).double()
    assert float(r.min()) == pytest.approx(p["r_min"])
    assert float(r.max()) == pytest.approx(p["r_max"])
    assert abs(float((r * r).mean()) - p["mean_r2"]) < 1e-6 * p["mean_r2"]


def _descent(**over):
    return Stream(dict(MIXES["descent"], **over), _points(), 6, SEED)


def _grad(r, seed=1):
    return -0.5 - torch.rand(r.shape,
                             generator=torch.Generator().manual_seed(seed))


def _expected(s, x, g, step):
    """The projected-gradient trial: radii normalised over the bounds,
    moved by ``step`` along -g in them, projected."""
    span = s.p["r_max"] - s.p["r_min"]
    theta = (x.double() - s.p["r_min"]) / span
    return s.project(s.p["r_min"] + span * (theta - step * span * g.double()))


def test_descent_follows_the_projected_driver():
    """optimize_projected's rule: step0 / ||g|| first, x grow when a trial
    is accepted, x shrink and retried from the accepted design when the
    compliance rose."""
    s = _descent()
    p = s.p
    span = p["r_max"] - p["r_min"]
    r0 = s.first()
    assert s.starts_run and s.refresh_due()
    g0 = _grad(r0)
    step = p["step0"] / float(torch.linalg.vector_norm(span * g0.double()))
    r1 = s.next(r0, 10.0, g0)
    assert not s.starts_run
    assert torch.allclose(r1.double(), _expected(s, r0, g0, step).double(),
                          atol=1e-7)
    assert abs(float((r1.double() ** 2).mean()) - p["mean_r2"]) \
        < 1e-6 * p["mean_r2"]
    assert not torch.equal(r1, r0)
    # accepted: the step grows, from the trial's design and gradient
    g1 = _grad(r1, 2)
    r2 = s.next(r1, 9.0, g1)
    step *= p["grow"]
    assert torch.allclose(r2.double(), _expected(s, r1, g1, step).double(),
                          atol=1e-7)
    # rejected (compliance rose): half the step, again from r1 along g1
    r3 = s.next(r2, 9.5, _grad(r2, 3))
    step *= p["shrink"]
    assert torch.allclose(r3.double(), _expected(s, r1, g1, step).double(),
                          atol=1e-7)


def test_descent_runs_restart_cold():
    s = _descent(run_length=3)
    r = s.first()
    seen = []
    for k in range(6):
        seen.append(s.starts_run)
        r = s.next(r, 10.0 - k, _grad(r, k))
    assert seen == [True, False, False, True, False, False]
    assert s.starts_run and torch.equal(r, s.design(2))
    # a run whose compliance stops moving ends early
    s = _descent()
    r = s.next(s.first(), 10.0, _grad(s.first()))
    r = s.next(r, 10.0, _grad(r))
    assert s.starts_run and torch.equal(r, s.design(1))


def test_descent_refresh_counts_from_the_run():
    s = _descent(run_length=12)
    r = s.first()
    due = []
    for k in range(14):
        due.append(s.refresh_due())
        r = s.next(r, 10.0 - k, _grad(r, k))
    assert [k for k, d in enumerate(due) if d] == [0, 8, 12]


def test_explore_draws_new_designs():
    s = Stream(MIXES["explore"], _points(), 6, SEED)
    r0 = s.first()
    assert torch.equal(r0, s.design(0))
    for k in range(1, 4):
        r = s.next(r0, 1.0, torch.ones_like(r0))
        assert torch.equal(r, s.design(k)) and s.starts_run
        assert s.refresh_due()
    assert not s.warm
