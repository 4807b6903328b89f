"""A run driven on the CPU at 3^3 (the harness's look for a card skipped)
with the timed path broken underneath: ``correct`` comes out false for each
fault a cell can have, and true with nothing broken.  The faults: a step
that returns its state unchanged (the solver hands back its start), and an
answer altered where it is produced (c, g or u).  The cells run one
design at a time on one card, so no batch can lose half its rows and no
exchange between cards can be left out."""

import time

import pytest
import torch

import pylatticedso_tpu_torch.fem.solve as solve_mod
import pylatticedso_tpu_torch.parallel.sharding as sharding_mod
from portbench.harness import core, spec

CELLS = ["octet100.descent", "edge50.descent", "octet100.explore"]
SEED = 2 ** 31 + 4242


def _run(name):
    cell = spec.resolve(name)
    cell.config["lattice"]["cells"] = 3
    return core.run(cell, SEED, 0.5, False, torch.device("cpu"),
                    time.perf_counter(), lambda note: None)


def _stuck_pcg(A, b, M=None, x0=None, maxiter=1000, tol=1e-10, **kw):
    x = torch.zeros_like(b) if x0 is None else x0
    return solve_mod.PCGResult(x, 0, torch.zeros(()), True)


def _altered(which):
    def wrap(solve):
        def solve_altered(self, r, u0, state):
            c, g, u, it, conv = solve(self, r, u0, state)
            if which == "c":
                c = c * (1.0 + 1e-3)
            elif which == "g":
                g = g.clone()
                g[g.abs().argmax()] *= 1.01
            else:
                u = u.clone()
                flat = u.reshape(-1)
                flat[flat.abs().argmax()] *= 1.001
            return c, g, u, it, conv
        return solve_altered
    return wrap


@pytest.mark.parametrize("name", CELLS)
def test_clean_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_state_unchanged_is_caught(name, monkeypatch):
    monkeypatch.setattr(solve_mod, "pcg", _stuck_pcg)
    monkeypatch.setattr(sharding_mod, "pcg", _stuck_pcg)
    out = _run(name)
    assert not out["correct"]
    res = out["checks"]["res"]
    # a zero gradient makes the descent's next design NaN, which reads NaN
    assert not res["value"] <= res["limit"]


@pytest.mark.parametrize("which", ["c", "g", "u"])
@pytest.mark.parametrize("name", ["octet100.descent", "edge50.descent"])
def test_altered_answer_is_caught(name, which, monkeypatch):
    mod = spec.resolve(name).system()
    monkeypatch.setattr(mod.System, "solve", _altered(which)(mod.System.solve))
    cell = spec.resolve(name)
    cell.modules[f"systems/{cell.config['system']}"] = mod
    cell.config["lattice"]["cells"] = 3
    out = core.run(cell, SEED, 0.5, False, torch.device("cpu"),
                   time.perf_counter(), lambda note: None)
    assert not out["correct"], (which, out["checks"])
