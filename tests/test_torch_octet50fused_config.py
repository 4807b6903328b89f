"""The benchmark's ``octet50fused`` configuration (``portbench/configs/
octet50fused.json``: bench.py's default route, the fused V-cycle with bf16
smoother storage) on the CPU, where kernels B3-B5 run their plain
versions: its options, a few steps of the ``descent`` stream at 13^3 (the
fine level on B3 + B4, the coarser ones on B5) judged against the plain
reference by the harness's own ``check.judge``, the set-up's refusals, and
the launch counters of B4, whose final emits count apart from its middle
steps."""

import json
from pathlib import Path

import pytest
import torch

from pylatticedso_tpu_torch.kernels import fused as tfused
from pylatticedso_tpu_torch.utils.timing import timing

ROOT = Path(__file__).resolve().parents[1]
CELL = "octet50fused.descent"
SEED = 2 ** 31 + 1237
N = 13


def _cell(n=N):
    from portbench.harness import spec
    cell = spec.resolve(CELL, ROOT)
    cell.config["lattice"]["cells"] = n
    return cell


def test_options_are_bench_defaults():
    cfg = json.loads((ROOT / "portbench/configs/octet50fused.json")
                     .read_text())
    base = json.loads((ROOT / "portbench/configs/octet100.json").read_text())
    sol = cfg["solver"]
    assert sol["mg"] == dict(base["solver"]["mg"], fused=True)
    assert sol["mg"]["nu"] == [1, 2] and sol["mg"]["coarse_degree"] == 24
    assert sol["mg"]["smooth_frac"] == 0.35
    assert sol["mg"]["power_iters"] == 5 and not sol["mg"]["lo_smoother"]
    assert sol["fused_storage"] == "bfloat16"
    assert (sol["tol"], sol["maxiter"]) == (1e-6, 6000)
    assert cfg["lattice"] == dict(base["lattice"], cells=50)
    assert cfg["material"] == base["material"] and cfg["reduced"] == []


def test_descent_against_the_reference():
    """Every step of the stream's warm-up and the two after it converges
    and is correct by the cell's own limits; every level routes fused."""
    from portbench.harness import check, core
    from portbench.harness.traffic import Stream
    cell = _cell()
    dev = torch.device("cpu")
    system = cell.system().System(cell.config, dev)
    assert [fz.single_ok for fz in system._fused] == \
        [False, True, True, True]
    stream = Stream(cell.traffic, system.points(), N, SEED)
    loop = core._Loop(system, stream, dev)
    samples = []
    for _ in range(cell.traffic["warmup_steps"] + 2):
        rec = loop.step()
        assert rec["converged"], rec["iterations"]
        samples.append(core._copy(rec))
    assert all(op["fdinv"].dtype == torch.bfloat16
               for op in loop.state["fused"])
    ref = check.reference(cell, dev)
    verdict = check.judge(ref, system.view(), samples,
                          cell.params["limits"])
    assert verdict["ok"], verdict["checks"]


def test_set_up_refuses_another_route(monkeypatch):
    cell = _cell(4)
    sysmod = cell.system()
    dev = torch.device("cpu")
    monkeypatch.setenv("PLDSO_MG_FUSED_DTYPE", "f32")
    with pytest.raises(RuntimeError, match="storage"):
        sysmod.System(cell.config, dev)
    monkeypatch.delenv("PLDSO_MG_FUSED_DTYPE")
    # bf16 compute (the configuration states float32) is refused too
    monkeypatch.setenv("PLDSO_MG_FUSED_COMPUTE", "bf16")
    with pytest.raises(RuntimeError, match="bf16"):
        sysmod.System(cell.config, dev)
    monkeypatch.delenv("PLDSO_MG_FUSED_COMPUTE")
    unfused = json.loads(json.dumps(cell.config))
    unfused["solver"]["mg"]["fused"] = False
    with pytest.raises(ValueError, match="fused"):
        sysmod.System(unfused, dev)
    # a state without the fused operands is refused, not run unfused
    system = sysmod.System(cell.config, dev)
    from pylatticedso_tpu_torch.parallel.multigrid import mg_precond_state
    h = system.step.hierarchy
    monkeypatch.setattr(system.step, "precond_state",
                        lambda r: mg_precond_state(h, r, power_iters=1,
                                                   fused=False))
    with pytest.raises(RuntimeError, match="fused operands"):
        system.prepare(torch.full((4 ** 3,), 0.05))


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_b4_final_emits_count_apart(compute, monkeypatch):
    """B4's launch path with the launch itself stubbed (CPU tensors):
    every launch counts under ``cheb_run`` (``_bf16c`` under bf16 compute),
    as before, and a final emit besides under the same key of
    ``final_launches``; the middle steps are the difference.  Each launch
    is one ``mg.fused.b4`` span under the profiler, none without."""
    from pylatticedso_tpu_torch.parallel.structured import StructuredLattice
    sl = StructuredLattice("Octet", (4,) * 3, (1.0,) * 3, 1013.0, 0.3,
                           dtype=torch.float32, device="cpu")
    fz = sl.make_matvec()[0].apply.fused
    monkeypatch.setattr(tfused.launch, "functions",
                        lambda source: {"mg_cheb_run": lambda *a: 0})
    monkeypatch.setattr(tfused.launch, "stream", lambda index: None)
    monkeypatch.setattr(fz, "_static_slab", lambda *a: ())
    bf = torch.bfloat16
    vec = lambda: torch.zeros(fz._shapes[0], dtype=bf)
    r2 = torch.zeros(fz._shapes[1], dtype=bf)
    sc = torch.ones(2)
    finals = [False, True, False, False, True]
    launch = lambda final: fz._b4(vec(), vec(), vec(), vec(), sc, r2, 0.5,
                                  1.5, final, compute)
    before = timing.count("mg.fused.b4")
    for final in finals:
        out = launch(final)
        assert isinstance(out, torch.Tensor) == final
    assert timing.count("mg.fused.b4") == before
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        launch(True)
    assert timing.count("mg.fused.b4") == before + 1
    key = fz.counter("cheb_run", compute)
    assert fz.launches[key] == len(finals) + 1
    assert fz.final_launches[key] == 3
    assert fz.launches[key] - fz.final_launches[key] == 3
    assert sum(fz.launches.values()) == len(finals) + 1
    assert sum(fz.final_launches.values()) == 3
    assert set(fz.launches) == set(tfused.KERNELS)
