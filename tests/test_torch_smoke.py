"""Rehearsal of chip_smoke.py on the CPU at n=4: the phases' control flow
only (every wrapper runs its plain version, nothing is timed as a device
number), and the script's refusals without a card or without the port."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pylatticedso_tpu_torch import smoke

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def test_phases_rehearse_on_cpu():
    lines = []
    rep = smoke.run(device="cpu", n=4, steps=2, windows=1,
                    log=lines.append)
    assert rep["device"]["platform"] == "cpu"
    assert [c["case"].split()[0] for c in rep["cases"]] == \
        ["Octet", "Octet", "BCC+Hybrid1+Hybrid4"]
    assert all(c["max_rel_err"] == 0.0 for c in rep["cases"])
    main = rep["main"]
    assert main["levels"] == [[4, 4, 4], [2, 2, 2]]
    assert main["bitwise"] and main["finite"]
    assert main["compliance_rel_err"] <= 1e-5
    assert main["launches_per_level"] == [0, 0]     # no kernel on the CPU
    (k,) = rep["kernels"]
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in k
    assert (ROOT / k["source"]).exists()
    json.dumps(rep["kernels"])
    assert any(line.startswith("main path 4^3 Octet") for line in lines)


def test_level_cells_follow_the_hierarchy():
    assert smoke.level_cells(50) == [50, 25, 13, 7, 4, 2]


def test_budget_fails_loudly():
    b = smoke.Budget(0.0)
    with pytest.raises(RuntimeError, match="wall budget"):
        b.check("build")


def _run(script_dir):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=script_dir,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(ROOT)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_chip_smoke_refuses_without_the_port(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = _run(tmp_path)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
