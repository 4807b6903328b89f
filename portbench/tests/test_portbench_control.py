"""The check's control at a size a test run holds (3^3 on the CPU): the
plain reference in bfloat16 in the program's place is judged not correct
by the harness's ``check.judge``, where the program's step is judged
correct.  On the card the
same function runs at each cell's own size (``portbench/control.py``)."""

import pytest
import torch

from portbench import control
from portbench.harness import check, spec

SEEDS = [2 ** 31 + 11, 2 ** 31 + 12]


@pytest.mark.parametrize("name", ["octet100.descent", "edge50.descent",
                                  "octet100.explore"])
def test_control_fails_a_limit(name):
    cell = spec.resolve(name)
    cell.config["lattice"]["cells"] = 3
    dev = torch.device("cpu")
    system = cell.system().System(cell.config, dev)
    ref = check.reference(cell, dev)
    limits = cell.params["limits"]
    for seed in SEEDS:
        got = control.control_readings(cell, system, ref, seed, dev, 300)
        # the harness's own verdict on each answer
        assert got["program_ok"], got
        assert not got["control_ok"], got
        assert all(got["program"][k] <= limits[k] for k in limits), got
        assert any(got["control"][k] > limits[k] for k in limits), got
