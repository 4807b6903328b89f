"""P1 and P2, the counterparts of the JAX package's two TPU probe kernels
(``scripts/probe_1d_density.py`` and the inline kernel of
``scripts/tpu_harvest_r{5,6,7,8}.sh``): their plain versions against a
numpy float32 loop that rounds each multiply and add on its own, bitwise.

The scripts themselves cannot be imported by a test: they run at import
time and only on a TPU, so the numpy loop restates their arithmetic.  The
kernels are held against these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""

import inspect
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pylatticedso_tpu_torch import probes

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _numpy_chain(x, kind):
    v = x[0].copy() if kind == "1d" else x.copy()
    a, b = np.float32(1.0001), np.float32(0.5)
    for _ in range(probes.K):
        v = (v * a).astype(np.float32)
        v = (v + b).astype(np.float32)
    return np.broadcast_to(v, x.shape)


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_chain_plain_is_the_scripts_arithmetic(kind):
    x = probes.inputs("cpu")["chain"]
    assert tuple(x.shape) == (probes.ROWS, probes.T) == (8, 3072)
    want = _numpy_chain(x.numpy(), kind)
    got = probes.chain(x, kind)             # a CPU tensor: the plain version
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert probes.launches["chain"] == 0
    # the script's own count of operations
    assert probes.flops(kind) == 200 * 3072 * 2 * 100 * (1 if kind == "1d"
                                                         else 8)


def test_scale_plain_and_refusals():
    x = probes.inputs("cpu")["scale"]
    np.testing.assert_array_equal(probes.scale(x).numpy(),
                                  np.full((8, 128), 2.0, np.float32))
    with pytest.raises(ValueError, match="float32"):
        probes.scale(x.double())
    with pytest.raises(ValueError, match="kind"):
        probes.chain(probes.inputs("cpu")["chain"], "3d")
    assert probes.launches["scale"] == 0


def test_entry_runs_the_plain_versions_on_request():
    p = subprocess.run([sys.executable, "-m", "pylatticedso_tpu_torch.probes",
                        "--device", "cpu"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.splitlines()
    assert lines[0].startswith("1d: ") and "GFLOP/s" in lines[0]
    assert lines[1].startswith("2d: ")
    assert lines[2].startswith("probe x * 2.0: ok")


def test_chain_length_is_checked_once_when_the_library_binds(monkeypatch):
    """P1's wrapper holds probes.cu's compiled-in chain length to K once,
    when the process first binds the library, and not on every launch; a
    library built with another length is refused."""
    calls = []
    fake = {"probe_chain_length": lambda: calls.append(1) or probes.K}
    monkeypatch.setattr(probes.launch, "functions", lambda source: fake)
    probes._functions.cache_clear()
    try:
        assert probes._functions() is fake
        assert probes._functions() is fake
        assert calls == [1]
        assert "probe_chain_length" not in inspect.getsource(probes.chain)
        probes._functions.cache_clear()
        fake["probe_chain_length"] = lambda: probes.K + 1
        with pytest.raises(RuntimeError, match="chain length"):
            probes._functions()
        assert probes._functions.cache_info().currsize == 0
    finally:
        probes._functions.cache_clear()


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_chain_takes_a_repeat_count(kind):
    """P1 in one launch of 20 x REPS repeats (the measurement that
    separates the kernel's own time from the gap between launches): the
    same values as at REPS, and 20 times the operations."""
    x = probes.inputs("cpu")["chain"]
    np.testing.assert_array_equal(
        probes.chain(x, kind, reps=20 * probes.REPS).numpy(),
        probes.plain_chain(x, kind).numpy())
    assert probes.flops(kind, 20 * probes.REPS) == 20 * probes.flops(kind)
    assert probes.launches["chain"] == 0


def test_chain_length_is_the_kernel_source_constant():
    text = (ROOT / probes.SOURCE).read_text()
    assert int(re.search(r"#define P1_K (\d+)", text).group(1)) == probes.K
