"""The measuring path refuses to run without a card, and without the
program beside it: it exits with another code than 0 and prints no
result."""

import os
import shutil
import subprocess
import sys

from portbench.harness import spec


def _run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "edge50.descent",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_refuses_without_a_card():
    out = _run(spec.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / spec.BENCH_DIR.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_kernel_cache_refuses_a_changed_loader(tmp_path, monkeypatch):
    """The cache hands libraries over through the program's private table;
    where the program no longer has it the run fails instead of building
    anew unseen."""
    import pytest

    from portbench.harness import kcache
    from pylatticedso_tpu_torch.kernels import build
    monkeypatch.delattr(build, "_libs")
    with pytest.raises(RuntimeError, match="_libs"):
        kcache.prime(tmp_path, ["stencil_matvec"])
