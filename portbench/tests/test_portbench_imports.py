"""No module that a run loads is JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's and has to
pass), and the reference imports nothing of the port."""

import ast
import json
import subprocess
import sys

import pytest

from portbench.harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "pylatticedso_tpu"}

# everything run.py loads for a cell, short of touching a card
LOAD = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import run
from portbench.harness import core, spec, kcache, trace, roofline, check
cell = spec.resolve({cell!r})
cell.system(); cell.reference()
for m in cell.per_layer:
    cell.reader(m['name'])
import portbench.control
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _tops(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", CELLS)
def test_run_loads_no_jax(cell):
    tops = _tops(LOAD.format(root=str(spec.ROOT), cell=cell))
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert "pylatticedso_tpu_torch" in tops


def test_forbidden_names_compared_whole():
    import pylatticedso_tpu_torch  # noqa: F401
    from portbench.harness import core
    assert set(core.FORBIDDEN) == FORBIDDEN
    assert "pylatticedso_tpu_torch" in sys.modules
    assert "pylatticedso_tpu_torch" not in core.forbidden_modules()


def test_reference_imports_nothing_of_the_port():
    ref_dir = spec.BENCH_DIR / "reference"
    for path in ref_dir.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top in {"math", "typing", "torch", "numpy",
                               "__future__"}, (path.name, n)
    code = (f"import sys, json; sys.path.insert(0, {str(spec.ROOT)!r}); "
            "import portbench.reference.octet_beams; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = _tops(code)
    assert not tops & (FORBIDDEN | {"pylatticedso_tpu_torch"})
