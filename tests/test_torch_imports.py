"""The port and chip_smoke.py import neither JAX nor the JAX package.

Scanned with ``ast``: this environment may preload jax into every
interpreter, so ``sys.modules`` cannot tell.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "pylatticedso_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "pylatticedso_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_scan_covers_the_port():
    names = {p.name for p in FILES}
    assert {"structured.py", "multigrid.py", "stencil.py", "fused.py",
            "convert.py", "solve.py", "smoke.py", "probes.py",
            "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
