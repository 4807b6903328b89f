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
            "smoke_statics.py", "sharding.py", "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# the optimizer slice's modules (the JAX package's path under the port)
SLICE = ["config.py", "materials.py", "gradients.py", "utils/timing.py",
         "native/__init__.py", "design/tags.py", "design/lattice.py",
         "design/__init__.py", "fem/bc.py", "fem/elements.py",
         "fem/operator.py", "opti/parameterization.py", "opti/density.py",
         "opti/optimizer.py", "opti/structured_optimizer.py",
         "opti/__init__.py"]


@pytest.mark.parametrize("rel", SLICE)
def test_scan_covers_the_optimizer_slice(rel):
    path = ROOT / "pylatticedso_tpu_torch" / rel
    assert path in FILES
    assert (ROOT / "pylatticedso_tpu" / rel).exists()


# the statics slice's modules: full-lattice statics, the edge-sharded step,
# the simulation layer and the rest of the design front end
STATICS_SLICE = ["fem/subdivide.py", "fem/statics.py", "fem/homogenization.py",
                 "fem/__init__.py", "parallel/sharding.py", "sim/__init__.py",
                 "sim/penalization.py", "sim/boundary_order.py",
                 "sim/utils_simulation.py", "design/cleanup.py",
                 "design/transforms.py", "design/mesh_trimmer.py"]


@pytest.mark.parametrize("rel", STATICS_SLICE)
def test_scan_covers_the_statics_slice(rel):
    path = ROOT / "pylatticedso_tpu_torch" / rel
    assert path in FILES
    assert (ROOT / "pylatticedso_tpu" / rel).exists()
    assert not [m for m in _imports(path) if m.split(".")[0] in BANNED]


# the domain-decomposition slice's modules: cell condensation, the interface
# solver, the reduced-basis surrogate and the surrogate-DDM optimizer
DDM_SLICE = ["ddm/__init__.py", "ddm/schur.py", "ddm/solver.py",
             "ddm/surrogate.py", "opti/ddm_optimizer.py"]


@pytest.mark.parametrize("rel", DDM_SLICE)
def test_scan_covers_the_ddm_slice(rel):
    path = ROOT / "pylatticedso_tpu_torch" / rel
    assert path in FILES
    assert (ROOT / "pylatticedso_tpu" / rel).exists()
    assert not [m for m in _imports(path) if m.split(".")[0] in BANNED]


def test_scan_covers_the_ddm_smoke():
    assert ROOT / "pylatticedso_tpu_torch/smoke_ddm.py" in FILES


# the last slice's modules: the io package and plotting, and the warped
# phase of the smoke run
IO_SLICE = ["io/__init__.py", "io/checkpoint.py", "io/export.py",
            "io/reference_pickle.py", "io/reference_density.py",
            "io/solid_mesh.py", "plotting.py"]


@pytest.mark.parametrize("rel", IO_SLICE)
def test_scan_covers_the_io_slice(rel):
    path = ROOT / "pylatticedso_tpu_torch" / rel
    assert path in FILES
    assert (ROOT / "pylatticedso_tpu" / rel).exists()
    assert not [m for m in _imports(path) if m.split(".")[0] in BANNED]


def test_scan_covers_the_warped_smoke():
    assert ROOT / "pylatticedso_tpu_torch/smoke_warped.py" in FILES


@pytest.mark.parametrize("rel", ["fem/subdivide.py", "sim/penalization.py",
                                 "sim/boundary_order.py", "design/cleanup.py",
                                 "design/transforms.py",
                                 "design/mesh_trimmer.py", "io/__init__.py",
                                 "io/checkpoint.py", "io/export.py",
                                 "io/reference_pickle.py", "plotting.py"])
def test_framework_free_copies_are_copies(rel):
    """The numpy-only modules are the port's own copies of the JAX
    package's, byte for byte."""
    assert (ROOT / "pylatticedso_tpu_torch" / rel).read_text() == \
        (ROOT / "pylatticedso_tpu" / rel).read_text()


def test_native_builds_its_own_copy():
    """The port compiles its own dedup.cpp into its build directory and
    never loads the JAX package's library."""
    from pylatticedso_tpu_torch import native
    assert native._SRC == ROOT / "pylatticedso_tpu_torch/native/dedup.cpp"
    assert native._SRC.read_text() == \
        (ROOT / "pylatticedso_tpu/native/dedup.cpp").read_text()
    assert native._LIB_PATH.parent == ROOT / "pylatticedso_tpu_torch/_build"


def test_port_imports_without_optional_packages():
    """Every module of the port imports in a process where matplotlib,
    joblib, scikit-learn and triton cannot be imported (the card's machine
    has neither matplotlib nor joblib; no machine here has triton), and
    importing them starts no build."""
    import subprocess
    import sys
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in FILES if p.parent != ROOT and p.name != "__main__.py")
    code = (
        "import sys\n"
        "for m in ('matplotlib', 'joblib', 'sklearn', 'triton'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "from pylatticedso_tpu_torch.kernels import build\n"
        "assert not build._libs\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")
