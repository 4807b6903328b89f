"""The launch helper's signature tables against the CUDA sources: every
``extern "C"`` function of ``csrc/*.cu`` is bound with its own parameter
list (count, and pointer / int / float / double each), and nothing else is
bound.  A pointer bound as an int is cut to 32 bits on the card; a float
bound as an int passes garbage.  Runs on the CPU: it parses the sources."""

import re
from pathlib import Path

import pytest

from pylatticedso_tpu_torch.kernels import build, launch

CSRC = Path(build.CSRC)
_EXTERN = re.compile(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)', re.S)


def _code(param: str) -> str:
    param = " ".join(param.split())
    if "*" in param:
        return "p"
    kind = param.split()[-2] if len(param.split()) > 1 else param
    return {"int": "i", "float": "f", "double": "d"}[kind]


def parse(source: str):
    """{name: (return type, parameter codes)} of one source's launchers."""
    text = (CSRC / f"{source}.cu").read_text()
    out = {}
    for ret, name, params in _EXTERN.findall(text):
        params = params.strip()
        codes = "" if params in ("", "void") else "".join(
            _code(p) for p in params.split(","))
        out[name] = (ret, codes)
    return out


def test_every_source_has_a_table():
    assert set(launch.SIGNATURES) == set(build.SOURCES)
    assert {p.stem for p in CSRC.glob("*.cu")} == set(build.SOURCES)


@pytest.mark.parametrize("source", build.SOURCES)
def test_signature_table_matches_the_source(source):
    found = parse(source)
    assert found, f"no extern \"C\" function in {source}.cu"
    assert set(found) == set(launch.SIGNATURES[source])
    for name, (ret, codes) in found.items():
        assert ret == "int", f"{name} returns {ret}"
        assert codes == launch.SIGNATURES[source][name], \
            f"{source}.cu {name}: source {codes}, table " \
            f"{launch.SIGNATURES[source][name]}"


def test_parser_reads_pointers_ints_floats_and_doubles():
    text = ('extern "C" int f(const void* a, int n, float x,\n'
            '                 double y, void* stream) {')
    ret, name, params = _EXTERN.findall(text)[0]
    assert (ret, name) == ("int", "f")
    assert "".join(_code(p) for p in params.split(",")) == "pifdp"


@pytest.mark.parametrize("source,name,codes", [
    ("stencil_matvec", "stencil_vjp_r2_f32", "ppppppiiiifffp"),
    ("stencil_matvec", "stencil_vjp_r2_f64", "ppppppiiiidddp"),
    ("stencil_matvec", "stencil_vjp_r2_occupancy", "i"),
    ("mg_fused", "mg_residual", "iippppppppiiiiifffp"),
    ("mg_fused", "mg_residual_occupancy", "iii"),
])
def test_planned_launchers_take_the_run(source, name, codes):
    """B3 takes its host plan's run (the int after the table pointers:
    the sides, class_start and the sides' dense records) and the
    r^2-cotangent its beam table (no plan argument: its run is compiled
    in), and each has its own occupancy query (B3's per storage and
    compute type): the source and the table agree on all five."""
    assert parse(source)[name] == ("int", codes)
    assert launch.SIGNATURES[source][name] == codes
