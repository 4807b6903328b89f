"""Port parity: the port's catalog copy gives the JAX package's arrays."""

import importlib.util
import json

import numpy as np
import pytest

from pylatticedso_tpu import catalog as jcat
from pylatticedso_tpu_torch import catalog as tcat


def _fresh_jax_catalog():
    """The JAX package's catalog module as its file defines it: another
    test in the same process may register a geometry in the imported one
    (``tests/test_catalog.py`` does)."""
    spec = importlib.util.spec_from_file_location("_fresh_jax_catalog",
                                                  jcat.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_same_geometry_names():
    assert tcat.available_geometries() == \
        _fresh_jax_catalog().available_geometries()


@pytest.mark.parametrize("name", jcat.available_geometries())
def test_beam_structure_equal(name):
    a = jcat.get_beam_structure(name)
    b = tcat.get_beam_structure(name)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_json_geometry_and_unknown_name(tmp_path):
    geo = {"parameters": {"h": "0.25"},
           "beams": [[0, 0, 0, 1, 1, 1], [0, 0, "h", 1, 0, "2*h"]]}
    path = tmp_path / "g.json"
    path.write_text(json.dumps(geo))
    np.testing.assert_array_equal(tcat.get_beam_structure(str(path)),
                                  jcat.get_beam_structure(str(path)))
    with pytest.raises(FileNotFoundError):
        tcat.get_beam_structure("NoSuchGeometry")
