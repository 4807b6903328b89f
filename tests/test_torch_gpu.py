"""Card-only tests of the port: the B1 kernel against its plain version
and the main path at a small size.  They import no JAX, so they run on a
machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA card every test skips (the card is looked for inside each
test, never at import).
"""

import numpy as np
import pytest
import torch

from pylatticedso_tpu_torch import smoke
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice

GEOMS = {"bcc": "BCC", "octet": "Octet",
         "hybrid": ["BCC", "Hybrid1", "Hybrid4"]}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name,n", [("octet", 50), ("octet", 7),
                                    ("bcc", 5), ("hybrid", 6)])
def test_kernel_matches_plain_on_card(name, n):
    _need_card()
    ts = StructuredLattice(GEOMS[name], (n, n, n), (1.0, 1.0, 1.0), 1013.0,
                           0.3, dtype=torch.float32, device="cuda")
    tm, _ = ts.make_matvec()
    g = torch.Generator(device="cuda").manual_seed(n)
    u = torch.randn((ts.nc, 6) + ts.grid, generator=g, device="cuda")
    r = 0.04 + 0.05 * torch.rand((ts.n_geom, n, n, n), generator=g,
                                 device="cuda")
    aux = tm.prepare(r)
    y_plain = tm.apply_gather(u, aux)
    y = tm.apply(u, aux)
    y2 = tm.apply(u, aux)
    torch.cuda.synchronize()
    assert tm.apply.launches == 2
    assert torch.equal(y, y2)                     # no atomics: bitwise
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err < 1e-5, err
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.apply(u.double(), aux.double())


@pytest.mark.gpu
def test_main_path_small_on_card():
    _need_card()
    rep = smoke.main_path_phase(torch.device("cuda"), 8, steps=3,
                                windows=1)
    assert rep["bitwise"] and rep["finite"]
    assert all(x > 0 for x in rep["launches_per_level"])
    assert rep["compliance_rel_err"] <= 1e-5
    assert np.isfinite(rep["compliance"])
