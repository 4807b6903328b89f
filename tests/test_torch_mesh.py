"""The port's device mesh and collectives (``parallel.mesh``) on a virtual
mesh of CPU devices (``["cpu"] * 8``):

* ``all_reduce_sum``: every shard the same bits, those of the partials
  added in rank order in numpy, in float32 and float64;
* ``halo_exchange``: each slab's ghost layers the planes of the gathered
  field around it (zeros at the two ends), along every grid axis;
* ``gather`` of ``scatter`` and of ``slices`` is the field;
* ``Sharded``: arithmetic and elementwise functions slab by slab, a
  reduction on a field in slabs and a plain tensor refused; ``dot``,
  ``norm`` and ``vector_norm`` against the gathered field's, one shard the
  one-device bits; ``pcg`` on a field in slabs;
* ``make_mesh``'s refusals: too few devices, and no devices with no card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pylatticedso_tpu_torch.fem.solve import pcg
from pylatticedso_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
PAD = (1, 1, 1, 1, 1, 1)


def _row(n):
    return M.make_mesh(n_shard=n, devices=CPU8[:n]).devices[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_all_reduce_sum_rank_order(dtype, n):
    rng = np.random.default_rng(n)
    parts_np = [(rng.normal(size=(6, 50)) * 10.0 ** rng.integers(-4, 4))
                .astype(np.float32 if dtype == torch.float32 else np.float64)
                for _ in range(n)]
    want = parts_np[0]
    for p in parts_np[1:]:
        want = want + p                     # rank order, in the dtype
    parts = [torch.from_numpy(p) for p in parts_np]
    out = M.all_reduce_sum(parts, _row(n))
    assert len(out) == n
    for s in out:
        assert s.dtype == dtype
        assert np.array_equal(s.numpy(), want)
    if n > 1:
        assert all(s.data_ptr() != p.data_ptr() for s in out for p in parts)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 4])
def test_halo_exchange_equals_slices_of_gathered(axis, n):
    g = torch.Generator().manual_seed(axis + 10 * n)
    grid = [3, 4, 5]
    grid[axis] = 2 * n
    u = torch.randn((2, 6) + tuple(grid), generator=g, dtype=torch.float64)
    dim = 2 + axis
    slabs = M.scatter(u, _row(n), dim)
    ex = M.halo_exchange(slabs.map(lambda p: F.pad(p, PAD)))
    full = F.pad(u, PAD)
    for k, p in enumerate(ex.parts):
        assert torch.equal(p, full.narrow(dim, 2 * k, 2 + 2))
    assert torch.equal(M.gather(slabs, "cpu"), u)
    sl = M.slices(full, _row(n), dim)
    for a, b in zip(sl.parts, ex.parts):
        assert torch.equal(a, b)


def test_halo_exchange_width_two():
    u = torch.arange(2 * 6 * 8 * 2 * 2, dtype=torch.float64).reshape(
        2, 6, 8, 2, 2)
    full = F.pad(u, (2, 2, 2, 2, 2, 2))
    ex = M.halo_exchange(M.scatter(u, _row(2), 2).map(
        lambda p: F.pad(p, (2, 2, 2, 2, 2, 2))), width=2)
    for k, p in enumerate(ex.parts):
        assert torch.equal(p, full[:, :, 4 * k:4 * k + 8])


def test_scatter_gather_identity_and_refusals():
    u = torch.randn(2, 6, 8, 3, 3, dtype=torch.float64)
    for n in (1, 2, 4, 8):
        x = M.scatter(u, _row(n), 2)
        assert [p.shape[2] for p in x.parts] == [8 // n] * n
        assert torch.equal(x.gather(), u)
    with pytest.raises(ValueError, match="divide"):
        M.scatter(u, _row(3), 2)
    with pytest.raises(ValueError, match="divide"):
        M.slices(F.pad(u, PAD), _row(3), 2)


def test_sharded_arithmetic_and_refusals():
    g = torch.Generator().manual_seed(3)
    a, b = (torch.randn(2, 6, 8, 3, 3, generator=g, dtype=torch.float64)
            for _ in range(2))
    sa, sb = (M.scatter(x, _row(4), 2) for x in (a, b))
    cases = [(sa + sb, a + b), (2.0 - sa, 2.0 - a), (sa * sb / 3.0,
                                                       a * b / 3.0),
             (-sa, -a), (torch.where(sa > 0, sa, 1.0),
                         torch.where(a > 0, a, 1.0)),
             (torch.zeros_like(sa), torch.zeros_like(a)),
             (sa.to(torch.float32), a.to(torch.float32)),
             (F.pad(sa, PAD)[..., 1:-1, 1:-1, 1:-1], a)]
    for got, want in cases:
        assert isinstance(got, M.Sharded) and got.dim == 2
        assert torch.equal(got.gather(), want)
    with pytest.raises(TypeError, match="slabs"):
        torch.sum(sa)
    with pytest.raises(TypeError, match="plain tensor"):
        sa + a
    rep = M.broadcast(torch.tensor(2.5, dtype=torch.float64), _row(4))
    assert rep.dim is None and len(rep.parts) == 4
    assert torch.equal(torch.sum(rep).parts[3], torch.tensor(
        2.5, dtype=torch.float64))        # a replicated value reduces locally
    assert float(rep) == 2.5 and bool(rep > 2.0)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dot_and_norms(n):
    g = torch.Generator().manual_seed(n)
    a, b = (torch.randn(2, 6, 8, 3, 3, generator=g, dtype=torch.float64)
            for _ in range(2))
    sa, sb = (M.scatter(x, _row(n), 2) for x in (a, b))
    d, nr, vn = M.dot(sa, sb), M.norm(sa), M.vector_norm(sa)
    for v in (d, nr, vn):
        assert v.dim is None and len(v.parts) == n
        assert all(torch.equal(p, v.parts[0]) for p in v.parts)
    want_d = torch.dot(a.reshape(-1), b.reshape(-1))
    want_n = torch.linalg.vector_norm(a.reshape(-1))
    assert abs(float(d) - float(want_d)) <= 1e-13 * abs(float(want_d))
    assert abs(float(nr) - float(want_n)) <= 1e-13 * float(want_n)
    assert abs(float(vn) - float(want_n)) <= 1e-13 * float(want_n)
    if n == 1:                           # one shard: the one-device bits
        assert torch.equal(d.parts[0], want_d)
        assert torch.equal(vn.parts[0], want_n)
        assert torch.equal(nr.parts[0], torch.sqrt(torch.dot(
            a.reshape(-1), a.reshape(-1))))


@pytest.mark.parametrize("n", [1, 4])
def test_pcg_on_slabs(n):
    """A diagonally dominant symmetric stencil in slabs: pcg with the
    mesh's reductions against pcg on the whole field (one shard: the same
    bits)."""
    g = torch.Generator().manual_seed(4)
    b = torch.randn(1, 1, 8, 2, 2, generator=g, dtype=torch.float64)
    row = _row(n)

    def A_full(x):
        xp = F.pad(x, PAD)
        return 6.0 * x - (xp[..., :-2, 1:-1, 1:-1] + xp[..., 2:, 1:-1, 1:-1])

    def A_sh(x):
        xp = M.halo_exchange(x.map(lambda p: F.pad(p, PAD)))
        return 6.0 * x - (xp[..., :-2, 1:-1, 1:-1] + xp[..., 2:, 1:-1, 1:-1])

    want = pcg(A_full, b, maxiter=50, tol=1e-14)
    got = pcg(A_sh, M.scatter(b, row, 2), maxiter=50, tol=1e-14, ops=M.OPS)
    assert got.iterations == want.iterations and got.converged
    if n == 1:
        assert torch.equal(got.x.gather(), want.x)
    assert float((got.x.gather() - want.x).abs().max()) <= 1e-13


def test_make_mesh_refusals():
    mesh = M.make_mesh(n_shard=4, n_dp=2, devices=CPU8)
    assert mesh.shape == {"dp": 2, "shard": 4}
    assert mesh.devices[1] == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="devices"):
        M.make_mesh(n_shard=4, n_dp=2, devices=CPU8[:7])
    with pytest.raises(ValueError, match="devices"):
        M.make_mesh(n_dp=9, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            M.make_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            M.make_mesh(devices=["cuda:0"] * 4)


def test_dryrun_multichip_refuses_too_few_devices():
    from pylatticedso_tpu_torch.multichip import dryrun_multichip
    with pytest.raises(RuntimeError, match="devices given"):
        dryrun_multichip(8, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun_multichip(2)
