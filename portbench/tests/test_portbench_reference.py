"""The plain reference's K.u and compliance gradient against the port's
plain CPU forms on a 3^3 Octet: the structured class-grid operator with a
per-cell radius, and the edge-sharded path's lattice and operator with a
per-strut radius.  (A test may import both; the reference itself imports
nothing of the port.)"""

import numpy as np
import pytest
import torch

from portbench.reference.octet_beams import (OctetLattice, node_classes,
                                             strut_types)

N, E, NU, KAPPA = 3, 1013.0, 0.3, 0.9


@pytest.fixture(scope="module")
def ref():
    return OctetLattice(N, E, NU, KAPPA, 1.0)


def test_counts(ref):
    # corners and face centers; 24 struts a cell plus the outer faces'
    assert ref.n_nodes == (N + 1) ** 3 + 3 * (N + 1) * N * N
    assert ref.n_beams == 12 * N ** 3 + 3 * (N + 1) * N * N * 4
    assert len(node_classes()) == 4 and strut_types() == 24
    assert float(ref.f.sum()) == pytest.approx(-1.0)
    assert int(ref.fixed.sum()) == (N + 1) ** 2 + N * N


def test_structured_operator_and_gradient(ref):
    from pylatticedso_tpu_torch.parallel.structured import StructuredLattice

    sl = StructuredLattice("Octet", (N,) * 3, (1.0,) * 3, E, NU, kappa=KAPPA,
                           dtype=torch.float64, device="cpu")
    mv, _ = sl.make_matvec()
    off = torch.as_tensor(np.rint(np.asarray(sl.class_keys) * 2)).long()
    assert torch.equal(off, node_classes())
    X = N + 1
    g = torch.stack(torch.meshgrid(*(torch.arange(X),) * 3, indexing="ij"),
                    -1)
    idx = torch.stack([ref.node_index(2 * g + off[c]) for c in range(4)])
    ok = idx >= 0
    gen = torch.Generator().manual_seed(0)
    u = torch.randn(ref.n_nodes, 6, dtype=torch.float64, generator=gen)
    up = torch.zeros(4, 6, X, X, X, dtype=torch.float64)
    for c in range(4):
        up[c][:, ok[c]] = u[idx[c][ok[c]]].T
    r = 0.02 + 0.06 * torch.rand(N, N, N, dtype=torch.float64, generator=gen)
    Ku = mv.apply_gather(up, mv.prepare(r))
    want = ref.apply(u, ref.beam_radius(r))
    got = torch.zeros_like(want)
    for c in range(4):
        got[idx[c][ok[c]]] = Ku[c][:, ok[c]].T
    assert float((got - want).abs().max() / want.abs().max()) < 1e-13
    # the analytic gradient's form: d/dr of sum(dE/dr^2 * r^2) is -dc/dr
    dq = mv.energy_dr2(up, mv.sections(r))
    rf = r.clone().requires_grad_(True)
    tot = sum(torch.sum(d * r2) for d, r2 in zip(dq, mv.sections(rf)))
    (gp,) = torch.autograd.grad(tot, rf)
    gr = ref.per_cell(ref.dc_dr(u, ref.beam_radius(r)))
    assert float((-gp - gr).abs().max() / gr.abs().max()) < 1e-13


def test_edge_lattice_operator_and_gradient(ref):
    from pylatticedso_tpu_torch.design import build_lattice
    from pylatticedso_tpu_torch.fem.bc import apply_boundary_conditions
    from pylatticedso_tpu_torch.parallel.sharding import (ShardedLattice,
                                                          make_mesh)
    from portbench.systems.edge import View, lattice_config

    cfg = {"geometry": "Octet", "cells": N, "load": 1.0}
    lat = build_lattice(lattice_config(cfg))
    bc = apply_boundary_conditions(lat)
    view = View(np.asarray(lat.nodes), np.asarray(lat.edges))
    node, beam = view._perm(ref)
    # the same loads and clamps
    f = torch.as_tensor(bc.f_applied)
    assert torch.equal(ref.f[node], f)
    assert torch.equal(ref.fixed[node], torch.as_tensor(bc.fixed.all(1)))
    shl = ShardedLattice(make_mesh(devices=["cpu"]), lat.nodes, lat.edges,
                         E, NU, dtype=torch.float64)
    gen = torch.Generator().manual_seed(1)
    r = 0.02 + 0.06 * torch.rand(lat.num_edges, dtype=torch.float64,
                                 generator=gen)
    u = torch.randn(lat.num_nodes, 6, dtype=torch.float64, generator=gen)
    Ku = shl.matvec(u, shl.section_D(r))
    rb = torch.zeros(ref.n_beams, dtype=torch.float64)
    rb[beam] = r
    want = ref.apply(view.u_to_ref(ref, u.T), rb)[node]
    assert float((Ku - want).abs().max() / want.abs().max()) < 1e-13
    # the per-strut compliance gradient -u.dK/dr.u by autograd of the
    # energy through the port's operator
    rr = r.clone().requires_grad_(True)
    q = 0.5 * (u * shl.matvec(u, shl.section_D(rr))).sum()
    (gq,) = torch.autograd.grad(q, rr)
    gr = ref.dc_dr(view.u_to_ref(ref, u.T), rb)[beam]
    assert float((-2.0 * gq - gr).abs().max() / gr.abs().max()) < 1e-12
