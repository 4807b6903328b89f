"""Import lattices pickled by the reference implementation.

The reference saves its ``Lattice`` object graph with pickle after scrubbing
back-references and converting sets to lists (utils.py:132-361), and loads
them back with an optional subclass upcast (lattice.py:111-161).  Users of
the reference therefore hold ``.pkl`` files whose payload is a web of
``pyLatticeDesign.{lattice,cell,beam,point}`` instances.

This module reads those files WITHOUT the reference package installed: a
custom unpickler maps every ``pyLattice*`` class onto an attribute-bag stub,
then the object graph is flattened into this package's array-of-structs
:class:`~pylatticedso_tpu.design.lattice.Lattice`.  The reference's "upcast
to LatticeSim/LatticeOpti" step has no analogue here — simulation and
optimization consume the same array model — but any simulation state stored
on the points (applied forces, fixed DOFs, displacements, reactions) is
preserved in ``lattice._extras`` so a solve can resume from it.
"""

from __future__ import annotations

import io
import pickle
from pathlib import Path
from typing import Union

import numpy as np

from ..config import LatticeConfig, load_config
from ..design.lattice import Lattice

__all__ = ["load_reference_pickle"]


class _Stub:
    """Attribute bag standing in for a reference class during unpickling."""

    def __setstate__(self, state):
        if isinstance(state, tuple) and len(state) == 2:  # (dict, slots)
            d, slots = state
            if d:
                self.__dict__.update(d)
            if slots:
                self.__dict__.update(slots)
        elif isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __repr__(self):  # pragma: no cover
        return f"<{type(self).__name__} stub>"


class _ReferenceUnpickler(pickle.Unpickler):
    """Resolve ``pyLatticeDesign``/``pyLatticeSim``/``pyLatticeOpti`` classes
    to generated stubs; everything else (numpy, scipy) resolves normally."""

    _cache: dict = {}

    def find_class(self, module, name):
        if "pyLattice" in module:
            key = (module, name)
            if key not in self._cache:
                self._cache[key] = type(name, (_Stub,), {"__module__": module})
            return self._cache[key]
        return super().find_class(module, name)


def _get(obj, attr, default=None):
    return getattr(obj, attr, default)


def _as_list(x):
    if x is None:
        return []
    return list(x)


def load_reference_pickle(path: Union[str, Path],
                          name: str = None) -> Lattice:
    """Load a reference-produced ``.pkl`` lattice into the array model.

    Node and beam ordering follow the reference's global indices when they
    are present and complete (define_beam_node_index, lattice.py:665-698);
    otherwise encounter order over ``cells -> beams_cell`` is used with
    9-digit rounded-coordinate dedup (the reference's own key semantics,
    cell.py:317-380).
    """
    path = Path(path)
    if path.suffix != ".pkl":
        path = path.with_suffix(".pkl")
    with open(path, "rb") as fh:
        ref = _ReferenceUnpickler(io.BufferedReader(fh)).load()

    cells = _as_list(_get(ref, "cells"))
    if not cells:
        raise ValueError(f"{path}: pickle holds no cells — not a reference "
                         "lattice save")

    # ---------------------------------------------------------------- nodes
    # collect unique Point objects (identity-deduped: the reference shares
    # Point instances across beams and cells)
    points, seen = [], set()

    def visit(p):
        if id(p) not in seen:
            seen.add(id(p))
            points.append(p)

    for c in cells:
        for b in _as_list(_get(c, "beams_cell")):
            visit(b.point1)
            visit(b.point2)
        for p in _as_list(_get(c, "points_cell")):
            visit(p)
    for p in _as_list(_get(ref, "nodes")):
        visit(p)

    idxs = [_get(p, "index") for p in points]
    if all(i is not None for i in idxs) and len(set(idxs)) == len(idxs):
        points.sort(key=lambda p: p.index)
    node_id = {id(p): i for i, p in enumerate(points)}

    nodes = np.array([[p.x, p.y, p.z] for p in points], dtype=np.float64)
    node_tag = np.array([int(_get(p, "tag") or 0) for p in points],
                        dtype=np.int32)

    # ---------------------------------------------------------------- edges
    beams, bseen = [], set()
    beam_cell = {}
    for ci, c in enumerate(cells):
        for b in _as_list(_get(c, "beams_cell")):
            if id(b) not in bseen:
                bseen.add(id(b))
                beams.append(b)
                beam_cell[id(b)] = ci
    bidx = [_get(b, "index") for b in beams]
    if all(i is not None for i in bidx) and len(set(bidx)) == len(bidx):
        beams.sort(key=lambda b: b.index)

    E = len(beams)
    edges = np.empty((E, 2), dtype=np.int32)
    radius = np.empty(E, dtype=np.float64)
    etype = np.empty(E, dtype=np.int32)
    emat = np.empty(E, dtype=np.int32)
    ecell = np.empty(E, dtype=np.int32)
    for i, b in enumerate(beams):
        n0, n1 = node_id[id(b.point1)], node_id[id(b.point2)]
        # our convention: lexicographically smaller endpoint first
        if tuple(nodes[n1]) < tuple(nodes[n0]):
            n0, n1 = n1, n0
        edges[i] = (n0, n1)
        radius[i] = float(_get(b, "radius", 0.0))
        etype[i] = int(_get(b, "type_beam", 0) or 0)
        emat[i] = int(_get(b, "material", 0) or 0)
        ecell[i] = beam_cell[id(b)]

    # ---------------------------------------------------------------- cells
    C = len(cells)
    geom_types = list(_get(ref, "geom_types") or ["BCC"])
    G = len(geom_types)
    cell_pos = np.zeros((C, 3), dtype=np.int32)
    cell_origin = np.zeros((C, 3), dtype=np.float64)
    cell_size = np.zeros((C, 3), dtype=np.float64)
    cell_radii = np.zeros((C, G), dtype=np.float64)
    ce_idx, cn_idx = [], []
    ce_ptr, cn_ptr = [0], [0]
    beam_row = {id(b): i for i, b in enumerate(beams)}
    for ci, c in enumerate(cells):
        cell_pos[ci] = np.asarray(_get(c, "pos", (0, 0, 0)), dtype=np.int32)
        cell_origin[ci] = np.asarray(_get(c, "coordinate", (0, 0, 0)))
        cell_size[ci] = np.asarray(_get(c, "size", (1.0, 1.0, 1.0)))
        rr = np.asarray(_get(c, "radii", [0.0] * G), dtype=np.float64)
        cell_radii[ci, :rr.size] = rr[:G]
        eb = sorted(beam_row[id(b)] for b in _as_list(_get(c, "beams_cell")))
        ce_idx.extend(eb)
        ce_ptr.append(len(ce_idx))
        pn = sorted({node_id[id(p)] for p in _as_list(_get(c, "points_cell"))})
        cn_idx.extend(pn)
        cn_ptr.append(len(cn_idx))

    # ---------------------------------------------------------------- config
    raw = {"geometry": {
        "cell_size": {"x": float(_get(ref, "cell_size_x", 1.0)),
                      "y": float(_get(ref, "cell_size_y", 1.0)),
                      "z": float(_get(ref, "cell_size_z", 1.0))},
        "number_of_cells": {"x": int(_get(ref, "num_cells_x", 1)),
                            "y": int(_get(ref, "num_cells_y", 1)),
                            "z": int(_get(ref, "num_cells_z", 1))},
        "radii": [float(r) for r in (_get(ref, "radii") or [0.05])],
        "geom_types": geom_types,
    }}
    try:
        cfg = load_config(raw)
    except Exception:
        cfg = LatticeConfig(raw=raw)

    lat = Lattice(config=cfg,
                  name=name or str(_get(ref, "name_lattice", path.stem)))
    lat.nodes, lat.node_tag = nodes, node_tag
    lat.edges, lat.radius, lat.edge_type, lat.edge_mat = (edges, radius,
                                                          etype, emat)
    lat.cell_pos, lat.cell_origin = cell_pos, cell_origin
    lat.cell_size, lat.cell_radii = cell_size, cell_radii
    lat.cell_edge_ptr = np.asarray(ce_ptr, dtype=np.int64)
    lat.cell_edge_idx = np.asarray(ce_idx, dtype=np.int32)
    lat.cell_node_ptr = np.asarray(cn_ptr, dtype=np.int64)
    lat.cell_node_idx = np.asarray(cn_idx, dtype=np.int32)
    lat.edge_cell = ecell

    # ------------------------------------------------- simulation state
    def field6(attr):
        out = np.zeros((len(points), 6), dtype=np.float64)
        any_set = False
        for i, p in enumerate(points):
            v = _get(p, attr)
            if v is not None:
                v = np.asarray(v, dtype=np.float64)
                if v.shape == (6,) and np.any(v):
                    out[i] = v
                    any_set = True
        return out if any_set else None

    for key, attr in (("u", "displacement_vector"),
                      ("reactions", "reaction_force_vector"),
                      ("f_applied", "applied_force"),
                      ("fixed", "fixed_DOF")):
        v = field6(attr)
        if v is not None:
            lat._extras[key] = v.astype(bool) if key == "fixed" else v
    return lat
