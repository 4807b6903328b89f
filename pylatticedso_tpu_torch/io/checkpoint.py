"""Lattice and artifact checkpointing.

The reference pickles its object graph with back-reference scrubbing
(utils.py:132-361) and upcasts plain Lattice pickles into LatticeSim /
LatticeOpti on load (lattice.py:111-161).  Arrays need none of that: a
lattice round-trips through one ``.npz`` (config JSON + arrays), atomically
written like the reference's resumable dataset writes
(surrogate_model_relative_densities.py:180-188).
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

import numpy as np

from ..config import load_config
from ..design.lattice import Lattice

__all__ = ["save_lattice", "load_lattice", "atomic_savez"]

_ARRAY_FIELDS = [
    "nodes", "node_tag", "edges", "radius", "edge_type", "edge_mat",
    "cell_pos", "cell_origin", "cell_size", "cell_radii",
    "cell_edge_ptr", "cell_edge_idx", "cell_node_ptr", "cell_node_idx",
    "edge_cell",
]


def atomic_savez(path, **arrays) -> None:
    """np.savez with write-to-temp + os.replace (crash-safe)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)  # keeps the name: it already ends in .npz
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_lattice(lattice: Lattice, path) -> None:
    arrays = {f: getattr(lattice, f) for f in _ARRAY_FIELDS}
    arrays["_config_json"] = np.frombuffer(
        json.dumps(lattice.config.raw or {}).encode(), dtype=np.uint8)
    arrays["_name"] = np.frombuffer(lattice.name.encode(), dtype=np.uint8)
    atomic_savez(path, **arrays)


def load_lattice(path) -> Lattice:
    d = np.load(path)
    cfg_raw = json.loads(bytes(d["_config_json"]).decode() or "{}")
    try:
        cfg = load_config(cfg_raw)
    except Exception:
        from ..config import LatticeConfig
        cfg = LatticeConfig(raw=cfg_raw)
    lat = Lattice(config=cfg, name=bytes(d["_name"]).decode())
    for f in _ARRAY_FIELDS:
        setattr(lat, f, d[f])
    return lat
