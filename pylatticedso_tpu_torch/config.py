"""Lattice configuration loading and validation.

One JSON schema feeds all three layers (design / simulation / optimization),
mirroring the reference's single-file configs
(`pyLatticeDesign/utils.py:111-130` loader;
`lattice.py:212-311` geometry/gradient/supplementary extraction;
`lattice_sim.py:201-238` simulation block; `lattice_opti.py:228-256`
optimization block).  This module normalizes a raw dict or JSON path into a
typed :class:`LatticeConfig`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

__all__ = ["LatticeConfig", "GradientSpec", "load_config", "open_lattice_parameters"]

_SEARCH_DIRS = [
    Path("."),
    Path("data/inputs/preset_lattice"),   # "design/L_logo"-style names
    Path("data/inputs/preset_lattice/design"),
    Path("data/inputs/preset_lattice/simulation"),
    Path("data/inputs/preset_lattice/optimization"),
]

VALID_SURFACES = {"Xmin", "Xmax", "Ymin", "Ymax", "Zmin", "Zmax", "Xmid", "Ymid", "Zmid"}
DOF_NAMES = {"X": 0, "Y": 1, "Z": 2, "RX": 3, "RY": 4, "RZ": 5}


def open_lattice_parameters(name_file: Union[str, Path, dict]) -> dict:
    """Resolve a config by dict, absolute path, or preset name (utils.py:111-130)."""
    if isinstance(name_file, dict):
        return name_file
    p = Path(name_file)
    candidates = [p] if p.suffix == ".json" else [p.with_suffix(".json")]
    tried = []
    for base in _SEARCH_DIRS:
        for c in candidates:
            full = c if c.is_absolute() else base / c
            tried.append(full)
            if full.exists():
                return json.loads(full.read_text())
    raise FileNotFoundError(f"Lattice parameter file not found; tried {tried}")


@dataclass
class GradientSpec:
    rule: str = "constant"
    direction: Tuple[bool, bool, bool] = (False, False, False)
    parameters: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @classmethod
    def from_json(cls, d: Optional[dict]) -> "GradientSpec":
        d = d or {}
        return cls(
            rule=d.get("rule", "constant"),
            direction=(bool(d.get("direction_x", False)),
                       bool(d.get("direction_y", False)),
                       bool(d.get("direction_z", False))),
            parameters=(float(d.get("parameter_x", 0.0)),
                        float(d.get("parameter_y", 0.0)),
                        float(d.get("parameter_z", 0.0))),
        )


@dataclass
class LatticeConfig:
    """Normalized lattice configuration (geometry + gradients + sim + opti)."""

    # geometry
    cell_size: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    num_cells: Tuple[int, int, int] = (1, 1, 1)
    radii: List[float] = field(default_factory=lambda: [0.05])
    geom_types: List[str] = field(default_factory=lambda: ["BCC"])
    enable_randomness: bool = False
    range_radius: Tuple[float, float] = (0.01, 0.1)
    randomness_hybrid: bool = False

    # gradients
    grad_radius: GradientSpec = field(default_factory=GradientSpec)
    grad_dim: GradientSpec = field(default_factory=GradientSpec)
    grad_mat: Tuple[int, int] = (0, 0)  # (multimat type, direction)

    # supplementary
    uncertainty_node: float = 0.0
    eraser_blocks: Optional[List[List[float]]] = None  # [x,y,z,dx,dy,dz] each
    symmetries: Optional[dict] = None  # {"sym_plane": str, "sym_point": (x,y,z)}

    # simulation
    simulation: Optional[dict] = None            # raw simulation_parameters block
    boundary_conditions: Optional[dict] = None   # raw BC block
    optimization: Optional[dict] = None          # raw optimization_informations block

    raw: dict = field(default_factory=dict, repr=False)

    @property
    def n_geom(self) -> int:
        return len(self.geom_types)

    def material_name(self) -> str:
        return (self.simulation or {}).get("material", "VeroClear")


def _validate(cfg: LatticeConfig) -> None:
    """Input validation mirroring _validate_inputs_lattice (utils.py:19-105)."""
    if any(s <= 0 for s in cfg.cell_size):
        raise ValueError(f"cell_size must be positive, got {cfg.cell_size}")
    if any(n <= 0 or n != int(n) for n in cfg.num_cells):
        raise ValueError(f"number_of_cells must be positive integers, got {cfg.num_cells}")
    if not cfg.geom_types:
        raise ValueError("geom_types must be a non-empty list")
    if len(cfg.radii) != len(cfg.geom_types):
        raise ValueError(
            f"radii ({len(cfg.radii)}) and geom_types ({len(cfg.geom_types)}) must have equal length")
    if any(r < 0 for r in cfg.radii):
        raise ValueError(f"radii must be non-negative, got {cfg.radii}")
    if cfg.uncertainty_node < 0:
        raise ValueError("node_uncertainty must be non-negative")
    if cfg.grad_radius.rule not in ("constant", "linear", "parabolic", "sinusoide", "exponential"):
        raise ValueError(f"Unknown radius gradient rule {cfg.grad_radius.rule!r}")
    if cfg.grad_dim.rule not in ("constant", "linear", "parabolic", "sinusoide", "exponential"):
        raise ValueError(f"Unknown cell-dimension gradient rule {cfg.grad_dim.rule!r}")
    if cfg.eraser_blocks is not None:
        for blk in cfg.eraser_blocks:
            if len(blk) != 6:
                raise ValueError("each erased block needs [x, y, z, dx, dy, dz]")
    bc = cfg.boundary_conditions or {}
    for key, conditions in bc.items():
        if key not in ("Force", "Displacement"):
            raise ValueError(f"Invalid boundary condition type: {key}. Must be 'Force' or 'Displacement'.")
        for name, data in conditions.items():
            for req in ("Surface", "Value", "DOF"):
                if req not in data:
                    raise ValueError(f"Boundary condition {name!r} missing {req!r}")
            if len(data["Value"]) != len(data["DOF"]):
                raise ValueError(f"Boundary condition {name!r}: Value and DOF must have the same length.")
            if not all(d in DOF_NAMES for d in data["DOF"]):
                raise ValueError(f"Boundary condition {name!r}: DOF must be one of {sorted(DOF_NAMES)}")
            if not all(s in VALID_SURFACES for s in data["Surface"]):
                raise ValueError(f"Boundary condition {name!r}: Surface must be one of {sorted(VALID_SURFACES)}")


def load_config(source: Union[str, Path, dict]) -> LatticeConfig:
    """Parse + validate a config from a dict, path, or preset name."""
    params = open_lattice_parameters(source)

    geometry = params.get("geometry", {})
    cell_size = geometry.get("cell_size", {})
    number_of_cells = geometry.get("number_of_cells", {})
    required = [cell_size.get(a) for a in "xyz"] + [number_of_cells.get(a) for a in "xyz"] \
        + [geometry.get("radii"), geometry.get("geom_types")]
    if any(v is None for v in required):
        raise ValueError("Missing geometry parameters in JSON file.")

    gradient = params.get("gradient", {})
    mat_grad = gradient.get("material", {})
    supplementary = params.get("supplementary", {})

    eraser = []
    for block in supplementary.get("erased_blocks", {}).values():
        start = block.get("start_point", {})
        dim = block.get("dimensions_block", {})
        eraser.append([start.get("x", 0.0), start.get("y", 0.0), start.get("z", 0.0),
                       dim.get("x", 0.0), dim.get("y", 0.0), dim.get("z", 0.0)])

    symmetries = None
    sym_json = supplementary.get("symmetries", {})
    if sym_json:
        pt = sym_json.get("reference_point", {})
        symmetries = {
            "sym_plane": sym_json.get("plane"),
            "sym_point": (pt.get("x", 0.0), pt.get("y", 0.0), pt.get("z", 0.0)),
        }

    cfg = LatticeConfig(
        cell_size=tuple(float(cell_size[a]) for a in "xyz"),
        num_cells=tuple(int(number_of_cells[a]) for a in "xyz"),
        radii=[float(r) for r in geometry["radii"]],
        geom_types=list(geometry["geom_types"]),
        enable_randomness=bool(geometry.get("enable_randomness", False)),
        range_radius=tuple(geometry.get("range_radius", [0.01, 0.1])),
        randomness_hybrid=bool(geometry.get("randomness_hybrid", False)),
        grad_radius=GradientSpec.from_json(gradient.get("radii")),
        grad_dim=GradientSpec.from_json(gradient.get("cell_dimension")),
        grad_mat=(int(mat_grad.get("type", 0)), int(mat_grad.get("direction", 0))),
        uncertainty_node=float(supplementary.get("node_uncertainty", 0.0)),
        eraser_blocks=eraser or None,
        symmetries=symmetries,
        simulation=params.get("simulation_parameters"),
        boundary_conditions=params.get("boundary_conditions"),
        optimization=params.get("optimization_informations"),
        raw=params,
    )
    _validate(cfg)
    return cfg
