"""Material database.

Mirrors the reference's ``MatProperties`` JSON loader
(`pyLatticeDesign/materials.py:9-53`) with the same three
built-in materials (VeroClear, TPU, Ti-6Al-4V — elastic constants from the
reference's material JSONs).  Only ``young_modulus`` and ``poisson_ratio``
enter the linear beam solver; density feeds mass/inertia queries.  Plastic
hardening curves may be supplied through user JSON files (key ``"plastic"``:
list of [stress, plastic strain] pairs) — the built-ins omit them since no
code path in either framework consumes plasticity.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Union

__all__ = ["MatProperties", "register_material", "available_materials"]

# name -> dict(density [t/mm^3], Young_modulus [MPa], Poisson_ratio)
_BUILTIN: Dict[str, dict] = {
    "VeroClear": {"density": 1.18e-9, "Young_modulus": 1013.0, "Poisson_ratio": 0.3},
    "TPU": {"density": 1.205e-9, "Young_modulus": 20000.0, "Poisson_ratio": 0.3},
    "Ti-6Al-4V": {"density": 4.43e-9, "Young_modulus": 104000.0, "Poisson_ratio": 0.35},
}


@dataclass
class MatProperties:
    """Elastic (and optionally plastic) properties of one material."""

    name_material: str
    density: Optional[float] = None
    young_modulus: Optional[float] = None
    poisson_ratio: Optional[float] = None
    plastic: Optional[List[List[float]]] = field(default=None, repr=False)

    def __init__(self, name_material: Union[str, Path], **overrides):
        name = str(name_material)
        if name.endswith(".json"):
            path = Path(name)
            if not path.exists():
                raise FileNotFoundError(f"Material file not found: {path}")
            data = json.loads(path.read_text())
        elif name in _BUILTIN:
            data = {"name": name, **_BUILTIN[name]}
        else:
            raise FileNotFoundError(
                f"Material '{name}' not found. Built-ins: {sorted(_BUILTIN)}; "
                "or pass a path to a material JSON file."
            )
        data.update(overrides)
        self.name_material = data.get("name", name)
        self.density = data.get("density")
        self.young_modulus = data.get("Young_modulus")
        self.poisson_ratio = data.get("Poisson_ratio")
        self.plastic = data.get("plastic")
        self._validate()

    def _validate(self):
        if self.young_modulus is not None and self.young_modulus <= 0:
            raise ValueError(f"Young modulus must be positive, got {self.young_modulus}")
        if self.poisson_ratio is not None and not (0.0 <= self.poisson_ratio <= 0.5):
            raise ValueError(f"Poisson ratio must be in [0, 0.5], got {self.poisson_ratio}")
        if self.density is not None and self.density <= 0:
            raise ValueError(f"Density must be positive, got {self.density}")

    @property
    def shear_modulus(self) -> float:
        """G = E / (2 (1 + nu)) — matches material_definition.py:129-131."""
        return self.young_modulus / (2.0 * (1.0 + self.poisson_ratio))


def register_material(name: str, density: float, young_modulus: float,
                      poisson_ratio: float, plastic: Optional[list] = None) -> None:
    """Add a material to the in-process database."""
    _BUILTIN[name] = {
        "density": density,
        "Young_modulus": young_modulus,
        "Poisson_ratio": poisson_ratio,
        **({"plastic": plastic} if plastic is not None else {}),
    }


def available_materials() -> List[str]:
    return sorted(_BUILTIN)
