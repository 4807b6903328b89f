"""Importers for the reference's committed relative-density artifacts.

The reference commits (data/outputs/relative_densities/):

* ``data/RelativeDensities_*.pkl`` — pickled ``{(r_1,...,r_G): density}``
  dicts from its gmsh-CAD dataset builder
  (surrogate_model_relative_densities.py:102-177),
* ``surrogate_model/kriging_model_*`` — joblib dumps of the fitted
  sklearn ``Pipeline(StandardScaler -> GaussianProcessRegressor)`` plus
  metadata (surrogate_model_relative_densities.py:639-659).

These loaders read both WITHOUT the reference installed (the pickles hold
only stdlib/numpy/sklearn objects) and convert the GPR into the port's
closed-form :class:`~pylatticedso_tpu_torch.opti.density.KrigingDensity`,
evaluated and differentiated in torch.  (The JAX package's
``default_reference_root``, which names one machine's checkout of the
reference, has no counterpart here: callers pass the path.)

They exist to make the parity claim auditable: the committed comparison
table (``scripts/compare_reference_density.py`` →
``data/outputs/relative_densities/reference_density_comparison.json``)
quantifies how far the reference's committed CAD datasets sit from
analytically checkable ground truth (sum of cylinder volumes at small
radii, voxel-exact union quadrature elsewhere) and from the densities its
own optimization records log.
"""

from __future__ import annotations

import pickle
from typing import Dict, Tuple

import numpy as np

from ..opti.density import KrigingDensity

__all__ = ["load_reference_density_dataset", "load_reference_kriging"]


def load_reference_density_dataset(path) -> Dict[Tuple[float, ...], float]:
    """Load a ``RelativeDensities_*.pkl`` dataset as plain-float dict.

    Keys are radius tuples rounded to 6 decimals (the repo's dataset-key
    convention, opti/density.py:density_dataset).
    """
    with open(path, "rb") as fh:
        raw = pickle.load(fh)
    return {tuple(round(float(c), 6) for c in k): float(v)
            for k, v in raw.items()}


def load_reference_kriging(path) -> KrigingDensity:
    """Load a ``kriging_model_*`` joblib dump into a torch-evaluable
    :class:`KrigingDensity` (metadata discarded; sklearn needed only at
    load time, and only to unpickle — evaluation is closed-form torch)."""
    import warnings

    import joblib

    with warnings.catch_warnings():
        # the reference pickled with sklearn 1.7.1; the version-skew
        # warning is expected and the GPR attributes we read are stable
        warnings.simplefilter("ignore")
        raw = joblib.load(path)
    pipe = raw["model"] if isinstance(raw, dict) else raw
    return KrigingDensity.from_sklearn(pipe)

