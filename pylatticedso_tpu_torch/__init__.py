"""PyTorch/CUDA port of ``pylatticedso_tpu``: the lattice builder, the
structured compliance step and the design optimizer.

The package imports torch and numpy only.  Entry points build their tensors
on ``device`` (default ``"cuda"``); the tests pass ``"cpu"``, where every
kernel wrapper runs its plain torch version.
"""

from .config import LatticeConfig, load_config
from .design import Lattice, build_lattice
from .materials import MatProperties
from .opti import optimize_lattice
from .parallel.structured import (StructuredLattice,
                                  make_structured_compliance_step)

__all__ = ["LatticeConfig", "load_config", "Lattice", "build_lattice",
           "MatProperties", "optimize_lattice", "StructuredLattice",
           "make_structured_compliance_step"]
