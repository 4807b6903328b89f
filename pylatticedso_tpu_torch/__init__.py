"""PyTorch/CUDA port of ``pylatticedso_tpu``'s structured compliance step.

The package imports torch and numpy only.  Entry points build their tensors
on ``device`` (default ``"cuda"``); the tests pass ``"cpu"``, where every
kernel wrapper runs its plain torch version.
"""

from .parallel.structured import (StructuredLattice,
                                  make_structured_compliance_step)

__all__ = ["StructuredLattice", "make_structured_compliance_step"]
