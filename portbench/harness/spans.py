"""What the readers of the program's spans share.

The program's timing registry (``pylatticedso_tpu_torch.utils.timing``)
sums its hot spans (``step``, ``pcg``, ``sync``, ``sync.step``,
``mg.level.<k>``, ``mg.state``) only while a ``torch.profiler`` session
runs; in a run of the benchmark that is the traced steps alone, so its
totals are theirs.  A program without those spans leaves their counts at
0, and the readers then return None.
"""

from __future__ import annotations

__all__ = ["registry", "per_traced"]


def registry(given=None):
    """``given``, or the program's process-wide registry."""
    if given is not None:
        return given
    from pylatticedso_tpu_torch.utils.timing import timing
    return timing


def per_traced(readings, key: str, ms: float):
    """``ms`` over the traced steps' ``key`` (``iterations``: their CG
    iterations; ``steps``: their count); None without a trace."""
    tr = readings.get("trace")
    n = tr.get(key) if tr else None
    return ms / n if n else None
