"""Host milliseconds of the V-cycle's levels below the fine one a CG
iteration in the traced steps: the program's ``mg.level.1`` spans (each
holds the levels below it) over the traced steps' CG iterations; 0 where
the hierarchy has one level."""

from portbench.harness import spans


def read(readings, registry=None):
    t = spans.registry(registry)
    if not t.count("mg.level.0"):
        return None
    return spans.per_traced(readings, "iterations",
                            1e3 * t.total("mg.level.1"))
