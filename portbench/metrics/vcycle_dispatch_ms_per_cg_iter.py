"""Host milliseconds of the V-cycle a CG iteration in the traced steps:
the program's ``mg.level.0`` spans (whole V-cycles) over the traced steps'
CG iterations."""

from portbench.harness import spans


def read(readings, registry=None):
    t = spans.registry(registry)
    if not t.count("mg.level.0"):
        return None
    return spans.per_traced(readings, "iterations",
                            1e3 * t.total("mg.level.0"))
