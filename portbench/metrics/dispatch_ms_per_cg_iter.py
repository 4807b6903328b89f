"""Milliseconds of the host's enqueue a CG iteration in the traced steps:
the program's ``pcg`` spans less the ``sync`` spans, all of which lie
inside them (the host blocked on the device), over the traced steps' CG
iterations."""

from portbench.harness import spans


def read(readings, registry=None):
    t = spans.registry(registry)
    if not t.count("pcg"):
        return None
    return spans.per_traced(readings, "iterations",
                            1e3 * (t.total("pcg") - t.total("sync")))
