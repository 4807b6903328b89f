"""Host milliseconds of a traced design step outside CG: the program's
``step`` spans less the ``pcg`` spans inside them (the operator's
preparation, the right-hand side, the gradient, and in the edge step the
``sync.step`` read that ``sync_wait_ms_per_cg_iter.edge`` counts too),
over the traced steps."""

from portbench.harness import spans


def read(readings, registry=None):
    t = spans.registry(registry)
    if not t.count("step") or not t.count("pcg"):
        return None
    return spans.per_traced(readings, "steps",
                            1e3 * (t.total("step") - t.total("pcg")))
