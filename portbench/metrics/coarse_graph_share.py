"""Share of the V-cycle's visits below the fine level that replayed a CUDA
graph in the traced steps: the program's ``mg.graph.replay`` spans over its
``mg.level.1`` spans, in %.  None without a trace, where no level below
the fine one was visited, or where the program has neither
``mg.graph.capture`` nor ``mg.graph.replay`` (a program without the graph,
or a run in which it never engaged)."""

from portbench.harness import spans


def read(readings, registry=None):
    t = spans.registry(registry)
    visits, replays = t.count("mg.level.1"), t.count("mg.graph.replay")
    if not readings.get("trace") or not visits \
            or not (replays or t.count("mg.graph.capture")):
        return None
    return 100.0 * replays / visits
