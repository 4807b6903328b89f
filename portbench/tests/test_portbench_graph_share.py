"""``coarse_graph_share``'s reader on a private registry filled by hand:
replays over visits of the levels below the fine one, and None where there
is nothing to read."""

import pytest

from portbench.harness import spec
from pylatticedso_tpu_torch.utils.timing import Timing


def _reader():
    return spec.resolve("octet100.descent").reader("coarse_graph_share")


def _registry(counts):
    t = Timing()
    for name, n in counts.items():
        t._total[name] = n * 1000
        t._counts[name] = n
    return t


TRACE = {"steps": [], "trace": {"iterations": 40, "steps": 2}}


@pytest.mark.parametrize("counts,want", [
    ({"mg.level.1": 40, "mg.graph.replay": 40}, 100.0),
    ({"mg.level.1": 82, "mg.graph.capture": 1, "mg.graph.replay": 81},
     100.0 * 81 / 82),
    ({"mg.level.1": 4, "mg.graph.capture": 1}, 0.0),
])
def test_values(counts, want):
    assert _reader().read(TRACE, _registry(counts)) == pytest.approx(want)


@pytest.mark.parametrize("counts,trace", [
    ({"mg.level.1": 40}, TRACE["trace"]),          # the graph's spans absent
    ({}, TRACE["trace"]),                           # no spans at all
    ({"mg.graph.replay": 3}, TRACE["trace"]),       # no visit below level 0
    ({"mg.level.1": 40, "mg.graph.replay": 40}, None),   # no trace
])
def test_nothing_to_read(counts, trace):
    r = {"steps": [], "trace": trace}
    assert _reader().read(r, _registry(counts)) is None
