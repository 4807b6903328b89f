"""Host-side timing of the port on the profiler's clock: coarse phases, hot
spans inside the design step, and the naming of the device's idle gaps by
the span the host was in.

One registry (``timing``, process-wide; ``Timing()`` makes a private one)
holds per name the inclusive seconds, the self seconds (less the spans and
phases that closed inside it) and the count, in two forms:

* coarse phases, ``phase(name, category)`` and the ``timeit`` decorator
  (``build_lattice``, ``solve_fem``, the DDM condensations), record every
  call;
* hot spans mark the parts of a design step: ``step`` (the structured
  step, the edge-sharded ``step.chunked``), ``pcg`` (one call of
  ``fem.solve.pcg``), ``sync`` (``pcg``'s reads of a device value, which
  wait for the device; ``sync.step`` is ``step.chunked``'s read of its
  residual, outside ``pcg``), ``mg.level.<k>`` (one visit of V-cycle level k, the
  coarser levels it calls included), ``mg.state`` (one
  ``mg_precond_state``), ``mg.graph.capture`` / ``mg.graph.replay``
  (one capture / one replay of a V-cycle's CUDA graph: the unfused
  cycle's levels below the fine one, inside ``mg.level.1``, where the graph
  runs the spans ``mg.level.2`` and below fire only on eager and capturing
  applications and ``mg.level.1`` holds the replay's enqueue; the fused
  cycle whole, inside ``mg.level.0``, the spans below it firing only on
  eager and capturing applications) and ``mg.fused.b3`` /
  ``mg.fused.b4`` / ``mg.fused.b5`` (one CUDA launch of the fused V-cycle's
  kernel B3, B4 or B5, or of its bf16-compute instance, inside
  ``mg.level.<k>``: the launch path, checks included).  A
  function is one (``@timing.spanned(name)``), or a call is
  (``timing.timed(name, fn)(...)``).  They record only while
  a ``torch.profiler`` session is active; otherwise the decorated function
  tests a flag and calls through, and ``timed`` returns ``fn`` itself, so
  an unprofiled step pays a flag read a span and allocates nothing (a
  ``with`` statement, even on a shared no-op object, would cost several
  times that).  A span adds no device operation (no ``record_function``,
  no CUDA event, no synchronise), so a device trace counts the same
  operations with spans as without.

Both forms stamp ``time.time_ns()``, the Unix-epoch clock of the
profiler's kineto records (``start_ns()``): a span and the device
operations launched inside it lie on one time axis.  While a profiler
session is active, each span or phase that closes also goes into a
bounded timeline of ``(name, t0_ns, t1_ns)`` records (the newest
``CAPACITY``); ``dropped`` counts the records the bound pushed out.  ``name_idle_gaps`` puts the device's idle
gaps down to that timeline.  Host times are the dispatching thread's:
device work runs asynchronously, so a span holds the enqueue of its work
and whatever waits inside it.
"""

from __future__ import annotations

import functools
import re
import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch.autograd.profiler as _profiler

__all__ = ["Timing", "timing", "name_idle_gaps"]

CAPACITY = 1 << 16            # timeline records kept (newest)


class _Span:
    __slots__ = ("_timing", "_name")

    def __init__(self, timing: "Timing", name: str):
        self._timing, self._name = timing, name

    def __enter__(self):
        self._timing._local_stack().append([self._name, time.time_ns(), 0])

    def __exit__(self, *exc):
        self._timing._close(time.time_ns())


class Timing:
    def __init__(self):
        self._total: Dict[str, int] = defaultdict(int)     # ns
        self._self: Dict[str, int] = defaultdict(int)      # ns
        self._counts: Dict[str, int] = defaultdict(int)
        self._categories: Dict[str, str] = {}
        self._timeline: deque = deque(maxlen=CAPACITY)
        self._offered = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    # ------------------------------------------------------------------
    def _local_stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _close(self, t1: int) -> None:
        stack = self._local_stack()
        name, t0, child = stack.pop()
        dt = t1 - t0
        if stack:
            stack[-1][2] += dt
        with self._lock:
            self._total[name] += dt
            self._self[name] += dt - child
            self._counts[name] += 1
            if _profiler._is_profiler_enabled:
                self._timeline.append((name, t0, t1))
                self._offered += 1

    def spanned(self, name: str):
        """Decorator: each call of the function is the hot span ``name``
        while a ``torch.profiler`` session is active; off, a call costs a
        flag read more."""
        def wrap(fn):
            @functools.wraps(fn)
            def inner(*args, **kwargs):
                if not _profiler._is_profiler_enabled:
                    return fn(*args, **kwargs)
                with _Span(self, name):
                    return fn(*args, **kwargs)

            return inner
        return wrap

    def timed(self, name: str, fn: Callable) -> Callable:
        """``fn`` itself, or while a ``torch.profiler`` session is active
        ``fn`` in the hot span ``name``: the form for a call inside a
        loop, which costs the flag read when off."""
        if not _profiler._is_profiler_enabled:
            return fn
        return functools.partial(self._call, name, fn)

    def _call(self, name: str, fn: Callable, *args, **kwargs):
        with _Span(self, name):
            return fn(*args, **kwargs)

    def phase(self, name: str, category: Optional[str] = None):
        """A coarse phase: ``with timing.phase(name):`` records every
        time."""
        if category:
            self._categories[name] = category
        return _Span(self, name)

    def timeit(self, fn=None, *, category: Optional[str] = None):
        """Decorator: a phase under the function's qualname."""
        def wrap(f):
            name = f.__qualname__

            @functools.wraps(f)
            def inner(*a, **k):
                with self.phase(name, category):
                    return f(*a, **k)

            return inner
        return wrap(fn) if fn is not None else wrap

    # ------------------------------------------------------------------
    def total(self, name: str) -> float:
        """Inclusive seconds of ``name``."""
        return self._total.get(name, 0) * 1e-9

    def self_total(self, name: str) -> float:
        """Seconds of ``name`` outside the spans and phases inside it."""
        return self._self.get(name, 0) * 1e-9

    def count(self, name: str) -> int:
        return self._counts.get(name, 0)

    def timeline(self) -> List[Tuple[str, int, int]]:
        """The kept ``(name, t0_ns, t1_ns)`` records, in the order they
        closed."""
        return list(self._timeline)

    @property
    def dropped(self) -> int:
        """Timeline records pushed out by the bound."""
        return self._offered - len(self._timeline)

    def reset(self) -> None:
        with self._lock:
            self._total.clear()
            self._self.clear()
            self._counts.clear()
            self._categories.clear()
            self._timeline.clear()
            self._offered = 0

    def summary(self, pattern: Optional[str] = None,
                top: Optional[int] = None) -> str:
        """Print and return a table of every name (``pattern``: a regular
        expression it must match), largest inclusive total first."""
        rows = sorted(((self.total(n), self.self_total(n), c,
                        self._categories.get(n, "-"), n)
                       for n, c in self._counts.items()
                       if not pattern or re.search(pattern, n)),
                      reverse=True)[:top]
        lines = [f"{'total [s]':>10}  {'self [s]':>10}  {'calls':>7}  "
                 f"{'category':<16} name"]
        lines += [f"{t:10.4f}  {s:10.4f}  {c:7d}  {cat:<16} {n}"
                  for t, s, c, cat, n in rows]
        out = "\n".join(lines)
        print(out)
        return out


def name_idle_gaps(device: Iterable[Tuple[int, int]],
                   timeline: Iterable[Tuple[str, int, int]]) -> List[Tuple]:
    """The device's idle gaps, each with the innermost span open on the
    host when it began and when it ended.

    ``device`` holds ``(start_ns, end_ns)`` of device operations, e.g. the
    CUDA records of a ``torch.profiler`` run (``e.start_ns()``,
    ``e.start_ns() + e.duration_ns()``); ``timeline`` the records of
    ``Timing.timeline()`` from the same run, on the same clock.  A gap is
    an interval between two stretches of the union of the operations.
    Spans are taken from one host thread, so they nest.  Returns
    ``(t0_ns, t1_ns, began_in, ended_in)`` a gap, in time order, with None
    where no span was open: ``began_in`` names the gap (what the host was
    in when the device ran dry), ``ended_in`` what it was in when the
    device got work again."""
    ops = sorted((int(s), int(e)) for s, e in device if e > s)
    gaps, cur = [], None
    for s, e in ops:
        if cur is not None and s > cur:
            gaps.append((cur, s))
        cur = e if cur is None else max(cur, e)
    spans = sorted(((int(r[1]), int(r[2]), r[0]) for r in timeline),
                   key=lambda sp: (sp[0], -sp[1]))

    def innermost(points):
        # one sweep over the sorted points: a stack of the spans open there
        out, stack, j = [], [], 0
        for p in points:
            while j < len(spans) and spans[j][0] <= p:
                while stack and stack[-1][1] <= spans[j][0]:
                    stack.pop()
                stack.append(spans[j])
                j += 1
            while stack and stack[-1][1] <= p:
                stack.pop()
            out.append(stack[-1][2] if stack else None)
        return out

    began = innermost([g[0] for g in gaps])
    ended = innermost([g[1] for g in gaps])
    return [(g0, g1, b, e) for (g0, g1), b, e in zip(gaps, began, ended)]


# process-wide registry, like the reference's `timing` (timing.py:288)
timing = Timing()
