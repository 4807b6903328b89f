"""Lightweight host-side phase profiler (+ torch.profiler integration hooks).

Replaces the reference's decorator-based wall-clock collector
(timing.py:16-288): per-qualified-name durations, call counts, a
parent->child call tree via an explicit stack, category grouping, and a
formatted summary.  For device work, prefer ``trace`` which wraps
``torch.profiler.record_function`` so phases show up in torch.profiler
traces; wall times here always use host clocks and are therefore upper
bounds for asynchronous dispatch.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = ["Timing", "timing"]


class Timing:
    def __init__(self):
        self._durations: Dict[str, List[float]] = defaultdict(list)
        self._counts: Dict[str, int] = defaultdict(int)
        self._children: Dict[str, set] = defaultdict(set)
        self._categories: Dict[str, str] = {}
        self._local = threading.local()
        self.enabled = True

    # ------------------------------------------------------------------
    def _stack(self) -> list:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextmanager
    def phase(self, name: str, category: Optional[str] = None):
        if not self.enabled:
            yield
            return
        stack = self._stack()
        if stack:
            self._children[stack[-1]].add(name)
        stack.append(name)
        if category:
            self._categories[name] = category
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            self._durations[name].append(dt)
            self._counts[name] += 1

    def timeit(self, fn=None, *, category: Optional[str] = None):
        """Decorator: record wall time under the function's qualname."""
        def wrap(f):
            name = f.__qualname__

            @functools.wraps(f)
            def inner(*a, **k):
                with self.phase(name, category):
                    return f(*a, **k)

            return inner
        return wrap(fn) if fn is not None else wrap

    @contextmanager
    def trace(self, name: str):
        """Host phase + a ``record_function`` range (visible in
        torch.profiler traces)."""
        from torch.profiler import record_function
        with self.phase(name), record_function(name):
            yield

    # ------------------------------------------------------------------
    def total(self, name: str) -> float:
        return sum(self._durations.get(name, []))

    def count(self, name: str) -> int:
        return self._counts.get(name, 0)

    def children(self, name: str) -> set:
        return set(self._children.get(name, set()))

    def reset(self) -> None:
        self._durations.clear()
        self._counts.clear()
        self._children.clear()
        self._categories.clear()

    def summary(self, pattern: Optional[str] = None, top: Optional[int] = None,
                group_by_category: bool = False) -> str:
        import re
        rows = []
        for name, durs in self._durations.items():
            if pattern and not re.search(pattern, name):
                continue
            rows.append((sum(durs), self._counts[name],
                         self._categories.get(name, "-"), name))
        rows.sort(reverse=True)
        if top:
            rows = rows[:top]
        lines = [f"{'total [s]':>10}  {'calls':>6}  {'category':<16} name"]
        if group_by_category:
            by_cat = defaultdict(float)
            for t, c, cat, n in rows:
                by_cat[cat] += t
            for cat, t in sorted(by_cat.items(), key=lambda kv: -kv[1]):
                lines.append(f"{t:10.4f}  {'':>6}  {cat:<16} (category total)")
        for t, c, cat, n in rows:
            lines.append(f"{t:10.4f}  {c:6d}  {cat:<16} {n}")
        out = "\n".join(lines)
        print(out)
        return out

    # pickle-safety: drop the thread-local
    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_local", None)
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._local = threading.local()


# process-wide singleton, like the reference's `timing` (timing.py:288)
timing = Timing()
