"""The device trace of a few steps: ``torch.profiler`` with CUDA activity
only (a trace of host operations too stretches the wall clock it is
compared with), summed straight from the trace's kineto records.

``summary()`` gives the seconds in which some operation ran on the device
(the union of the operations' intervals), the operations by name (seconds
and count), the events in all, and the longest idle gaps between device
operations, named by the operations on either side of them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

__all__ = ["DeviceTrace", "short"]

NAME_CHARS = 100


def short(name: str) -> str:
    """A kernel's name cut to its first characters (its template
    arguments tell the instances apart)."""
    name = name[5:] if name.startswith("void ") else name
    return name[:NAME_CHARS]


class DeviceTrace:
    """Profile the steps run between ``start()`` and ``stop()``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.wall_s = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._t = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self._t
        self.prof.__exit__(None, None, None)

    def _events(self) -> List[Tuple[int, int, str]]:
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            d = e.duration_ns()
            if d <= 0:
                continue
            s = e.start_ns()
            out.append((s, s + d, e.name()))
        out.sort()
        return out

    def summary(self) -> Dict:
        ev = self._events()
        by_name: Dict[str, List] = {}
        for s, e, name in ev:
            row = by_name.setdefault(short(name), [0.0, 0])
            row[0] += (e - s) * 1e-9
            row[1] += 1
        # merge the intervals; a gap is named by the operation that ended
        # the busy stretch before it and the one that starts after it
        busy_ns, gaps = 0, {}
        cur_s = cur_e = cur_last = None
        for s, e, name in ev:
            if cur_e is not None and s > cur_e:
                busy_ns += cur_e - cur_s
                key = f"{short(cur_last)[:45]} -> {short(name)[:45]}"
                gaps[key] = gaps.get(key, 0.0) + (s - cur_e) * 1e-9
                cur_s = None
            if cur_s is None:
                cur_s, cur_e, cur_last = s, e, name
            elif e > cur_e:
                cur_e, cur_last = e, name
        if cur_s is not None:
            busy_ns += cur_e - cur_s
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        return {"busy_s": busy_ns * 1e-9, "wall_s": self.wall_s,
                "events": len(ev),
                "by_name": {k: v for k, v in top},
                "device_ops": [[k, v[0]] for k, v in top[:10]],
                "idle_gaps": [[k, v] for k, v in sorted(
                    gaps.items(), key=lambda kv: -kv[1])[:10]]}
