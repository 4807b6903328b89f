"""One run of one cell: set-up, warm-up, the measured window, the trace of
a few of its steps, the check of its answers and the result's line.

The window is a closed loop of one design stream (``harness/traffic.py``):
each step solves its design, and counts once its compliance and gradient
are on the host side of a synchronise; the window ends with the first step
that ends ``seconds`` or more after it began.  ``step_s`` is the window's
wall time over its steps.  Set-up runs the stream's first
``warmup_steps`` steps, which build, load and warm every shape the window
uses; ``setup_s`` counts from the start of the process to their end.
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List

import torch

from . import check, kcache
from .spec import Cell
from .trace import DeviceTrace
from .traffic import Stream

__all__ = ["run", "FORBIDDEN", "forbidden_modules", "card_notes"]

# top-level module names the process that prints a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "pylatticedso_tpu")


def forbidden_modules() -> List[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_counters() -> Dict:
    """The host's steal time (all CPUs, s) and this process's involuntary
    context switches, read from /proc where there is one: whether the host
    took the CPU away during the window."""
    out = {}
    try:
        with open("/proc/stat") as fh:
            cpu = fh.readline().split()
        out["steal_s"] = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("nonvoluntary_ctxt_switches"):
                    out["involuntary_switches"] = int(line.split()[1])
    except (OSError, IndexError, ValueError):
        pass
    return out


def card_notes(device: torch.device) -> Dict:
    """The card's name and power limit as nvidia-smi reads them."""
    note = {"card": torch.cuda.get_device_name(device)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
        note["nvidia_smi"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        note["nvidia_smi"] = f"not read: {exc}"
    return note


class _Loop:
    """The stream's steps on the system, with what the metrics read."""

    def __init__(self, system, stream: Stream, device: torch.device):
        self.system, self.stream, self.device = system, stream, device
        self.k = 0
        self.r = stream.first()
        self.u = None
        self.state = None

    def step(self) -> Dict:
        sysm, k, stream = self.system, self.k, self.stream
        t0, cpu0 = time.perf_counter(), time.thread_time()
        refresh = None
        cold = stream.starts_run
        if sysm.has_state and (cold or stream.refresh_due()):
            self.state = None
            _sync(self.device)
            t = time.perf_counter()
            self.state = sysm.prepare(self.r)
            _sync(self.device)
            refresh = 1e3 * (time.perf_counter() - t)
        u0 = self.u if stream.warm and not cold else None
        c, g, u, iters, conv = sysm.solve(self.r, u0, self.state)
        c_host = float(c)
        _sync(self.device)
        rec = {"k": k, "r": self.r, "c": c_host, "g": g, "u": u,
               "iterations": int(iters), "converged": bool(conv),
               "refresh_ms": refresh, "cold": cold,
               "s": time.perf_counter() - t0,
               "cpu_s": time.thread_time() - cpu0}
        self.u = u
        self.r = stream.next(self.r, c_host, g)
        self.k += 1
        return rec


def _copy(rec: Dict) -> Dict:
    return {"k": rec["k"], "c": rec["c"], "r": rec["r"].clone(),
            "g": rec["g"].clone(), "u": rec["u"].clone()}


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        emit: Callable[[Dict], None]) -> Dict:
    """The result of one run; ``emit`` prints the earlier lines (notes)."""
    cfg, params = cell.config, cell.params
    sysmod = cell.system()
    if device.type == "cuda":
        emit(card_notes(device))
        built = kcache.prime(cell.root, sysmod.KERNEL_SOURCES)
        if built["built_s"]:
            emit({"kernels_built_s": built["built_s"]})
    system = sysmod.System(cfg, device)
    emit({"system_setup_s": system.setup_parts})
    stream = Stream(cell.traffic, system.points(), cfg["lattice"]["cells"],
                    seed)
    loop = _Loop(system, stream, device)
    for _ in range(cell.traffic["warmup_steps"]):
        loop.step()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    tr = DeviceTrace(device) if trace else None
    t_from, t_n = params["trace_from"], params["trace_steps"]
    tr_launch = tr_sum = None
    sample = check.Reservoir(params["samples"], seed)
    steps: List[Dict] = []
    refresh_ms: List[float] = []
    last = None
    _sync(device)
    gc_before = [g["collections"] for g in gc.get_stats()]
    host_before = _host_counters()
    t_w = time.perf_counter()
    while True:
        i = len(steps)
        if tr is not None and i == t_from:
            system.reset_counters()
            tr.start()
        rec = loop.step()
        rec["traced"] = tr is not None and t_from <= i < t_from + t_n
        if tr is not None and i == t_from + t_n - 1:
            tr.stop()
            tr_launch = system.launches()
        steps.append({k: v for k, v in rec.items()
                      if k not in ("r", "g", "u")})
        if rec["refresh_ms"] is not None:
            refresh_ms.append(rec["refresh_ms"])
        sample.offer(lambda: _copy(rec))
        last = rec
        t_end = time.perf_counter()
        done_trace = tr is None or i >= t_from + t_n - 1
        if t_end - t_w >= seconds and done_trace:
            break
    window_s = t_end - t_w
    gc_window = [g["collections"] - b
                 for g, b in zip(gc.get_stats(), gc_before)]
    host_window = {k: v - host_before[k]
                   for k, v in _host_counters().items() if k in host_before}
    n = len(steps)
    failed = sum(not s["converged"] for s in steps)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: "
                           f"{found}")

    readings = {"steps": steps, "refresh_ms": refresh_ms,
                "window_s": window_s, "setup_s": setup_s}
    if tr is not None:
        tr_sum = tr.summary()
        traced = [s for s in steps if s["traced"]]
        tr_sum["iterations"] = sum(s["iterations"] for s in traced)
        tr_sum["steps"] = len(traced)
        tr_sum["launches"] = tr_launch
        untraced = [s for s in steps if not s["traced"]]
        per_it = lambda ss: sum(s["s"] for s in ss) / max(
            sum(s["iterations"] for s in ss), 1)
        emit({"traced_steps": len(traced), "traced_launches": tr_launch,
              "traced_s_per_cg_iter": per_it(traced),
              "untraced_s_per_cg_iter": per_it(untraced) if untraced
              else None,
              "trace_slowdown": per_it(traced) / per_it(untraced)
              if untraced else None})
        readings["trace"] = tr_sum
    emit({"memory_peak_bytes": peak, "steps": n, "window_s": window_s,
          "cg_iterations": [s["iterations"] for s in steps],
          "step_seconds": [s["s"] for s in steps],
          "step_cpu_seconds": [s["cpu_s"] for s in steps],
          "host": host_window,
          "cold_steps": [s["k"] for s in steps if s["cold"]],
          "refresh_ms": refresh_ms, "gc_collections": gc_window})

    # free the program's state before the reference runs
    view = system.view()
    samples = sample.close(_copy(last))
    del loop, system, stream, last, rec
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = check.reference(cell, device)
    try:
        verdict = check.judge(ref, view, samples, params["limits"])
    except (ValueError, RuntimeError) as exc:
        print(f"check failed to run: {exc!r}", file=sys.stderr)
        verdict = {"ok": False, "checks": {
            k: {"value": float("nan"), "limit": params["limits"][k]}
            for k in check.NAMES}}
    emit({"check_s": time.perf_counter() - t_ref,
          "checked_steps": [s["k"] for s in samples]})
    readings["reference"] = cell.reference()
    readings["kind"] = torch.cuda.get_device_name(device) \
        if device.type == "cuda" else "cpu"

    # each metric's reader (metrics/<name>.py); the end-to-end ones
    # untraced, the per-layer ones traced
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = cell.reader(m["name"]).read(readings)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": readings["kind"], "count": 1, "memory_peak_bytes": peak}
    out = {"correct": verdict["ok"] and failed == 0,
           "attempted": n, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tr_sum["busy_s"]
        dev["window_s"] = tr_sum["wall_s"]
        out["breakdown"] = {"device_ops": tr_sum["device_ops"],
                            "idle_gaps": tr_sum["idle_gaps"]}
    out["checks"] = dict(verdict["checks"],
                         failed_steps={"value": failed, "limit": 0})
    return out
