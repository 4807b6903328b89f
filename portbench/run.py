"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``.  Earlier lines of
standard output are notes (the card, the kernels' build, peak memory, the
trace's cost); the last is the result's JSON object.  The numbers compared
for ``correct`` are also the last lines of standard error.  Without a CUDA
card, or with fewer cards than the cell asks for, it exits 1 and prints no
result; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _pin_environment() -> None:
    """Caches at fixed paths inside the checkout; no program switch
    inherited from the caller's environment (the configuration states the
    route)."""
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    for key in [k for k in os.environ if k.startswith("PLDSO_")]:
        del os.environ[key]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _pin_environment()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import core, spec

    cell = spec.resolve(args.workload, ROOT)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < chips:
        print(f"cell {cell.name} needs {chips} cards; "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    emit = lambda note: print(json.dumps(note), flush=True)
    result = core.run(cell, args.seed, args.seconds, bool(args.trace),
                      device, T_START, emit)
    found = core.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
