"""A cache of the program's CUDA libraries across processes.

The program compiles its ``csrc/*.cu`` with nvcc once per process.  Every
run of a cell is a new process, so the benchmark keeps each library it
built in ``.portbench_cache/kernels/<key>/`` at the checkout's root and
hands it to the program's loader on later runs.  The key hashes every
file of the sources' directory, the build module and its nvcc flags, so a
change to any of them builds anew.  The build itself is the program's
(``kernels.build.build_all``); only its output is kept.

It hands the libraries over through the build module's private table
(``_libs`` under ``_lock``), so it refuses to run where the program no
longer has them, rather than build anew in every run unseen.  It is a
stop-gap until the program keeps its own nvcc builds across processes.
"""

from __future__ import annotations

import ctypes
import hashlib
import inspect
import os
import shutil
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["prime"]


def _key(build) -> str:
    h = hashlib.sha256()
    for p in sorted(Path(build.CSRC).iterdir()):
        if p.is_file():
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(inspect.getsource(build).encode())
    h.update(repr(build.NVCC_FLAGS).encode())
    return h.hexdigest()[:20]


def prime(root: Path, sources: Iterable[str]) -> Dict:
    """Load each of ``sources`` from the cache, or build it with the
    program's build and keep it.  Returns the build's seconds per source
    (empty when every library came from the cache)."""
    sources = list(sources)
    if not sources:
        return {"built_s": {}, "cached": []}
    from pylatticedso_tpu_torch.kernels import build

    if not (isinstance(getattr(build, "_libs", None), dict)
            and hasattr(build, "_lock")):
        raise RuntimeError(
            "pylatticedso_tpu_torch.kernels.build has no _libs/_lock: "
            "portbench/harness/kcache.py no longer fits the program's "
            "loader")
    cache = Path(root) / ".portbench_cache" / "kernels" / _key(build)
    cached, missing = [], []
    with build._lock:
        for name in sources:
            lib = cache / f"lib{name}.so"
            if name in build._libs:
                continue
            if lib.is_file():
                build._libs[name] = ctypes.CDLL(str(lib))
                cached.append(name)
            else:
                missing.append(name)
    built = {}
    if missing:
        t = time.perf_counter()
        built = build.build_all(missing)
        built["total"] = time.perf_counter() - t
        cache.mkdir(parents=True, exist_ok=True)
        for name in missing:
            tmp = cache / f"lib{name}.{os.getpid()}.so"
            shutil.copyfile(Path(build.BUILD_DIR) / f"lib{name}.so", tmp)
            os.replace(tmp, cache / f"lib{name}.so")
    return {"built_s": built, "cached": cached}
