"""Build the port's CUDA kernels with nvcc into plain-C shared libraries.

Each ``csrc/<name>.cu`` exposes an ``extern "C"`` launcher and includes no
PyTorch header, so a build takes seconds.  Libraries go to
``pylatticedso_tpu_torch/_build/`` (listed in .gitignore), are built at
first use — once per process — and are loaded with ``ctypes``.  A failed
build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "build_all", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("stencil_matvec", "mg_fused", "probes")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}          # name -> nvcc's -Xptxas -v report


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source, all nvcc processes started together, and
    load the libraries.  Returns seconds per source (wall time of its
    nvcc).  Sources already loaded in this process are skipped."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        secs, failed = {}, []
        for name, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            secs[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                              f"{err}{out}")
                continue
            build_log[name] = err + out
            final = BUILD_DIR / f"lib{name}.so"
            os.replace(tmp, final)
            _libs[name] = ctypes.CDLL(str(final))
        if failed:
            raise RuntimeError("\n".join(failed))
        return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    if name not in _libs:
        build_all([name])
    return _libs[name]
