"""ctypes bindings for the native graph-builder kernels.

The port keeps its own copy of ``dedup.cpp`` and compiles it with g++ on
first use into ``pylatticedso_tpu_torch/_build/libdedup.so`` (rebuilt when
the source is newer; written under a per-process name and moved into place,
so concurrent first uses do not read a half-written library).  Where no
compiler is available the numpy implementations below run instead: host
code with the same first-occurrence semantics, so the package stays
importable everywhere.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["dedup_rows3", "dedup_pairs", "available"]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "dedup.cpp"
_LIB_PATH = _HERE.parent / "_build" / "libdedup.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Optional[ctypes.CDLL]:
    tmp = _LIB_PATH.with_name(f"libdedup.{os.getpid()}.so")
    try:
        _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        return None
    return ctypes.CDLL(str(_LIB_PATH))


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if _LIB_PATH.exists() and \
                    _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime:
                _lib = ctypes.CDLL(str(_LIB_PATH))
            else:
                _lib = _build()
        except OSError:
            _lib = _build()
        if _lib is not None:
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(_lib, name)
                fn.restype, fn.argtypes = res, args
        return _lib


_I64, _PI, _PD = (ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                  ctypes.POINTER(ctypes.c_double))
# name -> (restype, argtypes) of every function of dedup.cpp bound here
_SIGNATURES = {
    "dedup_rows3": (_I64, [_PI, _I64, _PI, _PI]),
    "dedup_pairs": (_I64, [_PI, _PI, _I64, _PI, _PI]),
    "dedup_pairs_ordered": (_I64, [_PI, _PI, _I64, _PI, _PI]),
    "replicate_cells_multi": (None, [_PD, _PI, _I64, _PD, _PD, _I64, _PD,
                                     _PI]),
    "argsort_rows": (None, [_PI, _I64, _I64, _PI]),
    "argsort_rows_f64": (None, [_PD, _I64, _I64, _PI]),
}


def available() -> bool:
    return _load() is not None


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def dedup_rows3(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(first_idx, inverse) for int64 rows [n, 3], first-occurrence order."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    n = len(rows)
    lib = _load()
    if lib is None:  # numpy fallback (first-occurrence semantics)
        _, first, inv = np.unique(rows, axis=0, return_index=True,
                                  return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(len(first), dtype=np.int64)
        rank[order] = np.arange(len(first))
        return first[order], rank[inv]
    inverse = np.empty(n, dtype=np.int64)
    first = np.empty(n, dtype=np.int64)
    n_u = lib.dedup_rows3(_ptr(rows), ctypes.c_int64(n), _ptr(inverse), _ptr(first))
    return first[:n_u].copy(), inverse


def replicate_cells(templates, origin: np.ndarray, size: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """World endpoints + quantized int keys for every (cell, geom, beam).

    ``templates``: list of [m_g, 6] fractional beam arrays.  Output rows are
    in (cell, geometry, beam, endpoint) creation order: pts [(C*M*2), 3] and
    int keys llround(1e9 * coord).  Falls back to numpy when no compiler.
    """
    tpl = np.ascontiguousarray(np.concatenate(templates), dtype=np.float64)
    offsets = np.zeros(len(templates) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(t) for t in templates])
    origin = np.ascontiguousarray(origin, dtype=np.float64)
    size = np.ascontiguousarray(size, dtype=np.float64)
    C = len(origin)
    M = int(offsets[-1])
    lib = _load()
    if lib is None:
        P1 = origin[:, None, :] + tpl[None, :, :3] * size[:, None, :]
        P2 = origin[:, None, :] + tpl[None, :, 3:] * size[:, None, :]
        pts = np.stack([P1, P2], axis=2).reshape(-1, 3)
        return pts, np.round(pts * 1e9).astype(np.int64)
    pts = np.empty((C * M * 2, 3), dtype=np.float64)
    keys = np.empty((C * M * 2, 3), dtype=np.int64)
    lib.replicate_cells_multi(
        tpl.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _ptr(offsets), ctypes.c_int64(len(templates)),
        origin.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        size.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(C),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _ptr(keys))
    return pts, keys


def argsort_rows(rows: np.ndarray) -> np.ndarray:
    """Lexicographic argsort of rows (first column = primary key)."""
    rows = np.ascontiguousarray(rows)
    n, w = rows.shape
    lib = _load()
    if lib is None:
        return np.lexsort(tuple(rows[:, k] for k in range(w - 1, -1, -1)))
    order = np.empty(n, dtype=np.int64)
    if rows.dtype == np.float64:
        lib.argsort_rows_f64(rows.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                             ctypes.c_int64(n), ctypes.c_int64(w), _ptr(order))
    else:
        rows = np.ascontiguousarray(rows, dtype=np.int64)
        lib.argsort_rows(_ptr(rows), ctypes.c_int64(n), ctypes.c_int64(w),
                         _ptr(order))
    return order


def dedup_pairs(a: np.ndarray, b: np.ndarray, ordered: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(first_idx, inverse) for int64 pairs; unordered unless ``ordered``."""
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    n = len(a)
    lib = _load()
    if lib is None:
        key = np.stack([a, b], 1) if ordered else np.sort(np.stack([a, b], 1), axis=1)
        _, first, inv = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(len(first), dtype=np.int64)
        rank[order] = np.arange(len(first))
        return first[order], rank[inv]
    inverse = np.empty(n, dtype=np.int64)
    first = np.empty(n, dtype=np.int64)
    fn = lib.dedup_pairs_ordered if ordered else lib.dedup_pairs
    n_u = fn(_ptr(a), _ptr(b), ctypes.c_int64(n), _ptr(inverse), _ptr(first))
    return first[:n_u].copy(), inverse
