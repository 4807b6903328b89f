"""The one launch path of the port's kernel wrappers.

Every ``extern "C"`` function of ``csrc/<source>.cu`` is listed in
``SIGNATURES`` with its parameters, one code per parameter: ``p`` a
pointer (``ctypes.c_void_p``: a pointer passed as a plain int would be cut
to 32 bits), ``i`` an int, ``f`` a float, ``d`` a double.  Every function
returns an int (a ``cudaError_t`` for a launcher).  ``functions(source)``
loads the library (building it on first use) and binds every function of
its table once; a wrapper then pays one dict lookup per launch.
``stream(index)`` is the raw handle of the current stream of CUDA device
``index``, read on every launch (a cached handle would go stale under
``with torch.cuda.stream(s)``) without building a ``torch.cuda.Stream``
object.  ``check(name, rc)`` raises on a launcher's non-zero return.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import build

__all__ = ["SIGNATURES", "functions", "stream", "check"]

SIGNATURES: Dict[str, Dict[str, str]] = {
    "stencil_matvec": {
        "stencil_matvec_f32": "pppppiiiiifffp",
        "stencil_matvec_bf16": "pppppiiiiifffp",
        "stencil_matvec_f64": "pppppiiiiidddp",
        "stencil_matvec_occupancy": "ii",
        "stencil_vjp_r2_f32": "ppppppiiiifffp",
        "stencil_vjp_r2_f64": "ppppppiiiidddp",
        "stencil_vjp_r2_occupancy": "i",
        "stencil_matvec_warped_f32": "ppppppiiiiifffp",
        "stencil_matvec_warped_f64": "ppppppiiiiidddp",
        "stencil_vjp_r2_warped_f32": "pppppppiiiifffp",
        "stencil_vjp_r2_warped_f64": "pppppppiiiidddp",
    },
    "mg_fused": {
        "mg_residual": "ii" + "p" * 8 + "iiiiifffp",
        "mg_residual_occupancy": "iii",
        "mg_cheb_run": "iii" + "p" * 9 + "ff" + "ppp" + "iiiiifffp",
        "mg_cheb_run_occupancy": "iiii",
        "mg_cheb_full": "iiii" + "p" * 10 + "i" * 12 + "pppiiiifffp",
        "mg_cheb_full_max_clusters": "iiiiiii",
    },
    "probes": {
        "probe_chain": "ppiiiip",
        "probe_chain_length": "",
        "probe_scale": "ppip",
    },
}

_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "d": ctypes.c_double}
_bound: Dict[str, Dict[str, ctypes._CFuncPtr]] = {}


def functions(source: str) -> Dict[str, ctypes._CFuncPtr]:
    """Every function of ``csrc/<source>.cu``, bound from its table."""
    fns = _bound.get(source)
    if fns is None:
        lib = build.load(source)
        fns = {}
        for name, sig in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = [_CTYPES[c] for c in sig]
            fn.restype = ctypes.c_int
            fns[name] = fn
        _bound[source] = fns
    return fns


def _no_cuda(index: int) -> int:
    raise RuntimeError("this torch has no CUDA: no stream to launch on")


# stream(index): the raw ``cudaStream_t`` of device ``index``'s current
# stream, the C function itself (the one Triton's launcher calls)
stream = getattr(torch._C, "_cuda_getCurrentRawStream", _no_cuda)


def check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
