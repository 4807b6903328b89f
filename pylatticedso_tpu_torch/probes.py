"""The counterparts of the JAX package's two TPU probe kernels, P1 and P2
(``csrc/probes.cu``).

* P1 ``chain(x, kind)`` replaces ``scripts/probe_1d_density.py``
  ``make(kind)``: on one (8, 3072) float32 block, a chain of K = 200
  dependent ``v = v * 1.0001 + 0.5``, repeated REPS = 100 times per
  launch.  Kind ``"1d"`` runs the chain on row 0 and broadcasts it to the
  8 rows, kind ``"2d"`` runs it on all 8 rows.  ``chain(x, kind, reps)``
  runs ``reps`` repeats in one launch (the measurement that separates the
  kernel's own time from the gap between launches).
* P2 ``scale(x)`` replaces the inline liveness kernel of
  ``scripts/tpu_harvest_r{5,6,7,8}.sh``: ``o = x * 2.0`` on an (8, 128)
  float32 array in one launch.

The scripts cannot be imported (they run at import, and only on a TPU), so
this module carries the arithmetic itself.  On a CPU tensor each wrapper
returns its plain torch version (each multiply and add rounded on its own,
as the kernel's ``__fmul_rn``/``__fadd_rn`` do); on a CUDA tensor it
launches its kernel or raises.  ``launches`` counts each kernel's launches.

    python -m pylatticedso_tpu_torch.probes [--device cuda|cpu]

prints what the scripts printed: ms and GFLOP/s per kind, and P2's result.
"""

from __future__ import annotations

import argparse
import functools
import time
from typing import Dict

import numpy as np
import torch

from .kernels import launch

__all__ = ["chain", "plain_chain", "scale", "plain_scale", "flops",
           "launches", "T", "K", "REPS", "ROWS", "KERNELS"]

ROWS, T = 8, 3072             # P1's block
K = 200                       # chain length (dependent multiply-adds)
REPS = 100                    # repeats per launch (the TPU grid)
SCALE_SHAPE = torch.Size((8, 128))    # P2's array
SCALE_N = 8 * 128
SOURCE = "pylatticedso_tpu_torch/csrc/probes.cu"
# (kernel name, what it replaces) by wrapper
KERNELS = {
    "chain": ("probe_chain", "scripts/probe_1d_density.py:41"),
    "scale": ("probe_scale", "scripts/tpu_harvest_r6.sh:27"),
}
launches: Dict[str, int] = {k: 0 for k in KERNELS}

_CHAIN_SHAPE = (ROWS, T)


@functools.cache
def _functions() -> Dict:
    """probes.cu's functions; the library's compiled-in chain length is
    held to K once, when this process first binds the library, not on
    every launch."""
    fns = launch.functions("probes")
    length = fns["probe_chain_length"]()
    if length != K:
        raise RuntimeError(f"probes.cu was built with chain length "
                           f"{length}, this module runs {K}")
    return fns


def _check(x: torch.Tensor, shape, what: str) -> None:
    if x.dtype != torch.float32 or x.shape != shape or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous float32 {tuple(shape)} "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")


def flops(kind: str, reps: int = REPS) -> int:
    """Operations of one P1 launch of ``reps`` repeats, counted as the
    script counts them."""
    return K * T * 2 * reps * (1 if kind == "1d" else ROWS)


def plain_chain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """P1's plain version: the chain once (every repeat gives the same
    values), each multiply and add rounded on its own."""
    v = x[0] if kind == "1d" else x
    for _ in range(K):
        v = v * 1.0001 + 0.5
    return torch.broadcast_to(v, x.shape).contiguous()


def chain(x: torch.Tensor, kind: str, reps: int = REPS) -> torch.Tensor:
    """P1: the chain on an (8, 3072) float32 block, ``reps`` (REPS) times
    per launch."""
    if kind not in ("1d", "2d"):
        raise ValueError(f"kind is '1d' or '2d', got {kind!r}")
    _check(x, _CHAIN_SHAPE, "P1")
    if x.device.type == "cpu":
        return plain_chain(x, kind)
    if not x.is_cuda:
        raise ValueError(f"P1 runs on a CPU or CUDA tensor, got {x.device}")
    fns = _functions()
    out = torch.empty_like(x)
    dev = x.get_device()
    rc = fns["probe_chain"](x.data_ptr(), out.data_ptr(), ROWS, T,
                            int(kind == "2d"), reps, launch.stream(dev))
    launch.check("probe_chain", rc)
    launches["chain"] += 1
    return out


def plain_scale(x: torch.Tensor) -> torch.Tensor:
    """P2's plain version."""
    return x * 2.0


def scale(x: torch.Tensor) -> torch.Tensor:
    """P2: x * 2.0 on an (8, 128) float32 array in one launch, through the
    launch path every wrapper shares.  The checks are ordered so that a
    valid CUDA tensor pays only attribute reads (``_check`` is called only
    to raise; ``x.device`` builds an object)."""
    if x.dtype is not torch.float32 or x.shape != SCALE_SHAPE \
            or not x.is_contiguous():
        _check(x, SCALE_SHAPE, "P2")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return plain_scale(x)
        raise ValueError(f"P2 runs on a CPU or CUDA tensor, got {x.device}")
    out = torch.empty_like(x)
    rc = launch.functions("probes")["probe_scale"](
        x.data_ptr(), out.data_ptr(), SCALE_N, launch.stream(x.get_device()))
    launch.check("probe_scale", rc)
    launches["scale"] += 1
    return out


def inputs(device) -> Dict[str, torch.Tensor]:
    """The scripts' inputs: P1's block from numpy's generator with seed 0,
    P2's array of ones."""
    x = np.random.default_rng(0).standard_normal((ROWS, T)).astype(np.float32)
    return {"chain": torch.from_numpy(x).to(device),
            "scale": torch.ones(SCALE_SHAPE, device=device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probes: torch.cuda.is_available() is False; pass "
                         "--device cpu for the plain versions")
    xs = inputs(dev)
    for kind in ("1d", "2d"):
        chain(xs["chain"], kind)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(10):
            chain(xs["chain"], kind)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) / 10
        print(f"{kind}: {dt * 1e3:.3f} ms  ({flops(kind) / dt / 1e9:.1f} "
              f"GFLOP/s) [{dev}]")
    y = scale(xs["scale"])
    ok = torch.equal(y.cpu(), plain_scale(xs["scale"]).cpu())
    print(f"probe x * 2.0: {'ok' if ok else 'MISMATCH'} [{dev}]")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
