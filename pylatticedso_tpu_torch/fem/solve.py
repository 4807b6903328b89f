"""Preconditioned conjugate gradient over torch tensors.

``pcg`` mirrors ``pylatticedso_tpu.fem.solve.pcg`` (standard CG, the dual
zero-rhs guard, the same update order) with a Python loop in place of
``lax.while_loop``: the convergence test runs on the host, one device sync
per iteration.  The refined and differentiable solve variants are not
ported yet (ROADMAP.md queue A, deferred feature "refined solves").
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["pcg", "PCGResult"]


class PCGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor
    converged: bool


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _norm(a):
    return torch.sqrt(_dot(a, a))


def pcg(A: Callable, b: torch.Tensor, M: Optional[Callable] = None,
        x0: Optional[torch.Tensor] = None, maxiter: int = 1000,
        tol: float = 1e-10) -> PCGResult:
    """Matrix-free PCG over tensors of any shape; stops when the recurrence
    residual norm drops to ``tol * |b|`` or after ``maxiter`` iterations."""
    if M is None:
        M = lambda r: r
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = M(r)
    p = z
    rz = _dot(r, z)
    norm_b = _norm(b)
    # a zero rhs must return x = 0 without iterating
    threshold = tol * torch.clamp_min(norm_b, torch.finfo(b.dtype).tiny)
    res = _norm(r)
    done = bool(res <= threshold)
    k = 0
    one = torch.ones((), dtype=b.dtype, device=b.device)
    while k < maxiter and not done:
        Ap = A(p)
        pAp = _dot(p, Ap)
        alpha = rz / torch.where(pAp == 0, one, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        res = _norm(r)
        k += 1
        done = bool(res <= threshold)           # the one host sync
        if done or k >= maxiter:
            break                               # z, p are not needed
        z = M(r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.where(rz == 0, one, rz)
        p = z + beta * p
        rz = rz_new
    return PCGResult(x=x, iterations=k, residual_norm=res, converged=done)
