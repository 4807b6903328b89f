"""Preconditioned conjugate gradient over torch tensors, and the
differentiable linear solves built on it.

``pcg`` mirrors ``pylatticedso_tpu.fem.solve.pcg`` (standard CG, the dual
zero-rhs guard, the reference solver's optional ``alpha_max`` step clamp,
restart period, ``mintol`` direction-collapse test, residual history and
the flexible beta, with the same update order and defaults) with a Python
loop in place of ``lax.while_loop``: the convergence test runs on the host,
one device sync per iteration.

``custom_linear_solve(A, b, solve_fn)`` is the counterpart of
``jax.lax.custom_linear_solve(A, b, solve_fn, symmetric=True)``: the forward
solve runs ``solve_fn(A, b)`` with no autograd graph, and the backward runs
ONE adjoint solve ``solve_fn(A, x_bar)`` (A is symmetric) and hands its
result to autograd of ``A(x) - b`` at the solution, which gives the
cotangent of everything that enters ``A`` or ``b``.  ``linear_solve`` and
the refined solves are built on it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["pcg", "PCGResult", "custom_linear_solve", "linear_solve",
           "pcg_refined", "linear_solve_refined", "refined_solve",
           "linear_solve_dense_refined"]


class PCGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor
    converged: bool
    residual_history: Optional[torch.Tensor] = None  # [maxiter], -1 unused


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _norm(a):
    return torch.sqrt(_dot(a, a))


def pcg(A: Callable, b: torch.Tensor, M: Optional[Callable] = None,
        x0: Optional[torch.Tensor] = None, maxiter: int = 1000,
        tol: float = 1e-10, mintol: float = 0.0,
        alpha_max: Optional[float] = None, restart_every: int = 0,
        track_history: bool = False, flexible: bool = False, *,
        ops=None) -> PCGResult:
    """Matrix-free PCG over tensors of any shape; stops when the recurrence
    residual norm drops to ``tol * |b|``, when (``mintol`` > 0) the search
    direction collapses below ``mintol * |x|``, or after ``maxiter``
    iterations.  ``alpha_max`` clamps the step, ``restart_every`` resets
    the direction to the preconditioned residual every that many
    iterations, ``flexible`` takes the Polak-Ribiere beta, and
    ``track_history`` records each iteration's residual norm.

    ``ops`` (internal; callers pass none) holds the dot product and norm
    of vectors held in parts: ``parallel.mesh.OPS`` for a
    ``parallel.mesh.Sharded`` field, per-shard partials reduced in rank
    order.  None: ``_dot`` and ``_norm``."""
    _dot_, _norm_ = (_dot, _norm) if ops is None else (ops.dot, ops.norm)
    if M is None:
        M = lambda r: r
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = M(r)
    p = z
    rz = _dot_(r, z)
    norm_b = _norm_(b)
    # a zero rhs must return x = 0 without iterating
    threshold = tol * torch.clamp_min(norm_b, torch.finfo(b.dtype).tiny)
    hist = torch.full((maxiter,), -1.0, dtype=b.dtype, device=b.device) \
        if track_history else None
    res = _norm_(r)
    done = bool(res <= threshold)
    k = 0
    one = torch.ones_like(norm_b)
    while k < maxiter and not done:
        Ap = A(p)
        pAp = _dot_(p, Ap)
        alpha = rz / torch.where(pAp == 0, one, pAp)
        if alpha_max is not None:
            alpha = torch.clamp_max(alpha, alpha_max)
        x = x + alpha * p
        r_old = r
        r = r - alpha * Ap
        res = _norm_(r)
        if hist is not None:
            hist[k] = res
        stop = res <= threshold
        if mintol > 0:
            stop = stop | (_norm_(p) < mintol * (_norm_(x) + 1e-12))
        k += 1
        done = bool(stop)                       # the one host sync
        if done or k >= maxiter:
            break                               # z, p are not needed
        z = M(r)
        rz_new = _dot_(r, z)
        num = _dot_(z, r - r_old) if flexible else rz_new
        beta = num / torch.where(rz == 0, one, rz)
        p = z if restart_every > 0 and k % restart_every == 0 \
            else z + beta * p
        rz = rz_new
    return PCGResult(x=x, iterations=k, residual_norm=res, converged=done,
                     residual_history=hist)


# ------------------------------------------------------- implicit solves
class _ImplicitSolve(torch.autograd.Function):
    """Identity on the solution ``x``; its backward maps the cotangent
    x_bar to -A^-1 x_bar on the residual ``A(x) - b``, by one call of the
    solver.  Autograd of the residual then gives the cotangents of A's
    parameters (-lambda^T dA(x)) and of b (lambda)."""

    @staticmethod
    def forward(ctx, residual, x, A, solve_fn):
        ctx.A, ctx.solve_fn = A, solve_fn
        return x.clone()

    @staticmethod
    def backward(ctx, x_bar):
        with torch.no_grad():
            lam = ctx.solve_fn(ctx.A, x_bar.contiguous())
        return -lam, None, None, None


def custom_linear_solve(A: Callable, b: torch.Tensor,
                        solve_fn: Callable) -> torch.Tensor:
    """x = A^-1 b for a symmetric ``A``, differentiable in everything that
    enters ``A`` or ``b`` (``jax.lax.custom_linear_solve(...,
    symmetric=True)``).  ``solve_fn(A, rhs)`` serves the forward and the
    adjoint solve alike, so a warm start it closes over starts both."""
    with torch.no_grad():
        x = solve_fn(A, b)
    if not torch.is_grad_enabled():
        return x
    residual = A(x) - b                  # graph through A's inputs and b
    if not residual.requires_grad:
        return x
    return _ImplicitSolve.apply(residual, x, A, solve_fn)


def linear_solve(A: Callable, b: torch.Tensor, M: Optional[Callable] = None,
                 x0: Optional[torch.Tensor] = None, maxiter: int = 2000,
                 tol: float = 1e-12, alpha_max: Optional[float] = None,
                 restart_every: int = 0, scale_x0: bool = False):
    """Differentiable SPD solve: ``custom_linear_solve`` with CG forward
    and adjoint.  ``scale_x0=True`` starts each solve at the A-norm-optimal
    multiple of ``x0`` (one extra matvec), so one warm-start guess serves
    the forward solve and the adjoint solve alike."""

    def solve_fn(matvec, rhs):
        guess = x0
        if x0 is not None and scale_x0:
            Ag = matvec(x0)
            den = _dot(x0, Ag)
            alpha = _dot(rhs, x0) / torch.where(den == 0, 1.0, den)
            guess = torch.where(den == 0, 0.0, alpha) * x0
        return pcg(matvec, rhs, M=M, x0=guess, maxiter=maxiter, tol=tol,
                   alpha_max=alpha_max, restart_every=restart_every).x

    return custom_linear_solve(A, b, solve_fn)


# ------------------------------------------------------ refined solves
def pcg_refined(A: Callable, b: torch.Tensor, M: Optional[Callable] = None,
                maxiter: int = 1000, tol: float = 1e-6,
                refinements: int = 2,
                residual_fn: Optional[Callable] = None) -> PCGResult:
    """Iterative-refinement PCG: solve loosely, recompute the residual
    (``residual_fn(x) -> b - A x`` in a higher precision when given),
    solve the correction, ``refinements`` times.  The solution accumulates
    in the residual's precision."""
    out = pcg(A, b, M=M, maxiter=maxiter, tol=tol)
    iters = out.iterations
    hi = residual_fn(out.x).dtype if residual_fn is not None else b.dtype
    x = out.x.to(hi)
    for _ in range(refinements):
        r = residual_fn(x) if residual_fn is not None else b - A(x)
        corr = pcg(A, r.to(b.dtype), M=M, maxiter=maxiter, tol=tol)
        x = x + corr.x.to(hi)
        iters = iters + corr.iterations
    r = residual_fn(x) if residual_fn is not None else b - A(x)
    res = _norm(r)
    nb = _norm(b.to(res.dtype))
    return PCGResult(x=x, iterations=iters, residual_norm=res.to(b.dtype),
                     converged=bool(res <= tol * nb))


def refined_solve(A_lo: Callable, A_hi: Callable, b_hi: torch.Tensor,
                  M: Optional[Callable] = None, maxiter: int = 2000,
                  tol: float = 1e-9, inner_tol: float = 1e-4,
                  max_refinements: int = 12, lo_dtype=torch.float32,
                  restart_every: int = 0,
                  x0: Optional[torch.Tensor] = None) -> PCGResult:
    """Adaptive iterative refinement (not differentiable): low-precision
    inner CG (``A_lo`` in ``lo_dtype``) and high-precision residual passes
    (``A_hi``) until ``|b - A x| <= tol |b|`` or ``max_refinements``
    passes.  ``x`` comes back in ``b_hi``'s dtype and ``iterations``
    counts every inner CG iteration."""
    if M is None:
        M = lambda r: r
    hi_dt = b_hi.dtype
    nb = _norm(b_hi)
    threshold = tol * torch.clamp_min(nb, torch.finfo(hi_dt).tiny)

    def inner(r_hi, g0):
        r_lo = r_hi.to(lo_dtype)
        guess = None
        if g0 is not None:
            # A-norm-optimal step along the guess direction: handles scale
            # and sign, so one guess serves the forward and adjoint solves
            Ag = A_lo(g0)
            den = _dot(g0, Ag)
            alpha = _dot(r_lo, g0) / torch.where(den == 0, 1.0, den)
            guess = torch.where(den == 0, 0.0, alpha) * g0
        out = pcg(A_lo, r_lo, M=M, maxiter=maxiter, tol=inner_tol, x0=guess,
                  restart_every=restart_every)
        return out.x.to(hi_dt), out.iterations

    g0 = None if x0 is None else x0.to(lo_dtype)
    x, iters = inner(b_hi, g0)
    r = b_hi - A_hi(x)
    res = _norm(r)
    k = 0
    while k < max_refinements and bool(res > threshold):
        dx, dit = inner(r, None)
        x = x + dx
        r = b_hi - A_hi(x)
        res = _norm(r)
        k += 1
        iters += dit
    return PCGResult(x=x, iterations=iters, residual_norm=res,
                     converged=bool(res <= threshold))


def linear_solve_refined(A_lo: Callable, b: torch.Tensor, A_hi: Callable,
                         M: Optional[Callable] = None, maxiter: int = 2000,
                         tol: float = 1e-9, inner_tol: float = 1e-4,
                         max_refinements: int = 12, lo_dtype=torch.float32,
                         restart_every: int = 0,
                         x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable refined SPD solve: ``refined_solve`` forward and
    adjoint, gradients through ``A_hi``'s inputs and ``b``.  The solution
    is in ``b``'s (high) precision."""

    def solve_fn(mv_hi, rhs):
        return refined_solve(A_lo, mv_hi, rhs, M=M, maxiter=maxiter,
                             tol=tol, inner_tol=inner_tol,
                             max_refinements=max_refinements,
                             lo_dtype=lo_dtype, restart_every=restart_every,
                             x0=x0).x

    return custom_linear_solve(A_hi, b, solve_fn)


def linear_solve_dense_refined(apply_inv: Callable, b: torch.Tensor,
                               A_hi: Callable, tol: float = 1e-9,
                               max_refinements: int = 40,
                               x0: Optional[torch.Tensor] = None):
    """Differentiable mixed-precision dense solve: ``apply_inv(r)`` applies
    a low-precision factorization, ``A_hi`` recomputes residuals in high
    precision; refinement passes until ``|b - A x| <= tol |b|`` or
    ``max_refinements``.  Gradients through ``A_hi``'s inputs and ``b``;
    the adjoint solve reuses the same factor."""

    def solve_fn(mv_hi, rhs):
        hi = rhs.dtype
        threshold = tol * torch.clamp_min(_norm(rhs), torch.finfo(hi).tiny)
        x = torch.zeros_like(rhs) if x0 is None else x0.to(hi)
        r = rhs - mv_hi(x)
        res = _norm(r)
        k = 0
        while k < max_refinements and bool(res > threshold):
            x = x + apply_inv(r).to(hi)
            r = rhs - mv_hi(x)
            res = _norm(r)
            k += 1
        return x

    return custom_linear_solve(A_hi, b, solve_fn)
