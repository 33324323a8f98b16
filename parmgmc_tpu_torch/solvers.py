"""Deterministic solvers around the multicolour SOR sweep (port of
``parmgmc_tpu.solvers``; the reference's ex3 drives its MCSOR as a
preconditioner of Richardson and FGMRES).

* :func:`richardson_solve` -- x_{k+1} = x_k + M^{-1}(b - A x_k), the
  (multicolour SOR / SSOR) sweep from zero as M^{-1},
* :func:`cg_solve` -- preconditioned CG with the symmetric sweep,
* :func:`gmres_solve` -- left-preconditioned restarted GMRES with any
  sweep.

Torch has no CG or GMRES, so :func:`cg` and :func:`gmres` follow the
semantics of ``jax.scipy.sparse.linalg.cg`` and ``gmres`` (JAX 0.9.0,
``solve_method="batched"``) step for step; see each docstring.  The
sweeps are plain torch (``samplers.gibbs.op_sweep``), as the JAX
package's lax sweep is: no kernel runs here.  Operators may be stencil,
graph or LRC operators (an LRC operator is preconditioned by the sweep of
its base).  The loops read one norm a step to the host to decide whether
to stop.
"""

from __future__ import annotations

import torch

from parmgmc_tpu_torch.operators.lrc import LRCOperator
from parmgmc_tpu_torch.samplers.gibbs import op_sweep

__all__ = ["sor_preconditioner", "richardson_solve", "cg_solve", "gmres_solve", "cg", "gmres"]


def _base_of(op):
    return op.base if isinstance(op, LRCOperator) else op


def sor_preconditioner(op, omega: float = 1.0, sweep: str = "symmetric"):
    """M^{-1} r: one deterministic sweep of the base operator from zero."""

    def apply(r):
        return op_sweep(_base_of(op), r, torch.zeros_like(r), omega, sweep)

    return apply


def richardson_solve(op, b, x0=None, maxiter: int = 100, omega: float = 1.0, sweep: str = "forward"):
    """Preconditioned Richardson iteration: (x, residual 2-norms after each
    of the ``maxiter`` iterations)."""
    M = sor_preconditioner(op, omega, sweep)
    x = torch.zeros_like(b) if x0 is None else x0
    res = []
    for _ in range(maxiter):
        x = x + M(b - op.apply(x))
        res.append(torch.linalg.vector_norm(b - op.apply(x)))
    return x, torch.stack(res) if res else b.new_zeros((0,))


def _dot(a, b):
    return torch.sum(a * b)


def cg(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0, maxiter=None, M=None):
    """(x, iterations): conjugate gradients for A x = b from ``x0`` (zero
    when None), preconditioned by ``M``.  As JAX's ``cg``: it stops when
    |r|^2 <= max(tol^2 |b|^2, atol^2), r the recursively updated,
    unpreconditioned residual, or after ``maxiter`` iterations (10 times
    the size of b when None)."""
    precond = M is not None
    M = M or (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    if maxiter is None:
        maxiter = 10 * b.numel()
    stop = max(tol**2 * float(_dot(b, b)), atol**2)
    r = b - A(x)
    p = z = M(r)
    gamma = _dot(r, z)
    k = 0
    # without M, gamma = |r|^2 already (JAX reads it instead of a new dot)
    while k < maxiter and float(_dot(r, r) if precond else gamma) > stop:
        Ap = A(p)
        alpha = gamma / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_new = _dot(r, z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x, k


def _safe_normalize(v, thresh=None):
    """(v / |v|, |v|), or (0, 0) when |v| <= thresh (the dtype's eps by
    default), as JAX's ``_safe_normalize``."""
    norm = torch.linalg.vector_norm(v)
    if thresh is None:
        thresh = torch.finfo(v.dtype).eps
    if float(norm) > float(thresh):
        return v / norm, norm
    return torch.zeros_like(v), torch.zeros_like(norm)


def gmres(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0, restart: int = 20, maxiter=None, M=None):
    """(x, restarts): restarted GMRES for A x = b, left-preconditioned by
    ``M``, as JAX's ``gmres`` with ``solve_method="batched"``:

    * every restart builds the Krylov basis of M A from the unit
      preconditioned residual by up to ``restart`` Arnoldi steps (each new
      vector M(A v), one classical Gram-Schmidt pass), stopping early
      only at a breakdown, then solves the (restart + 1) x restart least
      squares problem from scratch through its normal equations;
    * ``maxiter`` counts restarts (10 times the size of b when None), and
      ``restart`` is at most the size of b;
    * it stops when |M(b - A x)| <= max(tol |b|, atol): a preconditioned
      norm against an unpreconditioned bound, as in JAX."""
    M = M or (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    n = b.numel()
    if maxiter is None:
        maxiter = 10 * n
    restart = min(restart, n)
    bound = max(tol * float(torch.linalg.vector_norm(b)), atol)
    eps = torch.finfo(b.dtype).eps
    unit, rnorm = _safe_normalize(M(b - A(x)))
    k = 0
    while k < maxiter and float(rnorm) > bound:
        V = b.new_zeros((restart + 1, n))
        V[0] = unit.reshape(-1)
        H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
        for j in range(restart):
            v = M(A(V[j].reshape(b.shape))).reshape(-1)
            _, v_norm_0 = _safe_normalize(v)
            h = V @ v
            v = v - V.T @ h
            unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
            V[j + 1] = unit_v
            h[j + 1] = v_norm_1
            H[j] = h
            if float(v_norm_1) == 0.0:
                break
        beta = b.new_zeros(restart + 1)
        beta[0] = rnorm
        HHt = H @ H.T
        y = torch.cholesky_solve((H @ beta)[:, None], torch.linalg.cholesky(HHt))[:, 0]
        x = x + (V[:-1].T @ y).reshape(b.shape)
        unit, rnorm = _safe_normalize(M(b - A(x)))
        k += 1
    return x, k


def cg_solve(op, b, tol: float = 1e-10, maxiter: int = 1000, omega: float = 1.0):
    """Preconditioned CG with the symmetric sweep as M^{-1} (ex3's Krylov
    mode): the solution x."""
    return cg(op.apply, b, tol=tol, maxiter=maxiter, M=sor_preconditioner(op, omega, "symmetric"))[0]


def gmres_solve(op, b, tol: float = 1e-10, maxiter: int = 1000, restart: int = 30, omega: float = 1.0,
                sweep: str = "forward"):
    """Preconditioned GMRES with a (possibly nonsymmetric) sweep as M^{-1},
    the FGMRES half of ex3: the solution x."""
    return gmres(op.apply, b, tol=tol, maxiter=maxiter, restart=restart,
                 M=sor_preconditioner(op, omega, sweep))[0]
