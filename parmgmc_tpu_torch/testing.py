"""Exact sampler verification (port of ``parmgmc_tpu.testing``).

A sampler step is an affine map of the state and a tree of N(0,1) draws,
x' = G x + K eta + h.  It targets N(A^{-1} b, A^{-1}) exactly iff

    G A^{-1} b + h = A^{-1} b     and     G A^{-1} G^T + K K^T = A^{-1}.

``torch.func.jacfwd`` recovers G and K exactly, so correctness becomes a
machine-precision identity on small grids (use float64).  The LRC chain
step is held against its materialised form (:func:`lrc_chain_oracle`).
"""

from __future__ import annotations

import math

import torch

__all__ = ["transition_matrices", "invariance_error", "lrc_chain_oracle"]


def _leaves(shapes):
    if isinstance(shapes, tuple):
        return [shapes]
    if isinstance(shapes, dict):
        return [s for v in shapes.values() for s in _leaves(v)]
    return [s for v in shapes for s in _leaves(v)]


def _rebuild(shapes, chunks):
    """Tree of ``shapes`` filled from the iterator ``chunks``."""
    if isinstance(shapes, tuple):
        return next(chunks).reshape(shapes)
    if isinstance(shapes, dict):
        return {k: _rebuild(v, chunks) for k, v in shapes.items()}
    return [_rebuild(v, chunks) for v in shapes]


def transition_matrices(sampler, b):
    """(G, K, h): x' = G x + K eta + h for the fixed ``b`` (None: zero RHS)."""
    gshape = tuple(sampler.grid_shape)
    n = math.prod(gshape)
    dtype = sampler.dtype if b is None else b.dtype
    device = sampler.device
    tree = sampler.noise_shapes()
    sizes = [math.prod(s) for s in _leaves(tree)]
    ntot = sum(sizes)

    def f(xflat, zflat):
        noises = _rebuild(tree, iter(torch.split(zflat, sizes)))
        return sampler.step_with_noise(xflat.reshape(gshape), b, noises).reshape(n)

    x0 = torch.zeros(n, dtype=dtype, device=device)
    z0 = torch.zeros(ntot, dtype=dtype, device=device)
    G = torch.func.jacfwd(f, argnums=0)(x0, z0)
    K = torch.func.jacfwd(f, argnums=1)(x0, z0)
    return G, K, f(x0, z0)


def invariance_error(sampler, op, b):
    """Relative max-norm errors (mean_err, cov_err) of the N(A^{-1}b,
    A^{-1}) fixed point."""
    G, K, h = transition_matrices(sampler, b)
    A = op.to_dense()
    n = A.shape[0]
    Ainv = torch.linalg.solve(A, torch.eye(n, dtype=A.dtype, device=A.device))
    rhs = torch.zeros(n, dtype=A.dtype, device=A.device) if b is None else b.reshape(n)
    mu = Ainv @ rhs
    mean_err = torch.max(torch.abs(G @ mu + h - mu))
    cov_err = torch.max(torch.abs(G @ Ainv @ G.T + K @ K.T - Ainv))
    scale = torch.max(torch.abs(Ainv))
    return (
        float(mean_err / torch.clamp(torch.max(torch.abs(mu)), min=1e-30)),
        float(cov_err / scale),
    )


def lrc_chain_oracle(smp, key: int, x, b):
    """The state ``smp.step(key, x, b)`` should give on an LRC posterior
    (``smp._lrc_chain_eligible()``), computed the long way: the same keys
    and so the same kernel calls and draws, with b_eff = b + B wv formed
    on the grid, the Woodbury correction applied to the smoothed state
    and the coarse right-hand side restricted from the full LRC residual.
    What differs from the step is its rank-k algebra alone."""
    from parmgmc_tpu_torch.samplers import gibbs

    s, op = smp.smoothers[0], smp.fine_op
    cur = smp.keyed_words(key).cursor()
    scale = s.sqrt_sigma_inv
    w = gibbs._lowrank_draw(cur.generator(scale.device), scale, 1)[0]
    b_eff = op.b_apply(w - op.sigma_inv * op.bt_apply(x))
    if b is not None:
        b_eff = b_eff + b
    xpy, _ = smp._fused_chain_down(x, b_eff, cur)
    x_sm = xpy - s.woodbury().dense @ op.bt_apply(xpy - x)
    r = (0.0 if b is None else b) - op.apply(x_sm)
    return x_sm + smp.transfers[0].prolong(smp._cycle_keyed(1, smp.transfers[0].restrict(r), cur))
