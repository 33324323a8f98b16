"""Stochastic SOR / Gibbs sampler on stencil and low-rank-corrected
operators (port of ``GibbsSampler`` and ``build_lrc_correction`` in
``parmgmc_tpu.samplers.gibbs``).

One Gibbs sweep targeting N(A^{-1} b, A^{-1}) is one SOR sweep applied to
the stochastic right-hand side

    b~ = b + sqrt((2 - omega)/omega) * D^{1/2} eta,      eta ~ N(0, I).

On an LRC operator A + B Sigma^{-1} B^T the sweep runs on the base A with
the extra low-rank noise B w, w = sqrt(Sigma^{-1}) eta_lr, in its
right-hand side, followed by the Woodbury post-correction
x <- x - Bb (B^T x) with Bb = M^{-1} B (Sigma + B^T M^{-1} B)^{-1} built
from the sweep's own iteration operator M (:func:`build_lrc_correction`).
The keyed step feeds b + B w to the sweep kernel's b stream and applies
the rank-k correction in plain torch, on the device; the k draws of w
come from one generator seeded by the step's key (:func:`_lowrank_draw`).
The keyed step derives its integers (each launch's seed and step, each
generator's seed) in :meth:`GibbsSampler.step_words` and runs on them in
:meth:`GibbsSampler.step_from`, the form an MGMC step replayed from a
CUDA graph shares.

``step_with_noise(x, b, noises)`` is the deterministic affine map given
explicit standard-normal draws -- the oracle side of the tests and the
body of the explicit-noise chains.  The keyed ``step(key, x, b)`` runs
one full-sweep kernel call per half-sweep in float32 on 3D radius-1
stencils: for stars with scalar off-diagonals (the JAX
``impl="fused_fd"`` / ``"fused"`` routes)
:func:`~parmgmc_tpu_torch.kernels.rb_gibbs.fused_rb_gibbs_sweep_fd` for
link-count FD operators,
:func:`~parmgmc_tpu_torch.kernels.rb_gibbs.fused_rb_gibbs_sweep` with the
diagonal streamed otherwise; for 27-point stencils with scalar or field
coefficients (the linear-Galerkin levels)
:func:`~parmgmc_tpu_torch.kernels.galerkin_sweep.fused_galerkin_sweep`,
8 colours a call, its noise hashed on the device where the JAX package's
``lax`` route draws it.  Every other operator (2D, star stencils with
coefficient fields, wider stencils, float64) takes the explicit-noise
step with a ``torch.Generator`` draw, as the JAX ``impl="lax"`` route
does.  A sampler records at create time what the kernels need: ``omega``,
the sweep direction, the FD parameters (kappa2, hinv2), the scalar
off-diagonals and the 27-point kernel's colour-major fields, so a step
never reads the device.

On a :class:`~parmgmc_tpu_torch.operators.graph.GraphOperator` (an
unstructured mesh) the sweep is the operator's own colour-blocked
``sor_sweep`` (the JAX ``_op_sweep`` dispatch) and every step is the
explicit-noise step; there x may carry the chain axis, ``(n, C)``, and
the keyed step then draws every noise leaf with that trailing axis, as
the JAX ``_draw(..., batch)`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from parmgmc_tpu_torch import kernels, keys
from parmgmc_tpu_torch.kernels import galerkin_sweep
from parmgmc_tpu_torch.kernels._noise import GALERKIN_DOMAIN, SWEEP_DOMAIN
from parmgmc_tpu_torch.kernels._twin import f32, noise_factor
from parmgmc_tpu_torch.kernels.galerkin_sweep import fused_galerkin_sweep
from parmgmc_tpu_torch.kernels.rb_gibbs import fused_rb_gibbs_sweep, fused_rb_gibbs_sweep_fd
from parmgmc_tpu_torch.operators.graph import GraphOperator, bcast
from parmgmc_tpu_torch.operators.lrc import Columns, LRCOperator
from parmgmc_tpu_torch.operators.stencil import (
    FDStencilOperator,
    StencilOperator,
    detect_fd_params,
)
from parmgmc_tpu_torch.profiling import span
from parmgmc_tpu_torch.samplers.sor import sor_sweep

__all__ = ["GibbsSampler", "build_lrc_correction"]

_STAR3 = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))


def op_sweep(base, b, x, omega: float, sweep: str):
    """The multicolour SOR sweep of ``base``: a graph operator's own
    colour-blocked sweep, the parity sweep of a stencil."""
    if isinstance(base, GraphOperator):
        return base.sor_sweep(b, x, omega, sweep)
    return sor_sweep(base, b, x, omega, sweep)


def build_lrc_correction(base, B, sigma_inv, omega: float, sweep: str):
    """Bb = M^{-1} B (Sigma + B^T M^{-1} B)^{-1}, ``(*grid, k)``, for the
    sweep direction: M^{-1} B_j is one deterministic sweep from zero on
    column j, then one k x k solve."""
    k = B.shape[-1]
    C = torch.stack(
        [op_sweep(base, B[..., j], torch.zeros_like(B[..., j]), omega, sweep) for j in range(k)],
        dim=-1,
    )
    grid = list(range(B.ndim - 1))
    small = torch.diag(1.0 / sigma_inv) + torch.tensordot(B, C, dims=(grid, grid))
    Sb = torch.linalg.solve(small, torch.eye(k, dtype=B.dtype, device=B.device))
    return C @ Sb


def _lowrank_draw(g, scale, n: int):
    """(n, k) draws of w = sqrt(Sigma^{-1}) eta, eta ~ N(0, I), from the
    generator ``g`` on ``scale``'s device (``scale`` is sqrt(Sigma^{-1}),
    (k,)); nothing is read back to the host."""
    eta = torch.randn((n, scale.shape[0]), generator=g, dtype=scale.dtype, device=scale.device)
    return scale * eta


@dataclass(frozen=True, eq=False)
class GibbsSampler:
    """Multicolour SOR-Gibbs sampler for N(A^{-1} b, A^{-1}).

    On an :class:`~parmgmc_tpu_torch.operators.lrc.LRCOperator` ``lrc``
    holds the operator (with the window view of B), ``sqrt_sigma_inv``
    its sqrt(Sigma^{-1}), and ``Bb`` the Woodbury factor of each sweep
    direction in use (:meth:`woodbury`), a
    :class:`~parmgmc_tpu_torch.operators.lrc.Columns` with a window view
    of its exactly compact columns where B has one; all None on a stencil
    operator."""

    base: StencilOperator
    omega: float
    sweep: str  # forward | backward | symmetric
    noise_scale: "torch.Tensor | None"  # sqrt((2-omega)/omega) sqrt(diag A)
    fd_params: "tuple | None" = None  # (kappa2, hinv2) when link-count FD
    # off-diagonal scalars in the kernels' order, read once at create time
    # (a keyed step must not wait on the device to read coefficients)
    coeff6: "tuple | None" = None
    lrc: "LRCOperator | None" = None
    sqrt_sigma_inv: "torch.Tensor | None" = None
    Bb: "dict | None" = None  # {direction: Columns}
    # "kernel": the keyed step runs the sweep kernels where they apply;
    # "torch": always the explicit-noise step (registry.lax_variant)
    impl: str = "kernel"
    # a 27-point stencil (kernels.galerkin_sweep), and the kernel's view of
    # it (made on the card only: the twin reads the operator)
    galerkin: bool = False
    galerkin_pack: "galerkin_sweep.Pack | None" = None

    @staticmethod
    def create(op, omega: float = 1.0, sweep: str = "forward") -> "GibbsSampler":
        if sweep not in ("forward", "backward", "symmetric"):
            raise ValueError(f"unknown sweep {sweep!r}")
        lrc = op if isinstance(op, LRCOperator) else None
        base = op.base if lrc is not None else op
        if not isinstance(base, (StencilOperator, GraphOperator)):
            raise TypeError(f"GibbsSampler needs a stencil or graph operator, got {type(base).__name__}")
        fd_params = coeff6 = None  # stay None on a graph: no kernel
        if isinstance(base, FDStencilOperator):  # scalars only, nothing on the device
            fd_params = base.fd_params()
            if base.ndim == 3:
                coeff6 = (f32(-base.hinv2),) * 6
        elif isinstance(base, StencilOperator) and base.is_star() and base.radius == 1:
            fd_params = detect_fd_params(base)
            if set(base.offsets) == set(_STAR3) and all(c.ndim == 0 for c in base.coeffs):
                m = dict(zip(base.offsets, base.coeffs))
                coeff6 = tuple(float(m[o].to(torch.float32)) for o in _STAR3)
        gk = {}
        if galerkin_sweep.supported(base) and base.dtype == torch.float32:
            gk["galerkin"] = True
            if base.device.type == "cuda":
                gk["galerkin_pack"] = galerkin_sweep.pack(base)
        # omega at the operator's precision, as the JAX sampler stores it
        om = float(torch.tensor(float(omega), dtype=base.dtype))
        if isinstance(base, FDStencilOperator):
            noise_scale = None  # made on use: the operator holds no grid
        else:
            noise_scale = noise_factor(om, base.dtype) * torch.sqrt(base.diag)
        lr = {}
        if lrc is not None:
            lr["lrc"], lr["sqrt_sigma_inv"] = lrc, torch.sqrt(lrc.sigma_inv)
            # only the factors the sweep uses
            lr["Bb"] = {
                d: lrc.cols.derive(build_lrc_correction(base, lrc.B, lrc.sigma_inv, om, d))
                for d in ("forward", "backward") if sweep in (d, "symmetric")
            }
        return GibbsSampler(
            base=base, omega=om, sweep=sweep, noise_scale=noise_scale,
            fd_params=fd_params, coeff6=coeff6, **lr, **gk,
        )

    @property
    def grid_shape(self):
        return self.base.grid_shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    @property
    def is_lrc(self) -> bool:
        return self.lrc is not None

    def noise_shapes(self):
        """Tree of standard-normal shapes consumed by one step."""
        halves = 2 if self.sweep == "symmetric" else 1
        per_half = {"eta": self.grid_shape}
        if self.is_lrc:
            per_half["eta_lr"] = (self.lrc.k,)
        return [dict(per_half) for _ in range(halves)]

    def woodbury(self, direction: "str | None" = None) -> Columns:
        """The Woodbury factor Bb of the sweep ``direction``, by default the
        sampler's own (forward or backward)."""
        return self.Bb[direction or self.sweep]

    def _half_step(self, x, b, noise, direction):
        if b is None:  # zero-RHS (prior) convention
            b = torch.zeros_like(x)
        ns = self.noise_scale
        if ns is None:
            ns = noise_factor(self.omega, x.dtype) * torch.sqrt(self.base.diag)
        eta = noise["eta"]
        btilde = bcast(b, eta) + bcast(ns, eta) * eta
        if self.is_lrc:
            with span("pmg.lrc"):
                eta_lr = noise["eta_lr"]
                btilde = btilde + self.lrc.B @ (bcast(self.sqrt_sigma_inv, eta_lr) * eta_lr)
        x = op_sweep(self.base, btilde, x, self.omega, direction)
        if self.is_lrc:
            with span("pmg.lrc"):
                bty = torch.tensordot(x, self.lrc.B, dims=x.ndim) if x.ndim == self.base.ndim else self.lrc.bt_apply(x)
                x = self.woodbury(direction).sub_(bty, x)
        return x

    def step_with_noise(self, x, b, noises):
        """One Gibbs iteration with explicit N(0,1) draws (deterministic).
        ``x`` may carry trailing chain dims (the draws then carry them
        too); a stencil operator takes the chains one at a time."""
        if not isinstance(self.base, GraphOperator) and x.ndim > self.base.ndim:
            return per_chain(self.step_with_noise, x, b, noises, self.base.ndim)
        if self.sweep == "symmetric":
            x = self._half_step(x, b, noises[0], "forward")
            return self._half_step(x, b, noises[1], "backward")
        return self._half_step(x, b, noises[0], self.sweep)

    def prepare(self, b):
        return None

    def _coeff6(self) -> tuple:
        """Off-diagonal scalars ordered (-e0,+e0,-e1,+e1,-e2,+e2) as f32
        floats, the kernels' coefficient order."""
        if self.coeff6 is None:
            raise ValueError("_coeff6 needs a 3D star stencil with scalar coefficients")
        return self.coeff6

    @property
    def has_kernel(self) -> bool:
        """Does the keyed step run the sweep kernels?"""
        return (self.impl == "kernel" and (self.coeff6 is not None or self.galerkin)
                and self.dtype == torch.float32)

    @property
    def route(self) -> str:
        """The keyed step's route: the sweep kernel's wrapper, or torch."""
        if not self.has_kernel:
            return "torch"
        if self.galerkin:
            return "fused_galerkin_sweep"
        return "fused_rb_gibbs_sweep_fd" if self.fd_params is not None else "fused_rb_gibbs_sweep"

    def _dirs(self) -> tuple:
        return ("forward", "backward") if self.sweep == "symmetric" else (self.sweep,)

    def step_words(self, key: int, words) -> int:
        """Append to ``words`` (a :class:`~parmgmc_tpu_torch.keys.Words`) the
        integers the keyed step under ``key`` hands the device, and return
        the next key: on the kernel route the low-rank draw's seed (LRC)
        and each half-sweep's launch, 62 bits of per-step keying (the kernel
        hashes (seed, step, index)); the plain route draws from its key on
        the host (``Words.defer``)."""
        if not self.has_kernel:
            words.defer(key)
            return keys.split(key)[0]
        key, seed, extra = keys.draw_pair(key)
        if self.is_lrc:
            key, klr = keys.split(key)
            words.seed(klr)
        domain = GALERKIN_DOMAIN if self.galerkin else SWEEP_DOMAIN
        for i in range(len(self._dirs())):
            words.launch(seed, extra * 2 + i, (domain,))
        return key

    def step_from(self, cur, x, b):
        """x': the keyed step on the words of :meth:`step_words`, read
        through the cursor ``cur``."""
        if self.has_kernel:
            return self._fused_step(cur, x, b)
        return self._plain_step(cur.key(), x, b)[1]

    def _plain_step(self, key: int, x, b):
        key, sub = keys.split(key)
        shapes = with_batch(self.noise_shapes(), x.shape[len(self.grid_shape):])
        return key, self.step_with_noise(x, b, _draw(sub, shapes, x.dtype, x.device))

    def _fused_step(self, cur, x, b):
        dirs = self._dirs()
        if self.is_lrc:
            # per half-sweep the low-rank noise rides the kernel's b stream,
            # b_eff = b + B w, and the Woodbury correction follows the sweep
            with span("pmg.lrc"):
                scale = self.sqrt_sigma_inv
                w_all = _lowrank_draw(cur.generator(scale.device), scale, len(dirs))
                if b is None:  # the low-rank noise still needs a b stream
                    b = torch.zeros_like(x)
        for i, d in enumerate(dirs):
            seed, step, at = cur.launch()
            b_eff = b
            if self.is_lrc:
                with span("pmg.lrc"):
                    b_eff = self.lrc.b_apply_add(w_all[i], b)
            if self.galerkin:
                with span("pmg.galerkin.sweep"):
                    x = fused_galerkin_sweep(
                        x, b_eff, self.base, self.omega, seed, step, sweep=d,
                        **kernels.given(prefix_at=at, packed=self.galerkin_pack),
                    )
            elif self.fd_params is not None:
                x = fused_rb_gibbs_sweep_fd(
                    x, b_eff, self.coeff6, self.fd_params[0], self.fd_params[1], self.omega,
                    seed, step, sweep=d, **kernels.given(prefix_at=at),
                )
            else:
                x = fused_rb_gibbs_sweep(
                    x, b_eff, self.base.diag, self.coeff6, self.omega, seed, step,
                    sweep=d, **kernels.given(prefix_at=at),
                )
            if self.is_lrc:
                with span("pmg.lrc"):
                    x = self.woodbury(d).sub_(self.lrc.bt_apply(x), x)
        return x

    def step(self, key: int, x, b, aux=None):
        """(key, x'): one keyed Gibbs iteration (:meth:`step_words`, then
        :meth:`step_from`).  ``b=None`` declares a zero RHS (the kernels
        then read no b).  ``x`` may carry trailing chain dims on the plain
        route; a kernel sampler refuses them."""
        if not self.has_kernel:
            return self._plain_step(key, x, b)
        refuse_batch(self, x.shape[len(self.grid_shape):])
        words = keys.Words()
        key = self.step_words(key, words)
        return key, self._fused_step(words.cursor(), x, b)


def refuse_batch(sampler, batch) -> None:
    """Raise when a kernel sampler's keyed step is given trailing chain
    dims: its kernels take one chain, and it never switches to the plain
    route unasked (as the JAX package's Pallas samplers do not vmap)."""
    if batch:
        raise ValueError(
            f"{type(sampler).__name__}'s keyed step runs CUDA kernels on one chain (x of shape "
            f"grid_shape), not on trailing chain dims {tuple(batch)}: take "
            "samplers.registry.lax_variant(sampler) for the plain-torch route, or run the "
            "chains one at a time (chain.multi_chain)")


def per_chain(fn, x, b, noises, ndim: int):
    """``fn(x, b, noises)`` on each chain of the trailing chain dims of
    ``x`` (and of ``b`` and every draw, where they carry them), stacked
    back: the stencil operators take one chain."""
    batch = tuple(x.shape[ndim:])
    C = math.prod(batch)

    def chain(t, c):  # every draw and x carry the chain dims; b may not
        return t.reshape(*t.shape[: t.ndim - len(batch)], C)[..., c]

    def tree(t, c):
        if isinstance(t, dict):
            return {k: tree(v, c) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [tree(v, c) for v in t]
        return chain(t, c)

    def rhs(c):
        return b if b is None or b.ndim == ndim else chain(b, c)

    out = [fn(chain(x, c), rhs(c), tree(noises, c)) for c in range(C)]
    return torch.stack(out, dim=-1).reshape(x.shape)


def with_batch(shapes, batch):
    """The shape tree with the trailing chain dims ``batch`` of the
    chain-major layout appended to every leaf (the JAX ``_draw(...,
    batch)``): each chain gets its own draws."""
    batch = tuple(batch)
    if not batch:
        return shapes
    if isinstance(shapes, tuple):
        return shapes + batch
    if isinstance(shapes, dict):
        return {k: with_batch(v, batch) for k, v in shapes.items()}
    return [with_batch(v, batch) for v in shapes]


def _draw(key: int, shapes, dtype, device):
    """Draw N(0,1) trees for the given shape tree (dicts, lists and shape
    tuples) from one generator seeded by ``key``, leaves in tree order."""
    g = keys.generator(key, device)

    def draw(s):
        if isinstance(s, tuple):
            return torch.randn(s, generator=g, dtype=dtype, device=device)
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return [draw(v) for v in s]

    return draw(shapes)
