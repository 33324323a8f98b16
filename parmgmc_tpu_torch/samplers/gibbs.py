"""Stochastic SOR / Gibbs sampler on stencil operators (port of
``GibbsSampler`` in ``parmgmc_tpu.samplers.gibbs``, without the LRC
posterior parts).

One Gibbs sweep targeting N(A^{-1} b, A^{-1}) is one SOR sweep applied to
the stochastic right-hand side

    b~ = b + sqrt((2 - omega)/omega) * D^{1/2} eta,      eta ~ N(0, I).

``step_with_noise(x, b, noises)`` is the deterministic affine map given
explicit standard-normal draws -- the oracle side of the tests and the
body of the explicit-noise chains.  The keyed ``step(key, x, b)`` runs
one full-sweep kernel launch per half-sweep for 3D radius-1 star stencils
with scalar off-diagonals in float32 (the JAX ``impl="fused_fd"`` /
``"fused"`` routes): :func:`~parmgmc_tpu_torch.kernels.rb_gibbs.
fused_rb_gibbs_sweep_fd` for link-count FD operators,
:func:`~parmgmc_tpu_torch.kernels.rb_gibbs.fused_rb_gibbs_sweep` with the
diagonal streamed otherwise.  Every other operator (2D, wider stencils,
coefficient fields, float64) takes the explicit-noise step with a
``torch.Generator`` draw, as the JAX ``impl="lax"`` route does.  A
sampler records at create time what the kernels need: ``omega``, the
sweep direction, the FD parameters (kappa2, hinv2) and the scalar
off-diagonals, so a step never reads the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from parmgmc_tpu_torch import keys
from parmgmc_tpu_torch.kernels._twin import f32, noise_factor
from parmgmc_tpu_torch.kernels.rb_gibbs import fused_rb_gibbs_sweep, fused_rb_gibbs_sweep_fd
from parmgmc_tpu_torch.operators.stencil import (
    FDStencilOperator,
    StencilOperator,
    detect_fd_params,
)
from parmgmc_tpu_torch.samplers.sor import sor_sweep

__all__ = ["GibbsSampler"]

_STAR3 = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))


@dataclass(frozen=True, eq=False)
class GibbsSampler:
    """Multicolour SOR-Gibbs sampler for N(A^{-1} b, A^{-1})."""

    base: StencilOperator
    omega: float
    sweep: str  # forward | backward | symmetric
    noise_scale: "torch.Tensor | None"  # sqrt((2-omega)/omega) sqrt(diag A)
    fd_params: "tuple | None" = None  # (kappa2, hinv2) when link-count FD
    # off-diagonal scalars in the kernels' order, read once at create time
    # (a keyed step must not wait on the device to read coefficients)
    coeff6: "tuple | None" = None

    @staticmethod
    def create(op, omega: float = 1.0, sweep: str = "forward") -> "GibbsSampler":
        if sweep not in ("forward", "backward", "symmetric"):
            raise ValueError(f"unknown sweep {sweep!r}")
        if not isinstance(op, StencilOperator):
            raise NotImplementedError(
                "GibbsSampler on LRC (posterior) operators is ROADMAP.md item 12"
            )
        fd_params = coeff6 = None
        if isinstance(op, FDStencilOperator):  # scalars only, nothing on the device
            fd_params = op.fd_params()
            if op.ndim == 3:
                coeff6 = (f32(-op.hinv2),) * 6
        elif op.is_star() and op.radius == 1:
            fd_params = detect_fd_params(op)
            if set(op.offsets) == set(_STAR3) and all(c.ndim == 0 for c in op.coeffs):
                m = dict(zip(op.offsets, op.coeffs))
                coeff6 = tuple(float(m[o].to(torch.float32)) for o in _STAR3)
        # omega at the operator's precision, as the JAX sampler stores it
        om = float(torch.tensor(float(omega), dtype=op.dtype))
        if isinstance(op, FDStencilOperator):
            noise_scale = None  # made on use: the operator holds no grid
        else:
            noise_scale = noise_factor(om, op.dtype) * torch.sqrt(op.diag)
        return GibbsSampler(
            base=op, omega=om, sweep=sweep, noise_scale=noise_scale,
            fd_params=fd_params, coeff6=coeff6,
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

    def noise_shapes(self):
        """Tree of standard-normal shapes consumed by one step."""
        halves = 2 if self.sweep == "symmetric" else 1
        return [{"eta": self.grid_shape} for _ in range(halves)]

    def _half_step(self, x, b, noise, direction):
        if b is None:  # zero-RHS (prior) convention
            b = torch.zeros_like(x)
        ns = self.noise_scale
        if ns is None:
            ns = noise_factor(self.omega, x.dtype) * torch.sqrt(self.base.diag)
        btilde = b + ns * noise["eta"]
        return sor_sweep(self.base, btilde, x, self.omega, direction)

    def step_with_noise(self, x, b, noises):
        """One Gibbs iteration with explicit N(0,1) draws (deterministic)."""
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
        return self.coeff6 is not None and self.dtype == torch.float32

    def _fused_step(self, key: int, x, b):
        key, k1, k2 = keys.split(key, 3)
        # 62 bits of per-step keying; the kernel hashes (seed, step, index)
        seed, extra = keys.randint31(k1), keys.randint31(k2)
        dirs = ("forward", "backward") if self.sweep == "symmetric" else (self.sweep,)
        for i, d in enumerate(dirs):
            if self.fd_params is not None:
                x = fused_rb_gibbs_sweep_fd(
                    x, b, self.coeff6, self.fd_params[0], self.fd_params[1], self.omega,
                    seed, extra * 2 + i, sweep=d,
                )
            else:
                x = fused_rb_gibbs_sweep(
                    x, b, self.base.diag, self.coeff6, self.omega, seed, extra * 2 + i,
                    sweep=d,
                )
        return key, x

    def step(self, key: int, x, b, aux=None):
        """(key, x'): one keyed Gibbs iteration.  ``b=None`` declares a
        zero RHS (the kernels then read no b)."""
        if self.has_kernel:
            return self._fused_step(key, x, b)
        key, sub = keys.split(key)
        return key, self.step_with_noise(x, b, _draw(sub, self.noise_shapes(), x.dtype, x.device))


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
