"""The port's full-sweep twins against the JAX sweep kernels (CPU).

The FD twin (kernel #7) and the streamed-diagonal twin (kernel #6) are
held against the Pallas kernels in interpret mode with the noise off, on
a shape the JAX kernel tests accept (relative max-norm 1e-5, the
tolerance of ``tests/test_kernels.py``); with the noise on, against the
JAX ``sor_sweep`` fed b~ = b + factor sqrt(D) eta with the port's hash
draws handed over as numpy (1e-5).  Inputs are made with numpy from a
seed.  The CUDA kernel is held against these twins on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.kernels.rb_gibbs import fused_rb_gibbs_sweep as jax_sweep
from parmgmc_tpu.kernels.rb_gibbs import fused_rb_gibbs_sweep_fd as jax_sweep_fd
from parmgmc_tpu.operators.stencil import StencilOperator as JaxStencilOperator
from parmgmc_tpu.samplers.sor import sor_sweep as jax_sor_sweep
from parmgmc_tpu_torch import kernels
from parmgmc_tpu_torch.kernels import _noise, _twin
from parmgmc_tpu_torch.kernels.rb_gibbs import (
    fused_rb_gibbs_sweep,
    fused_rb_gibbs_sweep_fd,
    fused_rb_gibbs_sweep_fd_reference,
    fused_rb_gibbs_sweep_reference,
)
from parmgmc_tpu_torch.operators.stencil import link_count, star_offsets

SHAPE = (8, 10, 128)
OMEGA = 1.3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _problem(shape=SHAPE):
    """x, b, the FD parameters, the FD diagonal and a non-FD one (the FD
    diagonal times a smooth field in [1, 2], so A stays diagonally
    dominant), all float32."""
    rs = np.random.RandomState(3)
    x = rs.randn(*shape).astype(np.float32)
    b = rs.randn(*shape).astype(np.float32)
    kappa2, hinv2 = np.float32(1.7**2), np.float32((shape[0] - 1) ** 2)
    links = link_count(shape, torch.float32, "cpu").numpy()
    d_fd = kappa2 + hinv2 * links
    i, j, k = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    field = 1.5 + 0.5 * np.sin(0.7 * i + 0.3 * j) * np.cos(0.05 * k)
    d_field = (d_fd * field).astype(np.float32)
    return x, b, float(kappa2), float(hinv2), d_fd.astype(np.float32), d_field


@pytest.mark.parametrize("sweep", ["forward", "backward"])
@pytest.mark.parametrize("mode", ["fd", "streamed"])
def test_twin_matches_jax_kernel(mode, sweep):
    x, b, kappa2, hinv2, _, d_field = _problem()
    coeffs = [-hinv2] * 6
    if mode == "fd":
        want = jax_sweep_fd(
            jnp.asarray(x), jnp.asarray(b), jnp.asarray(coeffs, jnp.float32), kappa2, hinv2,
            OMEGA, 0, 0, noise_mult=0.0, sweep=sweep, interpret=True, with_noise=False,
        )
        got = fused_rb_gibbs_sweep_fd_reference(
            torch.from_numpy(x), torch.from_numpy(b), coeffs, kappa2, hinv2, OMEGA, 0, 0,
            sweep=sweep, with_noise=False,
        )
    else:
        want = jax_sweep(
            jnp.asarray(x), jnp.asarray(b), jnp.asarray(d_field), jnp.asarray(coeffs, jnp.float32),
            OMEGA, 0, 0, noise_mult=0.0, sweep=sweep, interpret=True, with_noise=False,
        )
        got = fused_rb_gibbs_sweep_reference(
            torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(d_field), coeffs, OMEGA,
            0, 0, sweep=sweep, with_noise=False,
        )
    assert got.dtype == torch.float32 and got.shape == SHAPE
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("sweep", ["forward", "backward"])
@pytest.mark.parametrize("mode", ["fd", "streamed"])
def test_noisy_twin_matches_jax_sor_sweep(mode, sweep):
    shape = (6, 8, 10)
    x, b, kappa2, hinv2, d_fd, d_field = _problem(shape)
    D = d_fd if mode == "fd" else d_field
    seed, step = 12345, 2**31 + 7
    prefix = _noise.hash_prefix(seed, step, _noise.SWEEP_DOMAIN)
    eta = _noise.eta_hash(prefix, _twin.flat_index(shape, "cpu")).numpy()
    factor = np.float32(_twin.noise_factor(OMEGA))
    btilde = b + (factor * np.sqrt(D)) * eta
    jop = JaxStencilOperator(
        offsets=star_offsets(3),
        coeffs=tuple(jnp.asarray(-hinv2, jnp.float32) for _ in range(6)),
        diag=jnp.asarray(D),
    )
    want = jax_sor_sweep(jop, jnp.asarray(btilde), jnp.asarray(x), OMEGA, sweep)
    args = (torch.from_numpy(x), torch.from_numpy(b))
    if mode == "fd":
        got = fused_rb_gibbs_sweep_fd_reference(
            *args, [-hinv2] * 6, kappa2, hinv2, OMEGA, seed, step, sweep=sweep
        )
    else:
        got = fused_rb_gibbs_sweep_reference(
            *args, torch.from_numpy(d_field), [-hinv2] * 6, OMEGA, seed, step, sweep=sweep
        )
    assert _rel(got, want) < 1e-5
    # noise_mult scales the draw: 0 is the deterministic sweep
    quiet = fused_rb_gibbs_sweep_fd_reference(
        *args, [-hinv2] * 6, kappa2, hinv2, OMEGA, seed, step, 0.0, sweep=sweep
    )
    det = fused_rb_gibbs_sweep_fd_reference(
        *args, [-hinv2] * 6, kappa2, hinv2, OMEGA, seed, step, sweep=sweep, with_noise=False
    )
    assert torch.equal(quiet, det)


def test_b_none_is_zeros_and_wrappers_run_twins_on_cpu():
    x, _, kappa2, hinv2, _, d_field = _problem((6, 8, 10))
    x, d = torch.from_numpy(x), torch.from_numpy(d_field)
    zeros = torch.zeros_like(x)
    coeffs = [-hinv2] * 6
    kernels.reset_launch_counts()
    for sweep in ("forward", "backward"):
        for noise in (True, False):
            fd = lambda bb: fused_rb_gibbs_sweep_fd(
                x, bb, coeffs, kappa2, hinv2, 1.0, 5, 6, sweep=sweep, with_noise=noise)
            st = lambda bb: fused_rb_gibbs_sweep(
                x, bb, d, coeffs, 1.0, 5, 6, sweep=sweep, with_noise=noise)
            assert torch.equal(fd(None), fd(zeros))
            assert torch.equal(st(None), st(zeros))
            assert torch.equal(fd(None), fused_rb_gibbs_sweep_fd_reference(
                x, None, coeffs, kappa2, hinv2, 1.0, 5, 6, sweep=sweep, with_noise=noise))
    assert kernels.launch_counts()["rb_gibbs_fd"] == kernels.launch_counts()["rb_gibbs"] == 0
    with pytest.raises(ValueError):
        fused_rb_gibbs_sweep_fd(x, None, coeffs, kappa2, hinv2, 1.0, 5, 6, sweep="symmetric")
    with pytest.raises(ValueError):
        fused_rb_gibbs_sweep(x, None, d[:, :, :4], coeffs, 1.0, 5, 6)
    with pytest.raises(ValueError):
        fused_rb_gibbs_sweep_fd(x[0], None, coeffs, kappa2, hinv2, 1.0, 5, 6)
