"""The port's squared prior and patch-Gibbs sampler against JAX (CPU).

* ``squared_shifted_laplace_fd`` and ``compress_stencil`` against the JAX
  package's, and the squared operator against A_F @ A_F (float64).
* ``detect_squared_fd`` recovers (kappa2, hinv2) and refuses a plain FD
  operator.
* ``PatchGibbsSampler.step_with_noise`` against the JAX sampler's with
  the same explicit draws (float64, 1e-10), and its exact invariance.
* The patch-sweep twin (kernels #10 and #11 on CPU tensors) with the
  noise off against the Pallas kernels in interpret mode and against the
  JAX plain sweep with zero draws; with the noise on, against the JAX
  plain sweep fed the port's hash draws (float32, 1e-4 relative
  max-norm, the tolerance of ``tests/test_patch_fused.py``).

Inputs are made with numpy from a seed; each JAX oracle is computed once
per module.  The CUDA kernels are held against the twin on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.kernels.patch_sweep import (
    fused_patch_sweep_sqfd as jax_patch_sweep,
    fused_patch_sweep_sqfd_streamed as jax_patch_sweep_streamed,
)
from parmgmc_tpu.models.problems import squared_shifted_laplace_fd as jax_squared
from parmgmc_tpu.operators.stencil import StencilOperator as JaxStencilOperator
from parmgmc_tpu.operators.stencil import compress_stencil as jax_compress_stencil
from parmgmc_tpu.operators.stencil import shifted_laplace_fd as jax_shifted_laplace_fd
from parmgmc_tpu.samplers.patch_gibbs import PatchGibbsSampler as JaxPatchGibbsSampler
from parmgmc_tpu.samplers.patch_gibbs import detect_squared_fd as jax_detect_squared_fd
from parmgmc_tpu_torch import convert, kernels
from parmgmc_tpu_torch.kernels import _noise, _twin
from parmgmc_tpu_torch.kernels.patch_sweep import (
    fused_patch_sweep_sqfd,
    fused_patch_sweep_sqfd_reference,
    fused_patch_sweep_sqfd_streamed,
    patch_prefixes,
    patch_sweep_resident,
)
from parmgmc_tpu_torch.models.problems import squared_shifted_laplace_fd
from parmgmc_tpu_torch.operators.stencil import (
    StencilOperator,
    compress_stencil,
    shifted_laplace_fd,
)
from parmgmc_tpu_torch.samplers.patch_gibbs import PatchGibbsSampler, detect_squared_fd
from parmgmc_tpu_torch.testing import invariance_error

# the entry points default to the card; these tests run on the host
DEV = "cpu"
F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    return rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(7, 6), (7, 6, 5)])
def test_squared_operator_matches_jax(shape):
    want = jax_squared(shape, 1.3, dtype=jnp.float64)
    got = squared_shifted_laplace_fd(shape, 1.3, dtype=F64, device=DEV)
    assert got.offsets == want.offsets and got.radius == 2
    for g, w in zip(got.coeffs, want.coeffs):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15, atol=0)
    np.testing.assert_allclose(got.diag.numpy(), np.asarray(want.diag), rtol=1e-15, atol=0)
    # the 2d unit offsets stay fields, every radius-2 offset is a scalar
    assert all((c.ndim > 0) == (sum(map(abs, o)) == 1) for o, c in zip(got.offsets, got.coeffs))
    AF = shifted_laplace_fd(shape, 1.3, dtype=F64, device=DEV).to_dense()
    np.testing.assert_allclose(got.to_dense().numpy(), (AF @ AF).numpy(), rtol=0, atol=1e-8)


def test_compress_stencil_matches_jax():
    shape = (5, 6)
    rs = np.random.RandomState(4)
    const = np.full(shape, 2.5)
    const[0, :] = 7.0  # rows whose (-1, 0) neighbour is missing do not count
    coeffs = [const, np.zeros(shape), rs.rand(*shape), np.asarray(-1.5)]
    offsets = ((-1, 0), (1, 0), (0, 1), (0, -1))
    diag = 10.0 + rs.rand(*shape)
    want = jax_compress_stencil(JaxStencilOperator(
        offsets=offsets, coeffs=tuple(jnp.asarray(c) for c in coeffs), diag=jnp.asarray(diag)
    ))
    got = compress_stencil(convert.stencil_operator(offsets, coeffs, diag, DEV))
    assert got.offsets == want.offsets == ((-1, 0), (0, 1), (0, -1))
    for g, w in zip(got.coeffs, want.coeffs):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_detect_squared_fd():
    grid = (16, 10, 128)
    op = squared_shifted_laplace_fd(grid, 1.3, device=DEV)
    p = detect_squared_fd(op)
    assert p is not None
    want = jax_detect_squared_fd(jax_squared(grid, 1.3, dtype=jnp.float32))
    assert p == tuple(float(v) for v in np.asarray(want))
    assert abs(p[0] - 1.3**2) < 1e-3 * 1.69 and abs(p[1] - 15.0**2) < 1e-2 * 225
    assert detect_squared_fd(shifted_laplace_fd(grid, 1.0, device=DEV)) is None
    # float64 and 2D operators take the explicit-noise step
    assert PatchGibbsSampler.create(op).sq_fd_params == p
    assert PatchGibbsSampler.create(
        squared_shifted_laplace_fd(grid, 1.3, dtype=F64, device=DEV)
    ).sq_fd_params is None
    assert PatchGibbsSampler.create(squared_shifted_laplace_fd((9, 8), 1.3, device=DEV)).sq_fd_params is None


_EXPLICIT_CASES = {
    "squared_2d": lambda: jax_squared((9, 8), 1.3, dtype=jnp.float64),
    "squared_3d": lambda: jax_squared((7, 6, 5), 1.3, dtype=jnp.float64),
    "plain_3d": lambda: jax_shifted_laplace_fd((6, 7, 5), 2.0, dtype=jnp.float64),
}


@pytest.mark.parametrize("case", list(_EXPLICIT_CASES))
def test_step_with_noise_matches_jax(case):
    jop = _EXPLICIT_CASES[case]()
    jsmp = JaxPatchGibbsSampler.create(jop, impl="lax")
    smp = convert.patch_gibbs_sampler(
        jop.offsets, [np.asarray(c) for c in jop.coeffs], np.asarray(jop.diag), None, DEV
    )
    assert smp.patch_offsets == jsmp.patch_offsets and smp.ncolor_base == jsmp.ncolor_base
    assert smp.noise_shapes() == jsmp.noise_shapes()
    rs = np.random.RandomState(5)
    shape = tuple(jop.grid_shape)
    x, b = rs.randn(*shape), rs.randn(*shape)
    eta = rs.randn(*smp.noise_shapes()[0]["eta"])
    want = jsmp.step_with_noise(jnp.asarray(x), jnp.asarray(b), [{"eta": jnp.asarray(eta)}])
    got = smp.step_with_noise(torch.from_numpy(x), torch.from_numpy(b), [{"eta": torch.from_numpy(eta)}])
    assert got.dtype == F64
    assert _rel(got, want) < 1e-10
    # b = None is the zero RHS
    want0 = jsmp.step_with_noise(jnp.asarray(x), None, [{"eta": jnp.asarray(eta)}])
    got0 = smp.step_with_noise(torch.from_numpy(x), None, [{"eta": torch.from_numpy(eta)}])
    assert _rel(got0, want0) < 1e-10


def _jax_kernel_out(kind, with_b):
    """The Pallas kernel in interpret mode, noise off."""
    shape = (16, 10, 128) if kind == "resident" else (16, 16, 128)
    fn = jax_patch_sweep if kind == "resident" else jax_patch_sweep_streamed
    p = jax_detect_squared_fd(jax_squared(shape, 1.3, dtype=jnp.float32))
    x, b = _inputs(shape, 6)
    out = fn(jnp.asarray(x), jnp.asarray(b) if with_b else None, p[0], p[1], 0, 0,
             interpret=True, with_noise=False)
    return x, b, (float(p[0]), float(p[1])), np.asarray(out)


@pytest.mark.parametrize("with_b", [True, False])
@pytest.mark.parametrize("kind", ["resident", "streamed"])
def test_twin_matches_jax_kernel(kind, with_b):
    x, b, (k2, h2), want = _jax_kernel_out(kind, with_b)
    tb = torch.from_numpy(b) if with_b else None
    wrapper = fused_patch_sweep_sqfd if kind == "resident" else fused_patch_sweep_sqfd_streamed
    got = wrapper(torch.from_numpy(x), tb, k2, h2, 0, 0, with_noise=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("shape", [(6, 7, 13), (11, 12, 13)])
def test_twin_matches_jax_plain_sweep(shape, noise):
    """Extents that are not multiples of 5: every face, edge and corner
    case of the closed form.  With the noise on, the JAX sweep takes the
    port's draws: eta[j] at p is member j's draw of the patch centred at
    p (every point is a centre once per sweep)."""
    jop = jax_squared(shape, 1.3, dtype=jnp.float32)
    p = jax_detect_squared_fd(jop)
    jsmp = JaxPatchGibbsSampler.create(jop, impl="lax")
    x, b = _inputs(shape, 7)
    seed, step = 12345, 2**31 - 3
    if noise:
        flat = _twin.flat_index(shape, DEV)
        eta = np.stack([_noise.eta_hash(pre, flat).numpy() for pre in patch_prefixes(seed, step)])
    else:
        eta = np.zeros((7, *shape), np.float32)
    want = jsmp.step_with_noise(jnp.asarray(x), jnp.asarray(b), [{"eta": jnp.asarray(eta)}])
    got = fused_patch_sweep_sqfd_reference(
        torch.from_numpy(x), torch.from_numpy(b), float(p[0]), float(p[1]), seed, step,
        with_noise=noise,
    )
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("case", ["plain", "squared"])
def test_invariance(case):
    grid = (5, 5)
    if case == "plain":
        op, tol = shifted_laplace_fd(grid, 1.5, dtype=F64, device=DEV), 1e-10
    else:
        op, tol = squared_shifted_laplace_fd(grid, 1.5, dtype=F64, device=DEV), 1e-9
    b = torch.sin(torch.arange(25, dtype=F64)).reshape(grid)
    me, ce = invariance_error(PatchGibbsSampler.create(op), op, b)
    assert me < tol and ce < tol, (me, ce)


def test_b_none_is_zeros_and_keyed_step_runs_the_twin():
    shape = (6, 7, 13)
    op = squared_shifted_laplace_fd(shape, 1.3, device=DEV)
    smp = PatchGibbsSampler.create(op)
    k2, h2 = smp.sq_fd_params
    x = torch.from_numpy(_inputs(shape, 8)[0])
    zeros = torch.zeros_like(x)
    kernels.reset_launch_counts()
    for noise in (False, True):
        for fn in (fused_patch_sweep_sqfd, fused_patch_sweep_sqfd_streamed):
            assert torch.equal(fn(x, None, k2, h2, 4, 9, with_noise=noise),
                               fn(x, zeros, k2, h2, 4, 9, with_noise=noise))
    # the keyed step is the twin under the step's (seed, step)
    from parmgmc_tpu_torch import keys

    key, got = smp.step(21, x, None)
    _, k1, k2_ = keys.split(21, 3)
    want = fused_patch_sweep_sqfd_reference(x, None, k2, h2, keys.randint31(k1), keys.randint31(k2_))
    assert key != 21 and torch.equal(got, want)
    assert all(v == 0 for v in kernels.launch_counts().values())
    # the size rule: 128^3 stays in L2, 256^3 does not
    assert patch_sweep_resident((128,) * 3, True) and not patch_sweep_resident((256,) * 3, False)
    with pytest.raises(ValueError):
        fused_patch_sweep_sqfd(x[0], None, k2, h2, 1, 2)
    with pytest.raises(ValueError):
        fused_patch_sweep_sqfd(x, x[:, :, :4], k2, h2, 1, 2)
    with pytest.raises(TypeError):
        PatchGibbsSampler.create(object())
