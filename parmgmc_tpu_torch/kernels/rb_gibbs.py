"""Full stochastic red/black Gibbs sweep: CUDA kernel wrappers and twins.

Port of ``parmgmc_tpu/kernels/rb_gibbs.py::fused_rb_gibbs_sweep_fd`` (the
diagonal rebuilt from (kappa2, hinv2) and the in-grid link count) and
``fused_rb_gibbs_sweep`` (the diagonal read from a tensor).  For a 3D
star stencil with the six scalar off-diagonals ``coeffs`` ordered
(-e0, +e0, -e1, +e1, -e2, +e2) one launch maps x to x' out of place:

    b~ = b + noise_mult sqrt((2 - omega)/omega) D^{1/2} eta   (b = None: 0)
    colour c0, then colour 1 - c0:
        x_r <- (1 - omega) x_r + (omega / D_r) (b~_r - sum_nbr c x_nbr)

with parity (i + j + k) % 2 and c0 = 0 for ``sweep="forward"``, 1 for
``"backward"``.  The FD wrappers (#7, #8, #9) take ``row_offset`` and
``n0_global`` (as the JAX ones do): x is then the block of rows
``row_offset ..`` of a grid of ``n0_global`` rows (a halo-extended shard of
``parmgmc_tpu_torch.parallel.fused``): the parity, the FD link count and
the noise counter follow the global row, and rows outside the global grid
read as zeros and come out as zeros (:class:`._twin.Rows`).  eta is the counter-hash draw of :mod:`._noise` keyed by
(seed, step, :data:`~._noise.SWEEP_DOMAIN`, flat index); the TPU kernels'
row-keyed hardware PRNG has no counterpart.

All four wrappers launch one body, ``csrc/sweep_march.cu``, which marches
column strips down segments of axis 0 (its note gives the bound and the
design), each through its own entry point and counter.  They route as the
JAX package routes: a grid whose planes hold more than
:data:`_PLANE_LIMIT` points goes to :func:`fused_rb_gibbs_sweep_2d` (#8),
which sends FD calls on to :func:`fused_rb_gibbs_sweep_2d_staged` (#9),
in the launch geometry of :func:`sweep_plan`; the others run #7 (FD) or
#6 (streamed diagonal) in that of :func:`full_sweep_plan`, whose shorter
segments fill the card on the smaller grids.  The plan moves work, not
arithmetic: every route computes the same function with the same draws,
bit for bit.  The Mosaic tile gates are not copied: the CUDA kernels take
any 3D shape.  Each CUDA launch takes the hash prefix of (seed, step) by
value, or, with ``prefix_at`` (an int32 CUDA tensor of one word), from
device memory when it runs (a step replayed from a CUDA graph,
:mod:`parmgmc_tpu_torch.replay`); the draws are the same either way.
"""

from __future__ import annotations

import functools

import torch

from parmgmc_tpu_torch import kernels
from parmgmc_tpu_torch.kernels import _march, _noise, _twin

__all__ = [
    "fused_rb_gibbs_sweep_fd",
    "fused_rb_gibbs_sweep_fd_reference",
    "fused_rb_gibbs_sweep",
    "fused_rb_gibbs_sweep_reference",
    "fused_rb_gibbs_sweep_2d",
    "fused_rb_gibbs_sweep_2d_reference",
    "fused_rb_gibbs_sweep_2d_staged",
    "fused_rb_gibbs_sweep_2d_staged_reference",
    "sweep_plan",
    "full_sweep_plan",
]

# planes above this many points take the large-plane kernels: the sweeps
# here, and level 0 of the V(1,0) chain in samplers/mgmc.py.  It is the JAX
# package's rb_gibbs._PLANE_LIMIT, the line where its whole-plane kernels
# leave VMEM; both routes compute the same function.  A TPU limit, not
# measured on the H100 (ROADMAP.md slice 2c)
_PLANE_LIMIT = 448 * 1024


def _color0(sweep: str) -> int:
    if sweep not in ("forward", "backward"):
        raise ValueError(f"a sweep kernel runs one forward/backward sweep, got {sweep!r}")
    return 0 if sweep == "forward" else 1


def _check_args(x, b, diag, rows=None):
    if x.ndim != 3:
        raise ValueError(f"sweep kernel needs a 3D grid, got {tuple(x.shape)}")
    (rows or _twin.Rows(x.shape[0])).check(x.shape[1] * x.shape[2])
    for name, t in (("b", b), ("diag", diag)):
        if t is not None and t.shape != x.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != x shape {tuple(x.shape)}")


def _nscale(omega, noise_mult, dtype=torch.float32) -> float:
    """noise_mult * sqrt((2 - omega)/omega) rounded as the device rounds it."""
    if dtype != torch.float32:
        return _twin.noise_factor(omega, dtype) * float(noise_mult)
    return _twin.f32(_twin.noise_factor(omega, dtype) * _twin.f32(noise_mult))


def _sweep_reference(x, b, D, coeffs, omega, seed, step, noise_mult, sweep, with_noise,
                     rows=None):
    rows = rows or _twin.Rows(x.shape[0])
    return _twin.on_inside(
        lambda r, x, b, D: _sweep_rows(x, b, D, coeffs, omega, seed, step, noise_mult, sweep,
                                       with_noise, r),
        rows, (x, b, D), (1,))


def _sweep_rows(x, b, D, coeffs, omega, seed, step, noise_mult, sweep, with_noise, rows):
    color0 = _color0(sweep)
    dt, dev = x.dtype, x.device
    shape = tuple(x.shape)
    c = [_twin.scalar(v, dt, dev) for v in coeffs]
    bt = torch.zeros_like(x) if b is None else b
    if with_noise:
        prefix = _noise.hash_prefix(seed, step, _noise.SWEEP_DOMAIN)
        eta = _noise.eta_hash(prefix, _twin.flat_index(shape, dev, rows.offset), dt)
        bt = bt + (_nscale(omega, noise_mult, dt) * torch.sqrt(D)) * eta
    par = _twin.parity(shape, dev, rows.offset)
    om = _twin.scalar(omega, dt, dev)
    for color in (color0, 1 - color0):
        upd = (1.0 - om) * x + (om / D) * (bt - _twin.star_neigh(x, c))
        x = torch.where(par == color, upd, x)
    return x


def fused_rb_gibbs_sweep_fd_reference(
    x, b, coeffs, kappa2, hinv2, omega, seed, step, noise_mult=1.0, *,
    sweep="forward", with_noise=True, row_offset=0, n0_global=None,
):
    """Plain-torch twin of :func:`fused_rb_gibbs_sweep_fd` (any device)."""
    rows = _twin.Rows(x.shape[0], row_offset, n0_global)
    _check_args(x, b, None, rows)
    D = _twin.fd_diag(tuple(x.shape), kappa2, hinv2, x.dtype, x.device, rows)
    return _sweep_reference(x, b, D, coeffs, omega, seed, step, noise_mult, sweep, with_noise,
                            rows)


def fused_rb_gibbs_sweep_reference(
    x, b, diag, coeffs, omega, seed, step, noise_mult=1.0, *,
    sweep="forward", with_noise=True,
):
    """Plain-torch twin of :func:`fused_rb_gibbs_sweep` (any device)."""
    _check_args(x, b, diag)
    return _sweep_reference(x, b, diag, coeffs, omega, seed, step, noise_mult, sweep, with_noise)


def sweep_plan(shape) -> _march.MarchPlan:
    """The launch plan of the marching sweep on ``shape``: #9 and #8 share
    it (strips of ``kernels.TILES["sweep_march"]``, 2-plane axis-0 halo)."""
    halo, *strip = kernels.TILES["sweep_march"]
    return _march.plan(shape, halo, strip, row_words=(shape[2],))


def full_sweep_plan(shape) -> _march.MarchPlan:
    """The launch plan of the full sweep below the plane limit on
    ``shape``: #7 and #6 share it (:func:`_march.full_plan`: the strips of
    #9, segments of about a twentieth of axis 0).  Kept per shape: a V(2,2)
    step asks for it at every sweep."""
    return _full_sweep_plan(tuple(int(n) for n in shape))


@functools.lru_cache(maxsize=64)
def _full_sweep_plan(shape) -> _march.MarchPlan:
    halo, *strip = kernels.TILES["sweep_march"]
    return _march.full_plan(shape, halo, strip, row_words=(shape[2],))


def _launch(x, b, diag, coeffs, kappa2, hinv2, omega, seed, step, noise_mult, sweep,
            with_noise, counter, entry, plan, rows=None, prefix_at=None):
    """Launch the C function ``entry`` (an entry point of
    ``csrc/sweep_march.cu``) on CUDA tensors in the geometry of ``plan``
    (a :class:`_march.MarchPlan`), on the rows ``rows`` (a
    :class:`._twin.Rows`; the whole grid when None) of the global grid, the
    noise key from ``prefix_at`` when given; count it under ``counter``."""
    if x.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {x.device}")
    color0 = _color0(sweep)
    rows = rows or _twin.Rows(x.shape[0])
    _check_args(x, b, diag, rows)
    for name, t in (("x", x), ("b", b), ("diag", diag)):
        if t is not None:
            kernels.check_input(name, t, x)
    at = kernels.prefix_pointer(prefix_at, 1, x)
    lib = kernels.lib()
    out = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()
    # the kernel streams from the first row inside the global grid
    skip = rows.inside()[0] * x.shape[1] * x.shape[2] * x.element_size()
    aligned = all((t.data_ptr() + skip) % 16 == 0 for t in (x, b, diag) if t is not None)
    geometry = (plan.seg, int(plan.tma and aligned))
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(
            ptr(x), ptr(b), ptr(diag), ptr(out), *x.shape, *geometry,
            *(_twin.f32(v) for v in coeffs), kappa2, hinv2, omega,
            _nscale(omega, noise_mult),
            _noise.hash_prefix(seed, step, _noise.SWEEP_DOMAIN), at,
            color0, int(with_noise), rows.offset, rows.n0,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check_launch(err, counter)
    return out


def _large_plane(x) -> bool:
    return x.ndim == 3 and x.shape[1] * x.shape[2] > _PLANE_LIMIT


def fused_rb_gibbs_sweep_fd(
    x, b, coeffs, kappa2, hinv2, omega, seed, step, noise_mult=1.0, *,
    sweep="forward", with_noise=True, row_offset=0, n0_global=None, prefix_at=None,
):
    """x': one stochastic red/black sweep of the link-count FD operator
    (kappa2, hinv2) with off-diagonals ``coeffs``; x holds rows
    ``row_offset ..`` of a grid of ``n0_global`` rows (default: the whole
    grid).

    Planes over :data:`_PLANE_LIMIT` points go to
    :func:`fused_rb_gibbs_sweep_2d` (#9 for this FD form), with the two
    row arguments.  Otherwise CPU tensors run
    :func:`fused_rb_gibbs_sweep_fd_reference`; CUDA tensors launch
    ``csrc/sweep_march.cu`` in FD mode (float32, contiguous) or raise."""
    if _large_plane(x):
        return fused_rb_gibbs_sweep_2d(
            x, b, None, coeffs, omega, seed, step, noise_mult, sweep=sweep,
            with_noise=with_noise, fd_params=(kappa2, hinv2), row_offset=row_offset,
            n0_global=n0_global, prefix_at=prefix_at,
        )
    if x.device.type == "cpu":
        return fused_rb_gibbs_sweep_fd_reference(
            x, b, coeffs, kappa2, hinv2, omega, seed, step, noise_mult,
            sweep=sweep, with_noise=with_noise, row_offset=row_offset, n0_global=n0_global,
        )
    return _launch(x, b, None, coeffs, kappa2, hinv2, omega, seed, step, noise_mult,
                   sweep, with_noise, "rb_gibbs_fd", "pmg_sweep_march_fd",
                   full_sweep_plan(x.shape), _twin.Rows(x.shape[0], row_offset, n0_global),
                   prefix_at)


def fused_rb_gibbs_sweep(
    x, b, diag, coeffs, omega, seed, step, noise_mult=1.0, *,
    sweep="forward", with_noise=True, prefix_at=None,
):
    """x': one stochastic red/black sweep of the star stencil with the
    diagonal field ``diag`` and off-diagonals ``coeffs``.

    Planes over :data:`_PLANE_LIMIT` points go to
    :func:`fused_rb_gibbs_sweep_2d` (#8).  Otherwise CPU tensors run
    :func:`fused_rb_gibbs_sweep_reference`; CUDA tensors launch
    ``csrc/sweep_march.cu`` in streamed-diagonal mode (float32, contiguous)
    or raise."""
    if _large_plane(x):
        return fused_rb_gibbs_sweep_2d(
            x, b, diag, coeffs, omega, seed, step, noise_mult, sweep=sweep,
            with_noise=with_noise, prefix_at=prefix_at,
        )
    if x.device.type == "cpu":
        return fused_rb_gibbs_sweep_reference(
            x, b, diag, coeffs, omega, seed, step, noise_mult,
            sweep=sweep, with_noise=with_noise,
        )
    if diag is None:
        raise ValueError("fused_rb_gibbs_sweep streams the diagonal: diag is required")
    return _launch(x, b, diag, coeffs, 0.0, 0.0, omega, seed, step, noise_mult,
                   sweep, with_noise, "rb_gibbs", "pmg_sweep_march_diag",
                   full_sweep_plan(x.shape), prefix_at=prefix_at)


# -- large planes: the marching sweep kernel (csrc/sweep_march.cu) ------------


def _fd_pair(fd_params) -> tuple:
    return float(fd_params[0]), float(fd_params[1])


def fused_rb_gibbs_sweep_2d_reference(
    x, b, diag, coeffs, omega, seed, step, noise_mult=1.0, *,
    sweep="forward", with_noise=True, fd_params=None, row_offset=0, n0_global=None,
):
    """Plain-torch twin of :func:`fused_rb_gibbs_sweep_2d` (any device): the
    function of :func:`fused_rb_gibbs_sweep_fd_reference` when ``fd_params``
    = (kappa2, hinv2) is given, of :func:`fused_rb_gibbs_sweep_reference`
    with ``diag`` when not."""
    if (diag is None) == (fd_params is None):
        raise ValueError("the 2D sweep takes exactly one of diag and fd_params")
    rows = _twin.Rows(x.shape[0], row_offset, n0_global)
    _check_args(x, b, diag, rows)
    if fd_params is None:
        D = diag
    else:
        D = _twin.fd_diag(tuple(x.shape), *_fd_pair(fd_params), x.dtype, x.device, rows)
    return _sweep_reference(x, b, D, coeffs, omega, seed, step, noise_mult, sweep, with_noise,
                            rows)


def fused_rb_gibbs_sweep_2d_staged_reference(
    x, b, coeffs, omega, seed, step, noise_mult=1.0, *,
    sweep="forward", with_noise=True, fd_params=None, row_offset=0, n0_global=None,
):
    """Plain-torch twin of :func:`fused_rb_gibbs_sweep_2d_staged` (any
    device)."""
    if fd_params is None:
        raise ValueError("the staged 2D sweep is FD-form only: fd_params is required")
    return fused_rb_gibbs_sweep_2d_reference(
        x, b, None, coeffs, omega, seed, step, noise_mult, sweep=sweep,
        with_noise=with_noise, fd_params=fd_params, row_offset=row_offset, n0_global=n0_global,
    )


def fused_rb_gibbs_sweep_2d(
    x, b, diag, coeffs, omega, seed, step, noise_mult=1.0, *,
    sweep="forward", with_noise=True, fd_params=None, staged=True, row_offset=0,
    n0_global=None, prefix_at=None,
):
    """x': the sweep of :func:`fused_rb_gibbs_sweep_fd` (``fd_params`` =
    (kappa2, hinv2), ``diag`` None) or of :func:`fused_rb_gibbs_sweep`
    (``diag`` given) for large planes, by column strips marching down
    segments of axis 0 (:func:`sweep_plan`, the geometry #9 shares).

    Port of ``parmgmc_tpu/kernels/rb_gibbs.py::fused_rb_gibbs_sweep_2d``.
    FD calls go on to :func:`fused_rb_gibbs_sweep_2d_staged`, as the JAX
    function auto-routes them; the staged kernel takes every 3D shape, so
    the JAX tile probe has no counterpart.  ``staged=False`` keeps an FD
    call on this entry point and counter (the JAX ``tile2d=`` call of
    ``bench.py --selftest-staged``).  ``row_offset``/``n0_global`` as for
    :func:`fused_rb_gibbs_sweep_fd`, forwarded to #9.  CPU tensors run the
    twin; CUDA tensors launch ``csrc/sweep_march.cu`` (float32, contiguous)
    or raise."""
    if (diag is None) == (fd_params is None):
        raise ValueError("the 2D sweep takes exactly one of diag and fd_params")
    if fd_params is not None and staged:
        return fused_rb_gibbs_sweep_2d_staged(
            x, b, coeffs, omega, seed, step, noise_mult, sweep=sweep,
            with_noise=with_noise, fd_params=fd_params, row_offset=row_offset,
            n0_global=n0_global, prefix_at=prefix_at,
        )
    if x.device.type == "cpu":
        return fused_rb_gibbs_sweep_2d_reference(
            x, b, diag, coeffs, omega, seed, step, noise_mult, sweep=sweep,
            with_noise=with_noise, fd_params=fd_params, row_offset=row_offset,
            n0_global=n0_global,
        )
    kappa2, hinv2 = (0.0, 0.0) if fd_params is None else _fd_pair(fd_params)
    return _launch(x, b, diag, coeffs, kappa2, hinv2, omega, seed, step, noise_mult,
                   sweep, with_noise, "rb_gibbs_2d", "pmg_sweep_march_windowed",
                   sweep_plan(x.shape), _twin.Rows(x.shape[0], row_offset, n0_global),
                   prefix_at)


def fused_rb_gibbs_sweep_2d_staged(
    x, b, coeffs, omega, seed, step, noise_mult=1.0, *,
    sweep="forward", with_noise=True, fd_params=None, row_offset=0, n0_global=None,
    prefix_at=None,
):
    """x': the sweep of :func:`fused_rb_gibbs_sweep_fd` with ``fd_params`` =
    (kappa2, hinv2) for large planes, by column strips marching down
    segments of axis 0 (:func:`sweep_plan`); bit for bit the FD mode of
    :func:`fused_rb_gibbs_sweep_2d` and #7.

    Port of ``parmgmc_tpu/kernels/rb_gibbs.py::fused_rb_gibbs_sweep_2d_staged``
    (FD only: raises without ``fd_params``).  ``row_offset``/``n0_global``
    as for :func:`fused_rb_gibbs_sweep_fd`.  CPU tensors run the twin;
    CUDA tensors launch ``csrc/sweep_march.cu`` (float32, contiguous) or
    raise."""
    if fd_params is None:
        raise ValueError("the staged 2D sweep is FD-form only: fd_params is required")
    if x.device.type == "cpu":
        return fused_rb_gibbs_sweep_2d_staged_reference(
            x, b, coeffs, omega, seed, step, noise_mult, sweep=sweep,
            with_noise=with_noise, fd_params=fd_params, row_offset=row_offset,
            n0_global=n0_global,
        )
    return _launch(x, b, None, coeffs, *_fd_pair(fd_params), omega, seed, step, noise_mult,
                   sweep, with_noise, "rb_gibbs_2d_staged", "pmg_sweep_march_staged",
                   sweep_plan(x.shape), _twin.Rows(x.shape[0], row_offset, n0_global),
                   prefix_at)
