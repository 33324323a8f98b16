"""MGMC chain down-phase and from-zero level: CUDA kernel wrappers and twins.

Port of ``parmgmc_tpu/kernels/mg_sweep.py::fused_chain_down_fd``.  For the
chain state x_true = x + P z (``z`` optional, compact at (N0/2, N1/2,
N2/2), P the 2x2x2 aggregate prolongation) one launch computes

    r   = b - A x_true                       (b = None: zero RHS, no b read)
    r~  = r + sqrt((2 - omega)/omega) D^{1/2} eta
    y0  = one red/black SOR sweep from zero on r~
    xpy = x_true + y0
    rc  = R (r - A y0)                        (N0/2, N1/2, N2/2)

and, on request, partial sums of xpy (``with_xsum``) and of the z input
(``with_zsum``), one a work item of the launch plan, each summed in a
fixed order, so the chain's QOI needs no extra pass over the fine grid.
A is the link-count FD star operator (kappa2, hinv2) with the
off-diagonal scalars ``coeffs`` ordered (-e0, +e0, -e1, +e1, -e2, +e2).
eta is the counter-hash draw of :mod:`._noise` keyed by (seed, step,
:data:`~._noise.CHAIN_DOMAIN`, flat index).

The TPU kernel's lane pair-sum of ``rq`` is not copied: ``rc`` comes out
restricted.  Every chain wrapper launches one body, ``csrc/chain_march.cu``
(its note gives the bound and the design), which marches column strips
down segments of axis 0, each through its own entry and counter:
:func:`fused_chain_down_fd` (#1, planes up to the plane limit) in the
launch geometry of :func:`chain_fd_plan`, whose short segments fill the
card at 256^3; and, for large planes, in that of :func:`chain_plan`,
:func:`fused_chain_down_2d_staged` (the deferred chain's),
:func:`fused_chain_down_2d` (``sample_chain``'s) and
:func:`fused_zero_gibbs_restrict_fd` (a level from zero: x = 0, no z, b
required).  Each has its own twin; their xpy/y and rc agree bit for bit
(the plan moves work, not arithmetic), and the partial sums are one per
work item of the plan.

The launches a step of the deferred chain holds (#1, #5, #3) take their
noise key, the hash prefix of (seed, step), by value, or, with
``prefix_at`` (an int32 CUDA tensor of one word), from device memory when
the kernel runs: a captured step replayed from a CUDA graph
(:mod:`parmgmc_tpu_torch.replay`) reads each step's key there.  The draws
are the same either way; the twins take the prefix of seed and step.  #1
and #5 also take ``out``, a tensor the xpy output is written to in place
of a new one.  ``sample_chain``'s #4 (:func:`fused_chain_down_2d`) runs in
no captured step and takes neither.

Every wrapper takes ``row_offset`` and ``n0_global`` (as the JAX ones
do): x and b are then the block of rows ``row_offset ..`` of a grid of
``n0_global`` rows (a halo-extended shard of
``parmgmc_tpu_torch.parallel.fused``): the parity, the FD link count and
the noise counter follow the global row, and rows outside the global grid
read as zeros and come out as zeros (:class:`._twin.Rows`).  Both must be
even (``rc`` then restricts the global aggregates), and a block of a
larger grid takes no ``z`` and no partial sums.
"""

from __future__ import annotations

import functools
import math

import torch

from parmgmc_tpu_torch import kernels
from parmgmc_tpu_torch.kernels import _march, _noise, _twin

__all__ = [
    "MARCH_TILE",
    "chain_down_2d_supported",
    "chain_fd_plan",
    "chain_plan",
    "fused_chain_down_fd",
    "fused_chain_down_fd_reference",
    "fused_chain_down_2d",
    "fused_chain_down_2d_reference",
    "fused_chain_down_2d_staged",
    "fused_chain_down_2d_staged_reference",
    "fused_zero_gibbs_restrict_fd",
    "fused_zero_gibbs_restrict_fd_reference",
]

def _check_args(x, b, z, with_zsum, rows=None, with_xsum=False):
    if x.ndim != 3 or any(s % 2 for s in x.shape):
        raise ValueError(f"chain kernel needs a 3D grid of even extents, got {tuple(x.shape)}")
    rows = rows or _twin.Rows(x.shape[0])
    rows.check(x.shape[1] * x.shape[2])
    if not rows.whole:
        if (rows.offset | rows.n0) & 1:
            raise ValueError(f"row_offset {rows.offset} and n0_global {rows.n0} must be even")
        if z is not None or with_xsum or with_zsum:
            raise ValueError("z and the partial sums take a whole grid, not a block of rows")
    if b is not None and b.shape != x.shape:
        raise ValueError(f"b shape {tuple(b.shape)} != x shape {tuple(x.shape)}")
    zshape = tuple(s // 2 for s in x.shape)
    if z is not None and tuple(z.shape) != zshape:
        raise ValueError(f"z shape {tuple(z.shape)} != {zshape}")
    if with_zsum and z is None:
        raise ValueError("with_zsum requires z")


def _chain_math(x, b, coeffs, kappa2, hinv2, omega, seed, step, sweep, with_noise, z,
                rows=None):
    """(xpy, rc) of the chain down-phase in plain torch; x = None is the
    zero state (the from-zero level of :func:`fused_zero_gibbs_restrict_fd`);
    ``rows`` (a :class:`._twin.Rows`) places the block in the global grid."""
    like = b if x is None else x
    rows = rows or _twin.Rows(like.shape[0])
    return _twin.on_inside(
        lambda r, x, b, z: _chain_rows(x, b, coeffs, kappa2, hinv2, omega, seed, step, sweep,
                                       with_noise, z, r),
        rows, (x, b, z), (1, 0.5))


def _chain_rows(x, b, coeffs, kappa2, hinv2, omega, seed, step, sweep, with_noise, z, rows):
    like = b if x is None else x
    dt, dev = like.dtype, like.device
    shape = tuple(like.shape)
    c = [_twin.scalar(v, dt, dev) for v in coeffs]

    def neigh(v):
        return _twin.star_neigh(v, c)

    xt = torch.zeros_like(like) if x is None else x
    if z is not None:
        xt = xt + z[:, None, :, None, :, None].expand(
            shape[0] // 2, 2, shape[1] // 2, 2, shape[2] // 2, 2
        ).reshape(shape)
    D = _twin.fd_diag(shape, kappa2, hinv2, dt, dev, rows)
    ax = D * xt + neigh(xt)
    r = (0.0 - ax) if b is None else (b - ax)
    rt = r
    if with_noise:
        prefix = _noise.hash_prefix(seed, step, _noise.CHAIN_DOMAIN)
        eta = _noise.eta_hash(prefix, _twin.flat_index(shape, dev, rows.offset), dt)
        rt = r + (_twin.noise_factor(omega, dt) * torch.sqrt(D)) * eta
    color0 = 0 if sweep == "forward" else 1
    par = _twin.parity(shape, dev, rows.offset)
    winv = _twin.scalar(omega, dt, dev) / D
    v0 = torch.where(par == color0, winv * rt, rt)
    y = torch.where(par != color0, winv * (v0 - neigh(v0)), v0)
    return xt + y, _twin.restrict2(r - (D * y + neigh(y)))


def _with_sums(xpy, rc, z, tile, with_xsum, with_zsum):
    out = [xpy, rc]
    if with_xsum:
        out.append(_twin.tile_sums(xpy, tile))
    if with_zsum:
        out.append(_twin.tile_sums(z, tuple(t // 2 for t in tile)))
    return tuple(out)


def fused_chain_down_fd_reference(
    x, b, coeffs, kappa2, hinv2, omega, seed, step, *,
    sweep="forward", with_noise=True, z=None, with_xsum=False, with_zsum=False,
    row_offset=0, n0_global=None,
):
    """Plain-torch twin of :func:`fused_chain_down_fd` (any device):
    partial sums per work item of :func:`chain_fd_plan`."""
    rows = _twin.Rows(x.shape[0], row_offset, n0_global)
    _check_args(x, b, z, with_zsum, rows, with_xsum)
    xpy, rc = _chain_math(x, b, coeffs, kappa2, hinv2, omega, seed, step, sweep, with_noise, z,
                          rows)
    return _with_sums(xpy, rc, z, chain_fd_plan(x.shape).tile, with_xsum, with_zsum)


def fused_chain_down_fd(
    x, b, coeffs, kappa2, hinv2, omega, seed, step, *,
    sweep="forward", with_noise=True, z=None, with_xsum=False, with_zsum=False,
    row_offset=0, n0_global=None, prefix_at=None, out=None,
):
    """(xpy, rc[, xsum_partials][, zsum_partials]): the chain down-phase,
    partial sums per work item of :func:`chain_fd_plan`.

    CPU tensors run :func:`fused_chain_down_fd_reference`; CUDA tensors
    launch ``csrc/chain_march.cu``'s #1 entry (float32, contiguous) or
    raise."""
    if x.device.type == "cpu":
        return _into(out, fused_chain_down_fd_reference(
            x, b, coeffs, kappa2, hinv2, omega, seed, step, sweep=sweep,
            with_noise=with_noise, z=z, with_xsum=with_xsum, with_zsum=with_zsum,
            row_offset=row_offset, n0_global=n0_global,
        ))
    if x.device.type != "cuda":
        raise ValueError(f"no chain kernel for device {x.device}")
    rows = _twin.Rows(x.shape[0], row_offset, n0_global)
    _check_args(x, b, z, with_zsum, rows, with_xsum)
    return _launch_march("chain_down", x, b, coeffs, kappa2, hinv2, omega, seed, step, sweep,
                         with_noise, z, with_xsum, with_zsum, rows, prefix_at, out)


# -- large planes: the marching kernel (csrc/chain_march.cu) ------------------

# (axis-0 halo, T1, T2): a block owns a (T1, T2) column strip over a
# segment of axis 0 (chain_plan) and recomputes the halo planes around it
MARCH_TILE = kernels.TILES["chain_march"]


def chain_fd_plan(shape, with_z=False) -> _march.MarchPlan:
    """The launch plan of #1 on ``shape``: the strips of :func:`chain_plan`
    over the longest even segments that still fill the card's block slots
    in one wave (:func:`_march.wave_plan`), TMA as in :func:`chain_plan`;
    kept per shape."""
    return _chain_fd_plan(tuple(int(n) for n in shape), bool(with_z))


@functools.lru_cache(maxsize=64)
def _chain_fd_plan(shape, with_z) -> _march.MarchPlan:
    n2 = shape[2]
    return _march.wave_plan(shape, MARCH_TILE[0], MARCH_TILE[1:],
                            row_words=(n2, n2 // 2) if with_z else (n2,))


def chain_plan(shape, with_z=False) -> _march.MarchPlan:
    """The launch plan of the marching chain kernel on ``shape`` (#5, #4
    and #3 share it): even segments, TMA when every streamed row (x and b
    of n2 words, z of n2/2) is a multiple of 16 B."""
    n2 = int(shape[2])
    return _march.plan(shape, MARCH_TILE[0], MARCH_TILE[1:], even=True,
                       row_words=(n2, n2 // 2) if with_z else (n2,))


def chain_down_2d_supported(shape) -> bool:
    """Can the marching kernel (#3, #4, #5) take this grid?  3D, even
    extents (the restriction), fewer than 2^32 points (the noise counter)."""
    return (
        len(shape) == 3
        and all(int(s) > 0 and int(s) % 2 == 0 for s in shape)
        and math.prod(int(s) for s in shape) < 2**32
    )


def fused_chain_down_2d_staged_reference(
    x, b, coeffs, kappa2, hinv2, omega, seed, step, *,
    sweep="forward", with_noise=True, z=None, with_xsum=False, with_zsum=False,
    row_offset=0, n0_global=None,
):
    """Plain-torch twin of :func:`fused_chain_down_2d_staged` (any device):
    partial sums per work item of :func:`chain_plan`."""
    rows = _twin.Rows(x.shape[0], row_offset, n0_global)
    _check_args(x, b, z, with_zsum, rows, with_xsum)
    xpy, rc = _chain_math(x, b, coeffs, kappa2, hinv2, omega, seed, step, sweep, with_noise, z,
                          rows)
    return _with_sums(xpy, rc, z, chain_plan(x.shape).tile, with_xsum, with_zsum)


def fused_chain_down_2d_reference(
    x, b, coeffs, kappa2, hinv2, omega, seed, step, *,
    sweep="forward", with_noise=True, z=None, with_xsum=False, with_zsum=False,
    row_offset=0, n0_global=None,
):
    """Plain-torch twin of :func:`fused_chain_down_2d` (any device): partial
    sums per work item of :func:`chain_plan`."""
    rows = _twin.Rows(x.shape[0], row_offset, n0_global)
    _check_args(x, b, z, with_zsum, rows, with_xsum)
    xpy, rc = _chain_math(x, b, coeffs, kappa2, hinv2, omega, seed, step, sweep, with_noise, z,
                          rows)
    return _with_sums(xpy, rc, z, chain_plan(x.shape).tile, with_xsum, with_zsum)


def fused_zero_gibbs_restrict_fd_reference(
    b, coeffs, kappa2, hinv2, omega, seed, step, *, sweep="forward", with_noise=True,
    row_offset=0, n0_global=None,
):
    """Plain-torch twin of :func:`fused_zero_gibbs_restrict_fd` (any device)."""
    rows = _twin.Rows(b.shape[0], row_offset, n0_global)
    _check_args(b, b, None, False, rows)
    return _chain_math(None, b, coeffs, kappa2, hinv2, omega, seed, step, sweep, with_noise, None,
                       rows)


def _into(out, res):
    """``res`` with its first tensor (xpy) copied into ``out`` when given:
    the twins' side of the wrappers' ``out``."""
    if out is None:
        return res
    return (out.copy_(res[0]), *res[1:])


def _launch_march(counter, x, b, coeffs, kappa2, hinv2, omega, seed, step, sweep,
                  with_noise, z, with_xsum, with_zsum, rows, prefix_at=None, out=None):
    """Launch ``csrc/chain_march.cu`` on CUDA tensors, #1 (``counter``
    ``chain_down``) in the geometry of :func:`chain_fd_plan` through its own
    entry, the others in that of :func:`chain_plan`, on the rows ``rows``
    (a :class:`._twin.Rows`) of the global grid, the noise key from
    ``prefix_at`` when given, xpy into ``out`` when given; count it under
    ``counter``."""
    like = b if x is None else x
    if sweep not in ("forward", "backward"):
        raise ValueError(f"chain kernel runs one forward/backward sweep, got {sweep!r}")
    for name, t in (("x", x), ("b", b), ("z", z), ("out", out)):
        if t is not None:
            kernels.check_input(name, t, like)
    if out is not None and out.shape != like.shape:
        raise ValueError(f"out shape {tuple(out.shape)} != x shape {tuple(like.shape)}")
    at = kernels.prefix_pointer(prefix_at, 1, like)
    lib = kernels.lib()
    n0, n1, n2 = like.shape
    fd = counter == "chain_down"
    plan = (chain_fd_plan if fd else chain_plan)(like.shape, with_z=z is not None)
    # x and b stream from the first row inside the global grid
    skip = rows.inside()[0] * n1 * n2 * like.element_size()
    tma = plan.tma and all((t.data_ptr() + (0 if t is z else skip)) % 16 == 0
                           for t in (x, b, z) if t is not None)
    nblk = plan.items
    xpy = torch.empty_like(like) if out is None else out
    rc = torch.empty((n0 // 2, n1 // 2, n2 // 2), dtype=like.dtype, device=like.device)
    xsum = torch.empty(nblk, dtype=like.dtype, device=like.device) if with_xsum else None
    zsum = torch.empty(nblk, dtype=like.dtype, device=like.device) if with_zsum else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(like.device):
        err = (lib.pmg_chain_march_fd if fd else lib.pmg_chain_march)(
            ptr(x), ptr(b), ptr(z), ptr(xpy), ptr(rc), ptr(xsum), ptr(zsum), n0, n1, n2,
            plan.seg, int(tma), *(_twin.f32(v) for v in coeffs), kappa2, hinv2, omega,
            _twin.noise_factor(omega),
            _noise.hash_prefix(seed, step, _noise.CHAIN_DOMAIN), at,
            0 if sweep == "forward" else 1, int(with_noise), rows.offset, rows.n0,
            torch.cuda.current_stream(like.device).cuda_stream,
        )
    kernels.check_launch(err, counter)
    out = [xpy, rc]
    if with_xsum:
        out.append(xsum)
    if with_zsum:
        out.append(zsum)
    return tuple(out)


def fused_chain_down_2d_staged(
    x, b, coeffs, kappa2, hinv2, omega, seed, step, *,
    sweep="forward", with_noise=True, z=None, with_xsum=False, with_zsum=False,
    row_offset=0, n0_global=None, prefix_at=None, out=None,
):
    """(xpy, rc[, xsum_partials][, zsum_partials]): the chain down-phase of
    :func:`fused_chain_down_fd` for large planes, by column strips marching
    down segments of axis 0 (:func:`chain_plan`; partial sums per work
    item).

    Port of ``parmgmc_tpu/kernels/mg_sweep.py::fused_chain_down_2d_staged``
    with the port's compact carry ``z`` in place of ``zf``/``zx2``.  CPU
    tensors run the twin; CUDA tensors launch ``csrc/chain_march.cu``
    (float32, contiguous) or raise."""
    if x.device.type == "cpu":
        return _into(out, fused_chain_down_2d_staged_reference(
            x, b, coeffs, kappa2, hinv2, omega, seed, step, sweep=sweep,
            with_noise=with_noise, z=z, with_xsum=with_xsum, with_zsum=with_zsum,
            row_offset=row_offset, n0_global=n0_global,
        ))
    if x.device.type != "cuda":
        raise ValueError(f"no chain kernel for device {x.device}")
    rows = _twin.Rows(x.shape[0], row_offset, n0_global)
    _check_args(x, b, z, with_zsum, rows, with_xsum)
    return _launch_march("chain_2d_staged", x, b, coeffs, kappa2, hinv2, omega, seed, step,
                         sweep, with_noise, z, with_xsum, with_zsum, rows, prefix_at, out)


def fused_chain_down_2d(
    x, b, coeffs, kappa2, hinv2, omega, seed, step, *,
    sweep="forward", with_noise=True, z=None, with_xsum=False, with_zsum=False,
    row_offset=0, n0_global=None, prefix_at=None, out=None,
):
    """(xpy, rc[, xsum_partials][, zsum_partials]): as
    :func:`fused_chain_down_2d_staged`, in the same launch geometry, on its
    own entry and counter; bit for bit the staged outputs.  ``prefix_at``
    and ``out`` serve ``sample_chain``'s captured step
    (:mod:`parmgmc_tpu_torch.replay`), as for the staged kernel.

    Port of ``parmgmc_tpu/kernels/mg_sweep.py::fused_chain_down_2d``.  CPU
    tensors run the twin; CUDA tensors launch ``csrc/chain_march.cu`` or
    raise."""
    if x.device.type == "cpu":
        return _into(out, fused_chain_down_2d_reference(
            x, b, coeffs, kappa2, hinv2, omega, seed, step, sweep=sweep,
            with_noise=with_noise, z=z, with_xsum=with_xsum, with_zsum=with_zsum,
            row_offset=row_offset, n0_global=n0_global,
        ))
    if x.device.type != "cuda":
        raise ValueError(f"no chain kernel for device {x.device}")
    rows = _twin.Rows(x.shape[0], row_offset, n0_global)
    _check_args(x, b, z, with_zsum, rows, with_xsum)
    return _launch_march("chain_2d", x, b, coeffs, kappa2, hinv2, omega, seed, step, sweep,
                         with_noise, z, with_xsum, with_zsum, rows, prefix_at, out)


def fused_zero_gibbs_restrict_fd(
    b, coeffs, kappa2, hinv2, omega, seed, step, *, sweep="forward", with_noise=True,
    row_offset=0, n0_global=None, prefix_at=None,
):
    """(y, rc): one level's down-phase from zero -- y the red/black sweep
    from zero of b~ = b + noise, rc = R(b - A y) -- the chain down-phase
    with x = 0; bit for bit :func:`fused_chain_down_2d_staged` with a zero
    x.

    Port of ``parmgmc_tpu/kernels/mg_sweep.py::fused_zero_gibbs_restrict_fd``
    (``rc`` restricted, no lane pair-sum).  CPU tensors run the twin; CUDA
    tensors launch ``csrc/chain_march.cu`` without an x stream, or raise."""
    if b.device.type == "cpu":
        return fused_zero_gibbs_restrict_fd_reference(
            b, coeffs, kappa2, hinv2, omega, seed, step, sweep=sweep, with_noise=with_noise,
            row_offset=row_offset, n0_global=n0_global,
        )
    if b.device.type != "cuda":
        raise ValueError(f"no zero-start level kernel for device {b.device}")
    rows = _twin.Rows(b.shape[0], row_offset, n0_global)
    _check_args(b, b, None, False, rows)
    return _launch_march("zero_restrict", None, b, coeffs, kappa2, hinv2, omega, seed, step,
                         sweep, with_noise, None, False, False, rows, prefix_at)
