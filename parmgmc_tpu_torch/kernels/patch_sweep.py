"""Coloured vertex-star patch-Gibbs sweep of a squared FD operator:
CUDA kernel wrappers and their plain twin.

Port of ``parmgmc_tpu/kernels/patch_sweep.py``: ``fused_patch_sweep_sqfd``
(the whole sweep with the state resident on chip) and
``fused_patch_sweep_sqfd_streamed`` (the state in device memory, one
colour at a time).  For A = F^2, F = kappa2 + hinv2 * links, one sweep
maps x to x' out of place: for each of the 125 colours c = (a0, a1, a2)
in turn (axis 0 the most significant digit), every patch centred at
(a0 + 5i, a1 + 5j, a2 + 5k) -- the centre and its 6 unit neighbours,
ordered as :data:`MEMBERS` -- is resampled from its exact conditional

    x_S ~ N(A_SS^{-1} (b_S - A_{S,rest} x_rest), A_SS^{-1})

with A_SS rebuilt in closed form from (kappa2, hinv2) and the in-grid
masks, writing h2 for hinv2 and d for the diagonal of F:

    diagonal            d^2 + h2^2 links
    |o_i - o_j| = e     -h2 (d_i + d_j)
    |o_i - o_j| = 2e    h2^2                      (the path via the centre)
    o_i + o_j mixed     h2^2 (1 + in-grid(c + o_i + o_j))   (+ the corner)

and out-of-grid members as identity rows.  The rhs is mask (b - A x)_S +
A_SS x_S with b - A x = b - F(F x); the 7x7 system is factored by an
unrolled Cholesky, z = L^{-1} rhs, x_S = L^{-T} (z + eta).  eta_j of the
patch centred at flat index p is ``eta_hash(hash_prefix(seed, step,
PATCH_DOMAIN + j), p)``: one draw per (centre, member), the same in both
kernels and the twin.  The TPU kernels' hardware PRNG has no
counterpart.

Both wrappers launch one source, ``csrc/patch_sweep.cu``, whose note
gives the bound and the design.  :func:`fused_patch_sweep_sqfd` takes
the whole-sweep cooperative kernel (#10) when :func:`patch_sweep_resident`
says the state stays in L2 and the per-phase kernel (#11) otherwise,
as the TPU wrapper dispatches on VMEM.  Both follow
:func:`patch_schedule`: the 125-colour order factorised into 25 phases
(a0, a1) of independent (i, j) lines of axis 2, each line running its
colours a2 = 0 .. 4 in turn; a patch on it reads and writes nothing
another line of its phase touches, so the result is the colour order's
bit for bit.  :func:`fused_patch_sweep_sqfd_colourwise` keeps the colour
order itself, one launch a colour, as the kernels' check.  The Mosaic
window layout, the ``N2 % 128`` and ``N1 % 8`` gates and the row groups
are not copied: the CUDA kernels take any 3D shape whose rows of axis 2
fit the staged lines (:data:`MAX_N2`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from parmgmc_tpu_torch import kernels
from parmgmc_tpu_torch.kernels import _noise, _twin
from parmgmc_tpu_torch.operators.stencil import link_count

__all__ = [
    "MEMBERS",
    "MAX_N2",
    "PatchPhase",
    "PatchSchedule",
    "patch_schedule",
    "patch_sweep_resident",
    "patch_prefixes",
    "fused_patch_sweep_sqfd",
    "fused_patch_sweep_sqfd_streamed",
    "fused_patch_sweep_sqfd_colourwise",
    "fused_patch_sweep_sqfd_reference",
]

# vertex-star member offsets, centre first (PatchGibbsSampler's order)
MEMBERS = (
    (0, 0, 0),
    (-1, 0, 0),
    (1, 0, 0),
    (0, -1, 0),
    (0, 1, 0),
    (0, 0, -1),
    (0, 0, 1),
)
K = len(MEMBERS)
M = 5  # colour base: stencil radius 2 + 3
# the H100's L2 cache; the whole-sweep kernel wants the state in half of it
L2_BYTES = 50 * 2**20
# the kernels stage 25 rows of x and 5 of b a line, 4 zero columns on each
# side, in a block's shared memory (227 KB on an H100): the longest row of
# axis 2 they take
MAX_N2 = 232_448 // (4 * 30) - 8


def _centres(n: int, a: int) -> int:
    """Centres of residue a along an axis of extent n."""
    return -(-(n - a) // M) if n > a else 0


@dataclass(frozen=True)
class PatchPhase:
    """One phase (a0, a1) of the factorised sweep."""

    a0: int
    a1: int
    lines: tuple  # the (i, j) lines of axis 2, in the kernels' block order
    centres: tuple  # centres[a2]: the k of the colour-a2 centres on each line


@dataclass(frozen=True)
class PatchSchedule:
    """The order of the patch kernels (#10, #11).

    The 25 phases run in turn (one launch each in #11, a grid barrier
    between them in #10); in a phase, block g takes line g (and g + the
    grid, ... where the grid is smaller) and runs the colours a2 = 0 .. 4
    on it in turn, a thread a centre."""

    shape: tuple
    phases: tuple  # 25 PatchPhase in the order (a0, a1); some may hold no line


def patch_schedule(shape) -> PatchSchedule:
    """The factorised schedule of a patch sweep on ``shape``; depends on
    the shape alone, and is kept per shape: a chain asks for it at every
    sweep."""
    return _patch_schedule(tuple(int(s) for s in shape))


@functools.lru_cache(maxsize=16)
def _patch_schedule(shape) -> PatchSchedule:
    n0, n1, n2 = shape
    phases = []
    for a0 in range(M):
        for a1 in range(M):
            lines = tuple((a0 + M * p, a1 + M * q)
                          for p in range(_centres(n0, a0)) for q in range(_centres(n1, a1)))
            ks = tuple(tuple(range(a2, n2, M)) for a2 in range(M))
            phases.append(PatchPhase(a0, a1, lines, ks))
    return PatchSchedule((n0, n1, n2), tuple(phases))


def patch_sweep_resident(shape, with_b: bool) -> bool:
    """Does the whole-sweep kernel (#10) serve this grid?  True when x,
    and b when given, fit in half the card's L2 (128^3 does, 256^3 not)."""
    return 4 * math.prod(shape) * (2 if with_b else 1) <= L2_BYTES // 2


def patch_prefixes(seed: int, step: int) -> tuple:
    """The hash prefix of each member's draws for one sweep."""
    return tuple(_noise.hash_prefix(seed, step, _noise.PATCH_DOMAIN + j) for j in range(K))


def _check_args(x, b):
    if x.ndim != 3:
        raise ValueError(f"patch sweep needs a 3D grid, got {tuple(x.shape)}")
    if x.numel() >= 2**32:
        raise ValueError("the noise counter is 32-bit: grids need fewer than 2^32 points")
    if b is not None and b.shape != x.shape:
        raise ValueError(f"b shape {tuple(b.shape)} != x shape {tuple(x.shape)}")


def _fapply(v, d, h2):
    """F v = d v - h2 (sum of the 6 neighbours), zero outside the grid."""
    s = _twin.shift
    return d * v - h2 * (
        s(v, 0, -1) + s(v, 0, 1) + s(v, 1, -1) + s(v, 1, 1) + s(v, 2, -1) + s(v, 2, 1)
    )


class _PatchTwin:
    """The plain-torch patch update on any set of centres strided by 5 on
    each axis: the twin's arithmetic, shared by the colour order
    (:func:`fused_patch_sweep_sqfd_reference`) and by emulations of other
    orders (the tests' run of :func:`patch_schedule`)."""

    def __init__(self, x, b, kappa2, hinv2, seed, step, with_noise):
        _check_args(x, b)
        shape, dt, dev = tuple(x.shape), x.dtype, x.device
        self.shape = shape
        self.k2, self.h2 = _twin.scalar(kappa2, dt, dev), _twin.scalar(hinv2, dt, dev)
        links = link_count(shape, dt, dev)
        self.d = self.k2 + self.h2 * links
        pad = lambda v: torch.nn.functional.pad(v, [1, 1] * 3)
        self.pad = pad
        # padded by one ring: a member's values are a strided view of these
        self.dp, self.lp = pad(self.d), pad(links)
        self.inp = pad(torch.ones(shape, dtype=dt, device=dev))
        self.out = pad(x)
        self.bt = torch.zeros_like(x) if b is None else b
        # every (centre, member) draw of the sweep, drawn once over the grid,
        # so that a set's draws do not depend on how the centres are grouped
        flat = _twin.flat_index(shape, dev)
        self.eta = [_noise.eta_hash(p, flat, dt) for p in patch_prefixes(seed, step)] \
            if with_noise else None

    def result(self):
        return self.out[1:-1, 1:-1, 1:-1].contiguous()

    def update(self, start, count):
        """Resample, in place, the patches centred at start[d] + 5 m,
        m < count[d], on each axis d: every one from the current state."""
        if min(count) <= 0:
            return
        out, d, h2 = self.out, self.d, self.h2
        hh = h2 * h2

        def sel(vp, o):
            """vp (padded) at centre + o for every centre of the set."""
            return vp[tuple(slice(1 + ai + oi, 2 + ai + oi + M * (ci - 1), M)
                            for ai, oi, ci in zip(start, o, count))]

        res = self.pad(self.bt - _fapply(_fapply(out[1:-1, 1:-1, 1:-1], d, h2), d, h2))
        masks = [sel(self.inp, o) for o in MEMBERS]
        xs = [sel(out, o) for o in MEMBERS]
        rs = [sel(res, o) for o in MEMBERS]
        ds = [sel(self.dp, o) for o in MEMBERS]
        lk = [sel(self.lp, o) for o in MEMBERS]

        def ass(i, j):
            if i == j:
                return (ds[i] * ds[i] + hh * lk[i]) * masks[i] + (1.0 - masks[i])
            oi, oj = MEMBERS[i], MEMBERS[j]
            rel = [q - p for p, q in zip(oi, oj)]
            mm = masks[i] * masks[j]
            if sum(abs(q) for q in rel) == 1:
                return -h2 * (ds[i] + ds[j]) * mm
            if sum(q != 0 for q in rel) == 1:  # 2e apart: the path via the centre
                return hh * mm
            corner = tuple(p + q for p, q in zip(oi, oj))
            return hh * (1.0 + sel(self.inp, corner)) * mm

        A = [[ass(i, j) for j in range(i + 1)] for i in range(K)]
        rhs = []
        for i in range(K):
            acc = masks[i] * rs[i]
            for j in range(K):
                acc = acc + (A[i][j] if j <= i else A[j][i]) * xs[j]
            rhs.append(acc)

        L = [[None] * K for _ in range(K)]
        for i in range(K):
            for j in range(i + 1):
                s = A[i][j]
                for t in range(j):
                    s = s - L[i][t] * L[j][t]
                L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
        z = []
        for i in range(K):
            s = rhs[i]
            for j in range(i):
                s = s - L[i][j] * z[j]
            z.append(s / L[i][i])
        if self.eta is not None:
            at = tuple(slice(ai, ai + M * (ci - 1) + 1, M) for ai, ci in zip(start, count))
            ets = [e[at] for e in self.eta]
        else:
            ets = [torch.zeros_like(z[0])] * K
        y = [None] * K
        for i in reversed(range(K)):
            s = z[i] + ets[i]
            for j in range(i + 1, K):
                s = s - L[j][i] * y[j]
            y[i] = s / L[i][i]

        # patches of the set never share a member: write them in place
        for i, o in enumerate(MEMBERS):
            view = sel(out, o)
            view.copy_(torch.where(masks[i] > 0.5, y[i], view))


def fused_patch_sweep_sqfd_reference(x, b, kappa2, hinv2, seed, step, *, with_noise=True):
    """Plain-torch twin of :func:`fused_patch_sweep_sqfd` (any device).

    Follows the TPU kernel's closed form (``_group_slab``) on each
    colour's strided subgrid of centres, in the colour order; the residual
    is F(F x) over the whole grid.  It builds no stencil of A, so it is
    independent of ``PatchGibbsSampler.step_with_noise``."""
    twin = _PatchTwin(x, b, kappa2, hinv2, seed, step, with_noise)
    for c in range(M**3):
        a = (c // (M * M), (c // M) % M, c % M)
        twin.update(a, [_centres(n, ai) for n, ai in zip(twin.shape, a)])
    return twin.result()


def _launch(x, b, kappa2, hinv2, seed, step, with_noise, entry):
    """Launch the C function ``pmg_patch_sweep<entry>`` on CUDA tensors;
    count it under ``patch_sweep<entry>``."""
    if x.device.type != "cuda":
        raise ValueError(f"no patch sweep kernel for device {x.device}")
    _check_args(x, b)
    for name, t in (("x", x), ("b", b)):
        if t is not None:
            kernels.check_input(name, t, x)
    if entry != "_colourwise" and x.shape[2] > MAX_N2:
        raise ValueError(f"rows of {x.shape[2]} cells do not fit the patch kernels' "
                         f"staged lines (at most {MAX_N2})")
    lib = kernels.lib()
    out = torch.empty_like(x)
    prefixes = (ctypes.c_uint32 * K)(*patch_prefixes(seed, step))
    with torch.cuda.device(x.device):
        err = getattr(lib, f"pmg_patch_sweep{entry}")(
            x.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(), *x.shape,
            _twin.f32(kappa2), _twin.f32(hinv2), prefixes, int(with_noise),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check_launch(err, f"patch_sweep{entry}")
    return out


def fused_patch_sweep_sqfd_streamed(x, b, kappa2, hinv2, seed, step, *, with_noise=True):
    """x': one patch sweep with the state in device memory (#11): one
    launch a phase of :func:`patch_schedule` (25), enqueued by one C call.
    CPU tensors run the twin; CUDA tensors (float32, contiguous) launch
    ``csrc/patch_sweep.cu`` or raise."""
    if x.device.type == "cpu":
        return fused_patch_sweep_sqfd_reference(
            x, b, kappa2, hinv2, seed, step, with_noise=with_noise
        )
    return _launch(x, b, kappa2, hinv2, seed, step, with_noise, "_streamed")


def fused_patch_sweep_sqfd_colourwise(x, b, kappa2, hinv2, seed, step, *, with_noise=True):
    """x': the sweep of :func:`fused_patch_sweep_sqfd` in the colour order
    itself, one launch a colour (125), every read in device memory: the
    check that #10 and #11 follow the colour order bit for bit.  No
    sampler path calls it.  CPU tensors run the twin; CUDA tensors launch
    ``csrc/patch_sweep.cu`` or raise."""
    if x.device.type == "cpu":
        return fused_patch_sweep_sqfd_reference(
            x, b, kappa2, hinv2, seed, step, with_noise=with_noise
        )
    return _launch(x, b, kappa2, hinv2, seed, step, with_noise, "_colourwise")


def fused_patch_sweep_sqfd(x, b, kappa2, hinv2, seed, step, *, with_noise=True):
    """x': one coloured vertex-star patch-Gibbs sweep of (kappa2 + hinv2
    links)^2 (#10).  ``b=None`` reads no b and equals b = 0.

    CPU tensors run :func:`fused_patch_sweep_sqfd_reference`.  CUDA
    tensors launch the whole-sweep cooperative kernel when
    :func:`patch_sweep_resident` holds, else
    :func:`fused_patch_sweep_sqfd_streamed`; a refused launch raises."""
    if x.device.type == "cpu":
        return fused_patch_sweep_sqfd_reference(
            x, b, kappa2, hinv2, seed, step, with_noise=with_noise
        )
    if not patch_sweep_resident(tuple(x.shape), b is not None):
        return fused_patch_sweep_sqfd_streamed(
            x, b, kappa2, hinv2, seed, step, with_noise=with_noise
        )
    return _launch(x, b, kappa2, hinv2, seed, step, with_noise, "")
