"""Human-readable sampler summaries, the PCView analogue (port of
``parmgmc_tpu.describe``).

The summary walks a composed sampler and reports grids, colour counts,
the keyed step's route, omega and sweep, factor sizes and the hierarchy's
depth, in the JAX package's text, line for line.  The one difference is
the ``impl=`` token: it names the port's route, the kernel wrapper the
keyed step launches or ``torch``::

    >>> from parmgmc_tpu_torch.describe import describe
    >>> print(describe(sampler))
"""

from __future__ import annotations

import math

__all__ = ["describe"]


def _fmt_n(n: int) -> str:
    if n >= 1 << 20:
        return f"{n / (1 << 20):.1f}M"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f}K"
    return str(n)


def _op_line(op) -> str:
    name = type(op).__name__
    if name == "LRCOperator":
        return f"{name}[rank-{op.B.shape[-1]} update of {_op_line(op.base)}]"
    gshape = tuple(getattr(op, "grid_shape", ()))
    n = math.prod(gshape) if gshape else getattr(op, "n", 0)
    extra = ""
    if hasattr(op, "offsets"):
        extra = f", {len(op.offsets) + 1}-point stencil, radius {op.radius}"
    if hasattr(op, "cols"):  # GraphOperator ELL
        extra = f", ELL width {op.cols.shape[-1]}"
    return f"{name} {'x'.join(map(str, gshape))} ({_fmt_n(n)} dof{extra})"


def describe(sampler, _indent: int = 0) -> str:
    """Recursive one-screen summary of a composed sampler."""
    pad = "  " * _indent
    t = type(sampler).__name__
    lines = []
    if t == "MGMCSampler":
        lines.append(
            f"{pad}MGMCSampler: {sampler.n_levels} levels, "
            f"{'V' if sampler.gamma == 1 else 'W'}({sampler.n_pre},{sampler.n_post})-cycles"
            + (f", {sampler.n_coarse} coarse its" if sampler.n_coarse != 1 else "")
        )
        for l, op in enumerate(sampler.ops):
            lines.append(f"{pad}  level {l}: {_op_line(op)}")
            if l < sampler.n_levels - 1:
                lines.append(f"{pad}    transfer: {type(sampler.transfers[l]).__name__}; smoother:")
                lines.append(describe(sampler.smoothers[l], _indent + 3))
        lines.append(f"{pad}  coarse solver:")
        lines.append(describe(sampler.coarse, _indent + 2))
    elif t == "GibbsSampler":
        base = sampler.base
        ncolors = 2
        if hasattr(base, "is_star"):
            r = base.radius
            ncolors = (r + 1) if base.is_star() else (r + 1) ** base.ndim
        elif hasattr(base, "color_starts"):
            ncolors = len(base.color_starts) - 1
        lrc = ", low-rank corrected" if sampler.is_lrc else ""
        lines.append(
            f"{pad}GibbsSampler on {_op_line(base)}: {ncolors} colours, "
            f"omega={float(sampler.omega):g}, sweep={sampler.sweep}, impl={sampler.route}{lrc}"
        )
    elif t == "CholeskySampler":
        n = sampler.L.shape[0]
        lines.append(f"{pad}CholeskySampler: dense factor {n}x{n} ({_fmt_n(n * (n + 1) // 2)} stored entries)")
    elif t == "PatchGibbsSampler":
        k = len(sampler.patch_offsets)
        d = len(sampler.grid_shape)
        lines.append(
            f"{pad}PatchGibbsSampler on {_op_line(sampler.base)}: "
            f"{k}-node star patches, {sampler.ncolor_base ** d} colours, "
            f"on-the-fly unrolled {k}x{k} Cholesky (SoA), impl={sampler.route}"
        )
    elif t == "SparseCholeskySampler":
        lines.append(
            f"{pad}SparseCholeskySampler: host-side sparse LDL^T, "
            f"n={_fmt_n(sampler.n)}, nnz(L)={_fmt_n(sampler._lu.L.nnz)}"
            + (f", Matheron posterior (k={len(sampler._lrc['sigma'])})" if sampler._lrc is not None else "")
        )
    elif t == "GraphPatchGibbsSampler":
        lines.append(
            f"{pad}GraphPatchGibbsSampler on {_op_line(sampler.base)}: "
            f"vertex-star patches (kmax={sampler.kmax}), {sampler.ncolors} distance-4 colours, "
            f"on-the-fly unrolled Cholesky (SoA)"
        )
    elif t == "WoodburySampler":
        lines.append(f"{pad}WoodburySampler: rank-{sampler.B.shape[-1]} update; inner sampler:")
        lines.append(describe(sampler.sampler, _indent + 1))
    else:
        gshape = tuple(getattr(sampler, "grid_shape", ()))
        lines.append(f"{pad}{t} on grid {'x'.join(map(str, gshape))}")
    return "\n".join(lines)
