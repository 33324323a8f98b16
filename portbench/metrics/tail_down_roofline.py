"""Share of its roofline of the tail function (#2,
``mg_tail.fused_tail_down``): every level below level 0 of the prior's
aggregate hierarchy down to the coarsest, one cooperative call a step."""

from portbench import rooflines

KERNELS = ("tail_grid_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    calls, secs = ctx.trace.kernel_time(KERNELS)
    if not calls or secs <= 0:
        return None
    ext = rooflines.levels(int(ctx.config["n"]), int(ctx.config["sampler"]["coarsest_size"]))
    nbytes, ops = rooflines.tail_down(ext[1:])
    return 100.0 * calls * rooflines.bound_s(nbytes, ops) / secs
