"""Share of its roofline of the from-zero down-phase kernel (#3,
``mg_sweep.fused_zero_gibbs_restrict_fd``) on every smoothed level below
level 0: the bound of a step's calls (``rooflines_march``), times the
steps traced, over the device time of the launches below.

#3 is the x-less mode of ``chain_march_kernel<kX, kNoise>`` (kX false)."""

from portbench import rooflines, rooflines_march

KERNELS = ("chain_march_kernel<false",)


def read(ctx):
    if ctx.trace is None or not ctx.steps_traced:
        return None
    calls, secs = ctx.trace.kernel_time(KERNELS)
    if not calls or secs <= 0:
        return None
    ext = rooflines.levels(int(ctx.config["n"]), int(ctx.config["sampler"]["coarsest_size"]))
    bound = rooflines.bound_s(*rooflines_march.zero_restrict(ext[1:]))
    return 100.0 * bound * ctx.steps_traced / secs
