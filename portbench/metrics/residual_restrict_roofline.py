"""Share of its roofline of the fused residual and restriction
(``kernels.residual_restrict.residual_restrict``,
``csrc/residual_restrict.cu``): the summed bound of a step's calls, the
fine residual and every smoothed level's (``rooflines_residual``), times
the steps traced, over the device time of the kernel below."""

from portbench import rooflines_residual

KERNELS = ("residual_restrict_kernel",)


def read(ctx):
    if ctx.trace is None or not ctx.steps_traced:
        return None
    calls, secs = ctx.trace.kernel_time(KERNELS)
    if not calls or secs <= 0:
        return None
    s = ctx.config["sampler"]
    bound = rooflines_residual.step_bound_s(int(ctx.config["n"]), int(s["coarsest_size"]))
    return 100.0 * bound * ctx.steps_traced / secs
