"""Share of its roofline of the fused prolong-add
(``kernels.prolong_add.prolong_add``, ``csrc/prolong_add.cu``): the summed
bound of a step's calls, one a smoothed level (``rooflines_prolong``),
times the steps traced, over the device time of the kernel below."""

from portbench import rooflines_prolong

KERNELS = ("prolong_add_kernel",)


def read(ctx):
    if ctx.trace is None or not ctx.steps_traced:
        return None
    calls, secs = ctx.trace.kernel_time(KERNELS)
    if not calls or secs <= 0:
        return None
    s = ctx.config["sampler"]
    bound = rooflines_prolong.step_bound_s(int(ctx.config["n"]), int(s["coarsest_size"]))
    return 100.0 * bound * ctx.steps_traced / secs
