"""Share of its roofline of the marching FD sweep (#9 on planes past the
plane limit, #7 below; one CUDA kernel, ``sweep_march_kernel<false,
true>`` with its noise on): the summed bound of a step's sweeps,
n_pre + n_post a smoothed level (``rooflines_sweep``), times the steps
traced, over the device time of the kernel."""

from portbench import rooflines_sweep

KERNELS = ("sweep_march_kernel<false, true",)


def read(ctx):
    if ctx.trace is None or not ctx.steps_traced:
        return None
    calls, secs = ctx.trace.kernel_time(KERNELS)
    if not calls or secs <= 0:
        return None
    s = ctx.config["sampler"]
    bound = rooflines_sweep.step_bound_s(int(ctx.config["n"]), int(s["coarsest_size"]),
                                         int(s["n_pre"]) + int(s["n_post"]))
    return 100.0 * bound * ctx.steps_traced / secs
