"""Share of its roofline of the 27-point colour sweep
(``kernels.galerkin_sweep.fused_galerkin_sweep``, ``csrc/galerkin_sweep.cu``):
the summed bound of a step's half-sweeps on the levels below level 0
(``rooflines_galerkin``), times the steps traced, over the device time of
the kernel below."""

from portbench import rooflines_galerkin

KERNELS = ("galerkin_sweep_kernel",)


def read(ctx):
    if ctx.trace is None or not ctx.steps_traced:
        return None
    calls, secs = ctx.trace.kernel_time(KERNELS)
    if not calls or secs <= 0:
        return None
    s = ctx.config["sampler"]
    bound = rooflines_galerkin.step_bound_s(int(ctx.config["n"]), int(s["coarsest_size"]),
                                            int(s["n_pre"]) + int(s["n_post"]))
    return 100.0 * bound * ctx.steps_traced / secs
