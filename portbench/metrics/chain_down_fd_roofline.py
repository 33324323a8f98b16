"""Share of its roofline of the level-0 chain function (#1,
``mg_sweep.fused_chain_down_fd``): the bound of a call at the cell's
shapes over the mean device time of the kernels below, one call a step.

The bound reads x, the coarse carry z of the deferred chain, and b on a
posterior; it writes x + y and the restricted residual."""

from portbench import rooflines

KERNELS = ("chain_march_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    calls, secs = ctx.trace.kernel_time(KERNELS)
    if not calls or secs <= 0:
        return None
    posterior = ctx.traffic.get("observations") is not None
    nbytes, ops = rooflines.chain_down_fd(int(ctx.config["n"]), with_b=posterior, with_z=True)
    return 100.0 * calls * rooflines.bound_s(nbytes, ops) / secs
