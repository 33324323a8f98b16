"""Share of its roofline of the staged large-plane chain kernel (#5,
``mg_sweep.fused_chain_down_2d_staged``): the bound of a call at the
cell's shapes over the mean device time of the launches below, one a step.

#5 computes #1's function (``rooflines.chain_down_fd``: reads x and the
coarse carry z, writes x + y and the restricted residual).  #1, #5 and #3
are one kernel, ``chain_march_kernel<kX, kNoise>``; the launches with an x
stream (kX true) are #5's where level 0's plane is past the plane limit."""

from portbench import rooflines

KERNELS = ("chain_march_kernel<true",)


def read(ctx):
    if ctx.trace is None:
        return None
    calls, secs = ctx.trace.kernel_time(KERNELS)
    if not calls or secs <= 0:
        return None
    nbytes, ops = rooflines.chain_down_fd(int(ctx.config["n"]), with_b=False, with_z=True)
    return 100.0 * calls * rooflines.bound_s(nbytes, ops) / secs
