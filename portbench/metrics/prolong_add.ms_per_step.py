"""Device time of the fused prolong-add kernel (``csrc/prolong_add.cu``)
in the traced stretch, a chain step."""

KERNELS = ("prolong_add_kernel",)


def read(ctx):
    if ctx.trace is None or not ctx.steps_traced:
        return None
    calls, secs = ctx.trace.kernel_time(KERNELS)
    if not calls or secs <= 0:
        return None
    return 1e3 * secs / ctx.steps_traced
