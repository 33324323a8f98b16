"""Device time of the fused residual and restriction kernel
(``csrc/residual_restrict.cu``) in the traced stretch, a chain step."""

KERNELS = ("residual_restrict_kernel",)


def read(ctx):
    if ctx.trace is None or not ctx.steps_traced:
        return None
    calls, secs = ctx.trace.kernel_time(KERNELS)
    if not calls or secs <= 0:
        return None
    return 1e3 * secs / ctx.steps_traced
