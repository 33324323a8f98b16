"""Device time of the step's work outside the port's own kernels, a chain
step: every traced device interval (kernels, copies, sets) whose name is
none of the hand-written kernels', over the steps traced.  On the
aggregate V(2,2) these are the plain-torch residuals, restrictions and
prolong-adds of the general cycle, the zero fills, the coarse sample and
the copies; it falls as kernels take them."""

OWN = ("chain_march_kernel", "tail_grid_kernel", "sweep_march_kernel", "patch_",
       "galerkin_sweep_kernel", "residual_restrict_kernel", "prolong_add_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.steps_traced or not ctx.trace.device:
        return None
    secs = sum(e - s for s, e, n in ctx.trace.device if not any(k in n for k in OWN)) * 1e-9
    return 1e3 * secs / ctx.steps_traced
