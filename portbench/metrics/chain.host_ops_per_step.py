"""Top-level torch ops the host dispatched in the traced stretch, a chain
step (the chain driver's loop, the sampler's ops, the QOI's readback)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.host_ops or not ctx.steps_traced:
        return None
    return len(ctx.trace.host_ops) / ctx.steps_traced
