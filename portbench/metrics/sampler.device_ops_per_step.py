"""Device operations (kernels, copies, sets) in the traced stretch, a
chain step."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.steps_traced:
        return None
    return len(ctx.trace.device) / ctx.steps_traced
