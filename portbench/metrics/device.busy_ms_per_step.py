"""The union of the device's activity in the traced stretch, a chain step."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not ctx.steps_traced:
        return None
    return 1e3 * tr.busy_s / ctx.steps_traced
