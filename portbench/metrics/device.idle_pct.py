"""Share of the traced stretch in which no operation ran on the device."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
