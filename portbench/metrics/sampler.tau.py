"""The window's IACT: the frozen emcee estimate (c = 5) of the QOI trace,
averaged over chains."""

from portbench import stats


def read(ctx):
    if ctx.qoi is None or ctx.qoi.shape[-1] < 2:
        return None
    return stats.mean_tau(ctx.qoi)
