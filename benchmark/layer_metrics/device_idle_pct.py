"""Share of the unbounded run's window in which no operation ran on the
device: 100 x (1 - union of device intervals / window) (device trace)."""

from yardstick import stats


def read(ctx):
    if ctx.trace is None:
        return None
    lo, hi = ctx.window
    if not ctx.trace.device_in(lo, hi):
        return None
    return stats.idle_share(ctx.device_union(lo, hi), lo, hi)
