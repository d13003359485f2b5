"""Share of the window's in-job time in which no operation ran on the
device: 100 x (1 - union of device intervals inside the jobs' in-job
intervals / their total length) (device trace; a job's in-job interval
is its first sighted pair to its final one, mapped onto the trace's
clock by the offset between the window's span and the sighting that
opened it). The gaps between jobs, where the controller writes the
window's PGM, are left out. None without a trace, jobs or device
operations in them."""

from yardstick import stats


def read(ctx):
    if (ctx.trace is None or "in_job" not in ctx.out
            or "t_open" not in ctx.out):
        return None
    offset = ctx.window[0] - ctx.out["t_open"]
    total = covered = 0.0
    found = False
    for lo, hi in ctx.out["in_job"]:
        lo, hi = lo + offset, hi + offset
        ops = ctx.trace.device_in(lo, hi)
        found = found or bool(ops)
        covered += stats.covered(stats.union((s, e) for s, e, _ in ops),
                                 lo, hi)
        total += hi - lo
    if not found or total <= 0:
        return None
    return 100.0 * (1.0 - covered / total)
