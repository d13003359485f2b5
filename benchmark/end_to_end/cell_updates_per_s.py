"""Cell updates a second: the turns between the window's first and last
sighted published pairs, over the wall time between the two sightings,
times the board's cells (host clock)."""

from yardstick import stats


def read(ctx):
    if "window" not in ctx.out:
        return None
    first, last = ctx.out["window"]
    return stats.sighting_rate(first, last) * ctx.cells
