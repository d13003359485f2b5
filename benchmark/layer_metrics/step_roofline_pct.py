"""The least time the card could take for the cell updates stepped in
the traced window, over the device time of everything that ran on the
device in it (device trace; `peaks.py` derives the floor).

The cell updates are the turns between the window's first and last
sighted pairs times the board's cells; the calls, for the bytes floor,
are the kernels that started in the window."""

from yardstick import peaks


def read(ctx):
    if ctx.trace is None or ctx.spec is None or "window" not in ctx.out:
        return None
    lo, hi = ctx.window
    ops = ctx.trace.device_in(lo, hi)
    busy = sum(e - s for s, e, _ in ops)
    if busy <= 0:
        return None
    calls = sum(1 for s, _, _ in ctx.trace.kernels if lo <= s < hi)
    first, last = ctx.out["window"]
    least, _ = peaks.least_seconds((last[1] - first[1]) * ctx.cells, calls,
                                   ctx.cells, ctx.spec, ctx.sms)
    return 100.0 * least / busy
