"""The least time the card could take for the window cell updates the
sparse torus issued in the window's jobs, over the device time of every
operation in them (device trace for the time, program spans for the
work; `peaks.py` derives the floors).

The work is the `sparse.macro` spans that start inside a job's in-job
interval (its first sighted pair to its final one): each is one K1 or K2
call of k turns on a window of h rows of wp words, h x wp x 32 x k cell
updates, followed by one K8 call on its result. A macro's least time is
the larger of its operations' floor (`peaks.cell_updates_ceiling`) and
its bytes' floor: the stepping call reads and writes the window at two
bits a cell, K8 reads it once. The device time is the sum of the
durations of the device operations inside the in-job intervals, mapped
onto the trace's clock by the offset between the window's span and the
sighting that opened it. None without a trace, a known card, device
operations in the jobs or such spans (a program without them)."""

from yardstick import peaks

SPAN = "sparse.macro"


def read(ctx):
    if (ctx.trace is None or ctx.spec is None
            or "in_job" not in ctx.out or "t_open" not in ctx.out):
        return None
    offset = ctx.window[0] - ctx.out["t_open"]
    busy = sum(e - s for lo, hi in ctx.out["in_job"]
               for s, e, _ in ctx.trace.device_in(lo + offset, hi + offset))
    if busy <= 0:
        return None
    from gol_tpu_torch.obs import trace as obs_trace

    ceiling = peaks.cell_updates_ceiling(ctx.spec, ctx.sms)
    hbm = ctx.spec["hbm_bytes_per_s"]
    least = 0.0
    found = False
    for s in obs_trace.TRACER.finished_spans():
        if s["name"] != SPAN or not any(lo <= s["start"] <= hi
                                        for lo, hi in ctx.out["in_job"]):
            continue
        a = s.get("attrs") or {}
        words = a["h"] * a["wp"]
        t_ops = words * 32 * a["k"] / ceiling
        t_bytes = (words * 4 * 2 + words * 4) / hbm
        least += max(t_ops, t_bytes)
        found = True
    return 100.0 * least / busy if found else None
