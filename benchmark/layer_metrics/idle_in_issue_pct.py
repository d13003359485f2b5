"""Share of the window's device-idle time during which the engine's
thread was issuing a chunk (program spans on the device trace's clock:
the gaps of `device_idle_pct`'s union of device intervals, covered by
the run's `engine.issue` spans). High: the device waits on the host's
issue of launches; low: its gaps lie elsewhere, as at the token wait.

The spans' monotonic stamps are mapped onto the trace's clock by the
offset between the window's span and the sighting that opened it
(`ctx.window[0] - ctx.out["t_open"]`), refined by the median residual
between the starts of the window's `engine.wait` spans and the nearest
starts of `cudaEventSynchronize` on the engine's thread (the thread that
spends most of the window in it, as `chunk_overhead_us` finds it). The
starts, not the ends: a wait span goes on past the synchronize by the
count's sum, 60-160 us on a traced H100 run, which would shift every
span by as much; its start precedes the call by a Python call alone.
The offset and the median absolute residual go to standard error. None
where that residual exceeds `MAX_RESIDUAL_S`, the device never idled in
the window, the trace holds no device operation in it (a CPU run), or
no `engine.issue` span lies in it."""

import bisect
import statistics
import sys

from yardstick import stats

WAIT = "cudaEventSynchronize"
MAX_RESIDUAL_S = 50e-6


def engine_wait_starts(ctx, lo: float, hi: float) -> list:
    """Sorted starts of the token waits of the thread that spends most
    of [lo, hi] in them (trace clock)."""
    by_tid: dict = {}
    for s, e, tid in ctx.trace.calls.get(WAIT, []):
        by_tid.setdefault(tid, []).append((s, e))
    if not by_tid:
        return []
    waits = max(by_tid.values(), key=lambda v: sum(
        max(0.0, min(e, hi) - max(s, lo)) for s, e in v))
    return sorted(s for s, _ in waits)


def residuals(calls: list, stamps: list, offset: float) -> list:
    """For each monotonic stamp, the nearest sorted trace-clock stamp of
    `calls` less the stamp mapped by `offset`."""
    out = []
    for t in stamps:
        m = t + offset
        i = bisect.bisect_left(calls, m)
        near = [calls[j] for j in (i - 1, i) if 0 <= j < len(calls)]
        out.append(min(near, key=lambda c: abs(c - m)) - m)
    return out


def clock_offset(ctx, spans: list):
    """(offset, median absolute residual) that maps the program's
    monotonic stamps onto the trace's clock, or None without waits on
    either side."""
    lo, hi = ctx.window
    calls = engine_wait_starts(ctx, lo, hi)
    offset = lo - ctx.out["t_open"]
    stamps = [s["start"] for s in spans if s["name"] == "engine.wait"
              and lo <= s["start"] + offset <= hi]
    if not calls or not stamps:
        return None
    offset += statistics.median(residuals(calls, stamps, offset))
    return offset, statistics.median(
        abs(r) for r in residuals(calls, stamps, offset))


def read(ctx):
    if ctx.trace is None or "t_open" not in ctx.out:
        return None
    lo, hi = ctx.window
    if not ctx.trace.device_in(lo, hi):
        return None
    from gol_tpu_torch.obs import trace as obs_trace

    spans = obs_trace.TRACER.finished_spans()
    mapped = clock_offset(ctx, spans)
    if mapped is None:
        return None
    offset, resid = mapped
    print(f"idle_in_issue_pct clock offset {offset:.6f} s, median "
          f"residual {resid * 1e6:.1f} us", file=sys.stderr)
    if resid > MAX_RESIDUAL_S:
        return None
    issues = stats.union(
        (s["start"] + offset, s["end"] + offset) for s in spans
        if s["name"] == "engine.issue"
        and s["end"] + offset > lo and s["start"] + offset < hi)
    gaps = stats.gaps(ctx.device_union(lo, hi), lo, hi)
    idle = sum(e - s for s, e in gaps)
    if not issues or idle <= 0:
        return None
    return 100.0 * sum(stats.covered(issues, s, e) for s, e in gaps) / idle
