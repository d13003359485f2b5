"""Host microseconds the engine chunk loop spends issuing a chunk: every
launch, the count's copy and its event (program spans: the mean
`engine.issue` span of the chunks the window published, those whose turn
lies in (first, last] of the window's sighted pairs).

The engine records the span while a profiler runs in its process, so a
traced run reads it, each launch paying the profiler's host cost. None
where the trace holds no device operation in the window (a CPU run) or
no such span (a program without it)."""

SPAN = "engine.issue"


def read(ctx):
    if ctx.trace is None or "window" not in ctx.out:
        return None
    lo, hi = ctx.window
    if not ctx.trace.device_in(lo, hi):
        return None
    from gol_tpu_torch.obs import trace as obs_trace

    first, last = ctx.out["window"]
    took = [s["end"] - s["start"] for s in obs_trace.TRACER.finished_spans()
            if s["name"] == SPAN
            and first[1] < (s.get("attrs") or {}).get("turn", -1) <= last[1]]
    return 1e6 * sum(took) / len(took) if took else None
