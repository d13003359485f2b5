"""Episodes of the sparse torus a job: the `sparse.margins` spans (one
an episode: the occupancy's copy to the host that the next episode's
macro-steps wait for) that start in the window's jobs' in-job intervals
(each job's first sighted pair to its final one), over the number of
those jobs (program spans; the engine records them while the span gate
is open, which the profiler of a traced run opens). None where the
trace holds no device operation in the jobs (a CPU run) or the program
records no such span."""

SPAN = "sparse.margins"


def read(ctx):
    if (ctx.trace is None or "in_job" not in ctx.out
            or "t_open" not in ctx.out):
        return None
    offset = ctx.window[0] - ctx.out["t_open"]
    spans = ctx.out["in_job"]
    if not any(ctx.trace.device_in(lo + offset, hi + offset)
               for lo, hi in spans):
        return None
    from gol_tpu_torch.obs import trace as obs_trace

    starts = [s["start"] for s in obs_trace.TRACER.finished_spans()
              if s["name"] == SPAN]
    if not starts:
        return None
    n = sum(1 for t in starts if any(lo <= t <= hi for lo, hi in spans))
    return n / len(spans)
