"""Seconds the engine chunk loop ramps its chunk: from the run's first
issue, which loads or builds the kernel library, to the pop that ends
the ramp regime (program spans: the run's `engine.ramp`, which the
engine records once a run, traced or not).

Read in a traced run only, as every per-layer metric is. None where the
trace holds no device operation in the window (a CPU run) or the run
recorded no such span (a program without it)."""

SPAN = "engine.ramp"


def read(ctx):
    if ctx.trace is None:
        return None
    lo, hi = ctx.window
    if not ctx.trace.device_in(lo, hi):
        return None
    from gol_tpu_torch.obs import trace as obs_trace

    ramps = [s for s in obs_trace.TRACER.finished_spans()
             if s["name"] == SPAN]
    return ramps[0]["end"] - ramps[0]["start"] if ramps else None
