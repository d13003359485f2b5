"""The engine chunk loop's host microseconds a chunk outside the wait
for its token, over the traced window alone (device trace: the CUDA
runtime calls the profiler records on each thread).

The engine's thread is the one that spends most of the window in
`cudaEventSynchronize`, the token wait. From the end of the wait that
published the window's first pair to the end of the wait that published
its last, the thread's time outside those waits, over the chunks
published between them, is the host's time a chunk: issue, publish,
adapter, telemetry. Under the profiler each launch also pays CUPTI's
host cost, in every traced run alike."""

WAIT = "cudaEventSynchronize"


def read(ctx):
    if ctx.trace is None or not ctx.out.get("chunks"):
        return None
    lo, hi = ctx.window
    by_tid: dict = {}
    for s, e, tid in ctx.trace.calls.get(WAIT, []):
        by_tid.setdefault(tid, []).append((s, e))
    if not by_tid:
        return None
    waits = max(by_tid.values(), key=lambda v: sum(
        max(0.0, min(e, hi) - max(s, lo)) for s, e in v))
    ends = [e for _, e in waits]
    a = max((e for e in ends if e <= lo), default=None)
    b = max((e for e in ends if e <= hi), default=None)
    if a is None or b is None or b <= a:
        return None
    waited = sum(e - max(s, a) for s, e in waits if a < e <= b)
    return 1e6 * ((b - a) - waited) / ctx.out["chunks"]
