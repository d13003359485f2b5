"""The readers of the program's spans (`chunk_issue_us`,
`chunk_publish_us`, `idle_in_issue_pct`, `ramp_s`) on a synthetic span
set and trace: the window's chunks chosen by turn, the clock offset
recovered from a planted shift, None past the 50 µs residual, on a CPU
trace, and on a program without the spans."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from yardstick import registry
from yardstick.cell import Ctx
from yardstick.trace import SPAN_PREFIX, Trace

from gol_tpu_torch.obs import trace as obs_trace

READERS = ("chunk_issue_us", "chunk_publish_us", "idle_in_issue_pct",
           "ramp_s")
TRUE_SHIFT = 1234.5678  # trace clock = monotonic + this
PLANT = 300e-6  # the window's span opens this long after its sighting
T0 = 100.0  # monotonic time of the first chunk's issue
CHUNK_S = 0.01
TID = 7


@pytest.fixture(autouse=True)
def _fresh_tracer():
    obs_trace.TRACER.reset()
    yield
    obs_trace.TRACER.reset()


def _module(name):
    return registry._module(
        os.path.join(registry.BENCH_DIR, "layer_metrics", name + ".py"),
        "test")


def _plant_spans(chunks: int = 10, issue_s: float = 0.004,
                 publish_s: float = 0.0005, with_ramp: bool = True):
    """Chunk i (turn 100 (i + 1)) issues over [T0 + i CHUNK_S, + issue_s
    (1 + i/100)], waits to T0 + (i + 1) CHUNK_S - publish_s, then
    publishes. Monotonic stamps."""
    rec = obs_trace.TRACER.record
    for i in range(chunks):
        t = T0 + i * CHUNK_S
        turn = 100 * (i + 1)
        rec("engine.issue", t, t + issue_s * (1 + i / 100), None,
            {"k": 100, "turn": turn})
        end = T0 + (i + 1) * CHUNK_S
        rec("engine.wait", t + issue_s * 2, end - publish_s, None,
            {"turn": turn})
        rec("engine.publish", end - publish_s, end, None,
            {"turn": turn, "chunk": 100})
    if with_ramp:
        rec("engine.ramp", T0 - 0.75, T0, None, {"chunks": 4})


def _trace_file(tmp_path, *, device: bool = True, jitter_s: float = 2e-6,
                seed: int = 0):
    """A Chrome trace on the clock monotonic + TRUE_SHIFT: the window's
    span over chunks 2..8, the token waits on the engine's thread
    (starting 2 us, give or take `jitter_s`, after the wait spans' starts
    and ending 50 us before their ends, where the count is summed), other
    waits on a second thread, and (with `device`) kernels that fill the
    window but for a gap inside each chunk's issue (0.7 ms) and one
    outside it (0.3 ms)."""
    rng = np.random.default_rng(seed)
    us = lambda t: (t + TRUE_SHIFT) * 1e6  # noqa: E731
    events = []
    lo, hi = T0 + 2 * CHUNK_S, T0 + 8 * CHUNK_S
    events.append({"ph": "X", "cat": "user_annotation",
                   "name": SPAN_PREFIX + "window", "ts": us(lo + PLANT),
                   "dur": (hi - lo) * 1e6})
    for r in obs_trace.TRACER.finished_spans():
        if r["name"] != "engine.wait":
            continue
        s = r["start"] + 2e-6 + rng.uniform(-jitter_s, jitter_s)
        events.append({"ph": "X", "cat": "cuda_runtime", "name":
                       "cudaEventSynchronize", "ts": us(s),
                       "dur": (r["end"] - 50e-6 - s) * 1e6, "tid": TID})
        events.append({"ph": "X", "cat": "cuda_runtime", "name":
                       "cudaEventSynchronize", "ts": us(r["start"] + 0.003),
                       "dur": 10.0, "tid": TID + 1})
    if device:
        at = T0
        for i in range(10):
            t = T0 + i * CHUNK_S
            for g0, g1 in ((t + 0.001, t + 0.0017),
                           (t + 0.006, t + 0.0063)):
                events.append({"ph": "X", "cat": "kernel", "name": "k",
                               "ts": us(at), "dur": (g0 - at) * 1e6})
                at = g1
        events.append({"ph": "X", "cat": "kernel", "name": "k",
                       "ts": us(at), "dur": (T0 + 0.2 - at) * 1e6})
    path = str(tmp_path / "trace.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return path


def _ctx(path):
    ctx = Ctx(out={"window": ((T0 + 2 * CHUNK_S, 300, 1),
                              (T0 + 8 * CHUNK_S, 800, 1)),
                   "t_open": T0 + 2 * CHUNK_S, "chunks": 6},
              height=8, width=8, cells=64, setup_s=1.0)
    ctx.trace = Trace(path)
    ctx.window = ctx.trace.window("window")
    return ctx


def _read(name, ctx):
    return registry.metric_reader(name)(ctx)


def test_window_chunks_chosen_by_turn(tmp_path):
    _plant_spans()
    ctx = _ctx(_trace_file(tmp_path))
    # Turns 400..800: chunks 3..7, issue 4 ms x (1 + i/100).
    want = np.mean([0.004 * (1 + i / 100) for i in range(3, 8)]) * 1e6
    assert _read("chunk_issue_us", ctx) == pytest.approx(want)
    assert _read("chunk_publish_us", ctx) == pytest.approx(500.0)
    assert _read("ramp_s", ctx) == pytest.approx(0.75)


def test_offset_recovered_from_a_planted_shift(tmp_path):
    _plant_spans()
    ctx = _ctx(_trace_file(tmp_path))
    mod = _module("idle_in_issue_pct")
    offset, resid = mod.clock_offset(ctx, obs_trace.TRACER.finished_spans())
    assert ctx.window[0] - ctx.out["t_open"] == pytest.approx(
        TRUE_SHIFT + PLANT, abs=1e-6)
    # The call starts 2 us after the span: the offset is off by that.
    assert offset == pytest.approx(TRUE_SHIFT + 2e-6, abs=2e-6)
    assert resid <= 2e-6
    # Of each chunk's 1 ms of idle, the 0.7 ms gap lies in its issue.
    assert _read("idle_in_issue_pct", ctx) == pytest.approx(70.0, abs=0.2)


def test_none_past_the_residual_limit(tmp_path):
    _plant_spans()
    ctx = _ctx(_trace_file(tmp_path, jitter_s=400e-6, seed=3))
    mod = _module("idle_in_issue_pct")
    _, resid = mod.clock_offset(ctx, obs_trace.TRACER.finished_spans())
    assert resid > mod.MAX_RESIDUAL_S
    assert _read("idle_in_issue_pct", ctx) is None


def test_none_on_a_cpu_trace(tmp_path):
    _plant_spans()
    ctx = _ctx(_trace_file(tmp_path, device=False))
    for name in READERS:
        assert _read(name, ctx) is None, name


def test_none_without_the_spans(tmp_path):
    """A program without the spans (the parent of the change that added
    them): the readers find nothing and raise nothing."""
    _plant_spans()
    path = _trace_file(tmp_path)
    obs_trace.TRACER.reset()
    ctx = _ctx(path)
    for name in READERS:
        assert _read(name, ctx) is None, name
