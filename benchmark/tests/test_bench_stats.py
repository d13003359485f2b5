"""The yardstick's arithmetic on made-up numbers and traces: the
percentile, the rate between sightings, device intervals,
the idle share, the floor of a step and the readers built on them."""

from __future__ import annotations

import json
import math

import pytest

from yardstick import peaks, registry, stats
from yardstick.cell import Ctx, breakdown
from yardstick.trace import Trace


def test_percentile_is_nearest_rank():
    vals = list(range(1, 201))  # 1..200
    assert stats.percentile(vals, 95) == 190
    assert stats.percentile(vals, 100) == 200
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2
    assert stats.percentile([1, math.inf], 95) == math.inf
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_sighting_rate():
    first, last = (0.0, 100, 7), (0.9, 300, 7)
    assert stats.sighting_rate(first, last) == pytest.approx(200 / 0.9)
    with pytest.raises(ValueError):
        stats.sighting_rate(last, first)


def test_union_covered_idle_and_gaps():
    merged = stats.union([(3, 4), (0, 1), (0.5, 2), (5, 9)])
    assert merged == [(0, 2), (3, 4), (5, 9)]
    assert stats.covered(merged, 1, 6) == pytest.approx(3)
    assert stats.idle_share(merged, 0, 10) == pytest.approx(30.0)
    assert stats.gaps(merged, 1, 10) == [(2, 3), (4, 5), (9, 10)]
    with pytest.raises(ValueError):
        stats.idle_share(merged, 2, 2)


def test_ceiling_and_least_time():
    spec = peaks.CARDS["NVIDIA H100 80GB HBM3"]
    ceiling = peaks.cell_updates_ceiling(spec, 132)
    assert ceiling == pytest.approx(132 * 4096 * 1.98e9)
    t, by = peaks.least_seconds(1e12, 1, 512 * 512, spec, 132)
    assert by == "operations" and t == pytest.approx(1e12 / ceiling)
    # a 5120^2 call of 32 turns moves more than it computes
    t, by = peaks.least_seconds(32 * 5120**2, 1, 5120**2, spec, 132)
    assert by == "bytes"
    assert t == pytest.approx(2 * 5120**2 / 8 / 3.35e12)
    assert peaks.card("some other card") is None


def _trace(tmp_path, events):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return Trace(str(p))


def _x(cat, name, ts_us, dur_us, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us,
            "dur": dur_us, "pid": 1, "tid": tid}


def test_trace_reading_and_readers(tmp_path):
    # a 1 s window: a kernel at 0.1-0.5 s, a copy at 0.45-0.55, a
    # kernel at 0.6-0.9; a poll at 0.5-0.55
    tr = _trace(tmp_path, [
        _x("user_annotation", "bench.window", 1e6, 1e6),
        _x("kernel", "k", 1.1e6, 0.4e6),
        _x("gpu_memcpy", "copy", 1.45e6, 0.1e6),
        _x("kernel", "k", 1.6e6, 0.3e6),
        _x("gpu_user_annotation", "bench.window", 1e6, 1e6),
        _x("user_annotation", "bench.poll", 1.5e6, 0.05e6),
        _x("cuda_runtime", "cudaEventSynchronize", 1.5e6, 0.2e6),
        {"ph": "i", "name": "instant", "ts": 1.2e6},
    ])
    assert tr.window("window") == pytest.approx((1.0, 2.0))
    assert len(tr.device) == 3 and len(tr.kernels) == 2
    assert tr.host_at(1.52) == "bench.poll"
    assert tr.host_at(1.65) == "cudaEventSynchronize"
    assert tr.host_at(0.5) is None
    assert tr.calls["cudaEventSynchronize"] == [
        (pytest.approx(1.5), pytest.approx(1.7), 1)]
    ctx = Ctx(out={"window": ((0.0, 1000, 5), (1.0, 3000, 5)),
                   "chunks": 2},
              cells=512 * 512, trace=tr, window=tr.window("window"),
              spec=peaks.CARDS["NVIDIA H100 80GB HBM3"], sms=132)
    idle = registry.metric_reader("device_idle_pct")(ctx)
    assert idle == pytest.approx(100 * (1 - 0.75 / 1.0))
    roof = registry.metric_reader("step_roofline_pct")(ctx)
    least, _ = peaks.least_seconds(2000 * 512 * 512, 2, 512 * 512,
                                   ctx.spec, 132)
    assert roof == pytest.approx(100 * least / 0.8)
    b = breakdown(ctx)
    assert b["device_ops"][0] == ["k", pytest.approx(0.7)]
    assert [g[0] for g in b["idle_gaps"][:2]] == ["untraced"] * 2
    assert b["idle_gaps"][2] == ["cudaEventSynchronize",
                                 pytest.approx(0.05)]


def test_chunk_overhead_reads_the_engine_thread_in_the_window(tmp_path):
    # The engine's thread (7) waits 0.9 s of each 1 s chunk; the
    # published pairs end the waits at 1, 2, 3, 4 and 5 s. Another
    # thread (8) waits briefly. The window opens just after the pair of
    # 1 s and closes just after that of 4 s: 3 chunks, each 0.1 s of
    # host time outside the wait. The waits before and after the
    # window do not count.
    events = [_x("user_annotation", "bench.window", 1.001e6, 3.0e6)]
    for k in range(5):
        events.append(_x("cuda_runtime", "cudaEventSynchronize",
                         (k + 0.1) * 1e6, 0.9e6, tid=7))
    events.append(_x("cuda_runtime", "cudaEventSynchronize", 2.5e6,
                     0.01e6, tid=8))
    tr = _trace(tmp_path, events)
    ctx = Ctx(out={"chunks": 3}, trace=tr, window=tr.window("window"))
    read = registry.metric_reader("chunk_overhead_us")
    assert read(ctx) == pytest.approx(1e5)
    ctx.out = {"chunks": 0}
    assert read(ctx) is None


def test_readers_return_nothing_without_a_trace_or_a_card(tmp_path):
    tr = _trace(tmp_path, [_x("user_annotation", "bench.window", 0, 1e6)])
    ctx = Ctx(out={"window": ((0, 0, 0), (1, 10, 0)), "chunks": 1},
              cells=4)
    for name in ("device_idle_pct", "step_roofline_pct",
                 "chunk_overhead_us"):
        assert registry.metric_reader(name)(ctx) is None
    ctx.trace, ctx.window = tr, (0.0, 1.0)
    # a window in which nothing ran on the device, and no card's peaks
    for name in ("device_idle_pct", "step_roofline_pct",
                 "chunk_overhead_us"):
        assert registry.metric_reader(name)(ctx) is None


def test_end_to_end_readers():
    ctx = Ctx(out={"window": ((2.0, 1000, 1), (12.0, 11000, 1))},
              cells=100, setup_s=9.5)
    assert registry.end_to_end_reader("cell_updates_per_s")(ctx) == \
        pytest.approx(1000 * 100)
    assert registry.end_to_end_reader("setup_s")(ctx) == 9.5
