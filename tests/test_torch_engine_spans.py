"""The port's chunk-loop and controller spans (`Engine(device="cpu")`):
with the gate closed a run records `controller.run`, its PGM and tick
spans, `engine.run`, `engine.setup` and `engine.ramp` and nothing a
chunk, and its loop reads the clock six times a chunk; with a
`torch.profiler` running on another thread the gate opens and every
popped chunk gets one `engine.chunk` holding its `engine.issue`,
`engine.wait` and `engine.publish`, in that order, whose (alive, turn)
is the numpy oracle's; `engine.ramp` ends at the first pipelined chunk;
a capture's Chrome trace holds the spans on the profiler's clock; the
cumulative host counters feed `chunk_overhead_us` and their registry
families."""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

import gol_tpu_torch
from gol_tpu_torch import Params, events as ev
from gol_tpu_torch import engine as engine_mod
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.io.pgm import read_pgm
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import prof as obs_prof
from gol_tpu_torch.obs import trace
from gol_tpu_torch.ops.reference import run_turns_np

torch.set_num_threads(2)

PER_RUN = {"controller.run", "controller.read_pgm", "controller.write_pgm",
           "controller.tick", "engine.run", "engine.setup", "engine.ramp"}
PER_CHUNK = {"engine.chunk", "engine.issue", "engine.wait",
             "engine.publish", "engine.advance", "engine.flags"}


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setenv("GOL_MAX_CHUNK", "8")
    for k in ("GOL_TRACE_SPANS", "GOL_FLIGHT", "GOL_CKPT", "GOL_JOURNAL",
              "GOL_RUN_REPORT", "GOL_TRACE", "GOL_PROFILE_DIR",
              "GOL_FUSE_K"):
        monkeypatch.delenv(k, raising=False)
    trace.TRACER.reset()
    yield
    trace.TRACER.reset()


class _Recording(Engine):
    """An engine that notes the turns of every chunk it issues."""

    def __init__(self, **kw) -> None:
        super().__init__(**kw)
        self.issued: list = []

    def _chunk(self, run, cells, k):
        self.issued.append(k)
        return super()._chunk(run, cells, k)


def _run(eng, images_dir, out_dir, turns: int = 200, n: int = 64):
    q = queue.Queue()
    t = gol_tpu_torch.run(Params(threads=1, image_width=n, image_height=n,
                                 turns=turns), q, None, engine=eng,
                          images_dir=images_dir, out_dir=out_dir)
    t.join(120)
    assert not t.is_alive()
    finals = [e for e in ev.drain(q) if isinstance(e, ev.FinalTurnComplete)]
    assert finals and finals[0].completed_turns == turns


def _by_name(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


@pytest.fixture
def profiler_elsewhere():
    """A CPU `torch.profiler` running on a thread of its own until the
    test ends; yields once the process-wide flag reads it as running."""
    stop, started = threading.Event(), threading.Event()

    def hold():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            started.set()
            stop.wait(120)

    th = threading.Thread(target=hold, daemon=True)
    th.start()
    assert started.wait(120)
    deadline = time.monotonic() + 60
    while not trace.profiler_running():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    yield
    stop.set()
    th.join(60)
    assert not th.is_alive()
    assert not trace.profiler_running()


def test_gate_closed_records_only_per_run_spans(images_dir, out_dir):
    assert not trace.hot_spans_enabled()
    eng = _Recording(device="cpu")
    _run(eng, images_dir, out_dir)
    names = Counter(s["name"] for s in trace.TRACER.finished_spans())
    assert set(names) <= PER_RUN
    assert not set(names) & PER_CHUNK
    for name in ("controller.run", "controller.read_pgm",
                 "controller.write_pgm", "engine.run", "engine.setup",
                 "engine.ramp"):
        assert names[name] == 1, name
    assert len(eng.issued) > 8  # many chunks, no span of any of them


def test_engine_run_parents_under_controller_run(images_dir, out_dir):
    _run(Engine(device="cpu"), images_dir, out_dir)
    spans = _by_name(trace.TRACER.finished_spans())
    (root,), (run,) = spans["controller.run"], spans["engine.run"]
    assert root["parent"] is None
    assert run["parent"] == root["span"] and run["trace"] == root["trace"]
    for name in ("engine.setup", "engine.ramp"):
        (s,) = spans[name]
        assert s["parent"] == run["span"]
        assert run["start"] <= s["start"] <= s["end"] <= run["end"]
    (setup,), (ramp,) = spans["engine.setup"], spans["engine.ramp"]
    assert setup["start"] == run["start"] and setup["end"] == ramp["start"]
    for name in ("controller.read_pgm", "controller.write_pgm"):
        (s,) = spans[name]
        assert s["parent"] == root["span"]


class _Clock:
    """`time` for the engine module whose `monotonic` counts its calls."""

    def __init__(self) -> None:
        self.calls = 0

    def monotonic(self) -> float:
        self.calls += 1
        return time.monotonic()

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.mark.parametrize("gate,per_chunk", [("closed", 6), ("open", 7)])
def test_clock_reads_a_chunk(monkeypatch, tmp_path, gate, per_chunk):
    """Closed, the loop reads the clock as often as it did before the
    spans (six a chunk: iteration, issue, issued, wait, waited, host);
    open, once more, the pop's end. Chunks of one turn: two runs differ
    by their turns' count of chunks alone."""
    monkeypatch.setenv("GOL_MAX_CHUNK", "1")
    if gate == "open":
        monkeypatch.setenv("GOL_TRACE_SPANS", str(tmp_path / "spans.json"))
    clock = _Clock()
    monkeypatch.setattr(engine_mod, "time", clock)
    board = np.zeros((64, 64), np.uint8)
    board[10, 10:13] = 255
    counts = []
    for turns in (40, 80):
        eng = Engine(device="cpu")
        c0 = clock.calls
        eng.server_distributor(Params(threads=1, image_width=64,
                                      image_height=64, turns=turns), board)
        counts.append(clock.calls - c0)
        assert eng.stats()["chunks"] == turns
    assert counts[1] - counts[0] == per_chunk * 40
    names = {s["name"] for s in trace.TRACER.finished_spans()}
    assert ("engine.issue" in names) == (gate == "open")


def _oracle_counts(images_dir, n: int, turns: int) -> dict:
    board = (read_pgm(os.path.join(images_dir, f"{n}x{n}.pgm")) != 0)
    board = board.astype(np.uint8)
    counts = {0: int(board.sum())}
    for t in range(1, turns + 1):
        board = run_turns_np(board, 1)
        counts[t] = int(board.sum())
    return counts


def test_profiler_on_another_thread_opens_the_gate(
        images_dir, out_dir, profiler_elsewhere):
    assert trace.hot_spans_enabled() and not trace.hot_spans_from_env()
    eng = _Recording(device="cpu")
    chunks0 = eng.stats()["chunks"]
    _run(eng, images_dir, out_dir)
    spans = _by_name(trace.TRACER.finished_spans())
    (run,) = spans["engine.run"]
    chunks = spans["engine.chunk"]
    popped = eng.stats()["chunks"] - chunks0
    assert len(chunks) == len(eng.issued) == popped
    for name in ("engine.issue", "engine.wait", "engine.publish"):
        assert len(spans[name]) == popped, name
    want = _oracle_counts(images_dir, 64, 200)
    turns, at = [], 0
    for k in eng.issued:
        at += k
        turns.append(at)
    assert [c["attrs"]["turn"] for c in chunks] == turns
    children = {}
    for name in ("engine.issue", "engine.wait", "engine.publish"):
        for s in spans[name]:
            children.setdefault(s["parent"], {})[name] = s
    for c, k in zip(chunks, eng.issued):
        assert c["parent"] == run["span"]
        assert c["attrs"]["k"] == k
        assert c["attrs"]["alive"] == want[c["attrs"]["turn"]]
        kids = children[c["span"]]
        issue, wait, pub = (kids["engine.issue"], kids["engine.wait"],
                            kids["engine.publish"])
        assert (issue["attrs"]["turn"] == wait["attrs"]["turn"]
                == pub["attrs"]["turn"] == c["attrs"]["turn"])
        assert issue["attrs"]["k"] == k
        assert (c["start"] == issue["start"] <= issue["end"]
                <= wait["start"] <= wait["end"] == pub["start"]
                <= pub["end"] == c["end"])
    # `engine.advance` runs from an iteration's last pop (or its issue,
    # when nothing popped) to the next issue; the phases never overlap.
    advances = spans["engine.advance"]
    assert len(advances) == popped - 1
    starts = {s["start"] for s in spans["engine.issue"]}
    ends = {s["end"] for n in ("engine.issue", "engine.publish")
            for s in spans[n]}
    for a in advances:
        assert a["parent"] == run["span"]
        assert a["end"] in starts and a["start"] in ends
    phases = sorted((s["start"], s["end"]) for n in (
        "engine.issue", "engine.wait", "engine.publish", "engine.advance")
        for s in spans[n])
    for (_, e0), (s1, _) in zip(phases, phases[1:]):
        assert e0 <= s1


def test_ramp_ends_at_the_first_pipelined_chunk(images_dir, out_dir):
    eng = _Recording(device="cpu")
    _run(eng, images_dir, out_dir)
    (ramp,) = _by_name(trace.TRACER.finished_spans())["engine.ramp"]
    a = ramp["attrs"]
    assert a["settled"] is True
    assert 1 <= a["chunks"] < len(eng.issued)
    assert a["turns"] == sum(eng.issued[:a["chunks"]])
    assert a["chunk"] == eng.issued[a["chunks"]] == 8
    assert a["first_issue_s"] > 0
    assert "library_cached" not in a  # a CPU engine loads no library


def test_ramp_of_a_run_that_ends_ramping(images_dir, out_dir):
    eng = _Recording(device="cpu")
    _run(eng, images_dir, out_dir, turns=1)
    (ramp,) = _by_name(trace.TRACER.finished_spans())["engine.ramp"]
    assert ramp["attrs"]["settled"] is False
    assert ramp["attrs"]["turns"] == 1


@pytest.mark.parametrize("how", ["GOL_TRACE", "Profile"])
def test_capture_file_holds_the_spans(monkeypatch, tmp_path, images_dir,
                                      out_dir, how):
    """The capture's Chrome trace holds the program's spans that overlap
    it, each a valid span event, and the chunk's issue lies on the
    profiler's clock over the plain steps it ran."""
    cap_dir = tmp_path / "cap"
    if how == "GOL_TRACE":
        monkeypatch.setenv("GOL_TRACE", str(cap_dir))
        span_name = "engine.traced_chunk"
    else:
        obs_prof.PROFILER.configure(str(cap_dir))
        obs_prof.PROFILER.request(turns=16, source="test")
        span_name = "engine.profile"
    try:
        _run(Engine(device="cpu"), images_dir, out_dir, turns=64)
    finally:
        obs_prof.PROFILER.configure(None)
    (path,) = list(cap_dir.glob("*" + obs_prof.ARTIFACT_SUFFIX))
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"]
             if isinstance(e.get("args"), dict) and "span_id" in e["args"]]
    trace.validate_chrome({"traceEvents": spans})
    names = Counter(e["name"] for e in spans)
    for name in (span_name, "engine.run", "engine.chunk", "engine.issue",
                 "engine.wait", "engine.publish"):
        assert names[name] >= 1, name
    ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"
           and e.get("ph") == "X"]
    assert ops
    slack = 2000.0  # µs: the two clocks agree to far better than this
    for issue in (e for e in spans if e["name"] == "engine.issue"):
        lo, hi = issue["ts"] - slack, issue["ts"] + issue["dur"] + slack
        assert any(lo <= op["ts"] and op["ts"] + op["dur"] <= hi
                   for op in ops)


def test_host_counters_feed_chunk_overhead(images_dir, out_dir):
    fams = (obs.ENGINE_ISSUE_SECONDS_TOTAL,
            obs.ENGINE_TOKEN_WAIT_SECONDS_TOTAL,
            obs.ENGINE_HOST_SECONDS_TOTAL, obs.ENGINE_COUNTED_CHUNKS_TOTAL)
    eng = _Recording(device="cpu")
    before = [f.value for f in fams]
    _run(eng, images_dir, out_dir)
    s1 = eng.stats()
    assert s1["chunks"] == len(eng.issued)
    assert s1["token_wait_s"] > 0 and s1["host_s"] > 0
    assert s1["issue_s"] == 0.0  # on the CPU the issue is the token wait
    got = [f.value - b for f, b in zip(fams, before)]
    assert got[3] == s1["chunks"]
    for v, key in zip(got[:3], ("issue_s", "token_wait_s", "host_s")):
        assert v == pytest.approx(s1[key], abs=2e-6)
    assert s1["chunk_overhead_us"] == pytest.approx(
        s1["host_s"] / s1["chunks"] * 1e6, rel=1e-3, abs=0.02)
    _run(eng, images_dir, out_dir, turns=100)
    s2 = eng.stats()
    assert s2["chunks"] == len(eng.issued) > s1["chunks"]
    assert s2["chunk_overhead_us"] == pytest.approx(
        (s2["host_s"] - s1["host_s"]) / (s2["chunks"] - s1["chunks"]) * 1e6,
        rel=1e-3, abs=0.05)
    assert obs.ENGINE_CHUNK_OVERHEAD_US.value == pytest.approx(
        s2["chunk_overhead_us"], abs=0.011)


def test_record_files_a_span_from_given_stamps():
    t0 = time.monotonic()
    parent = trace.start("t.parent")
    s = trace.TRACER.record("t.child", t0 + 1.0, t0 + 2.5, parent,
                            {"turn": 7})
    trace.finish(parent)
    (rec,) = [r for r in trace.TRACER.finished_spans()
              if r["name"] == "t.child"]
    assert rec["start"] == t0 + 1.0 and rec["end"] == t0 + 2.5
    assert rec["parent"] == parent.span_id and rec["attrs"] == {"turn": 7}
    assert s == rec and trace.TRACER.open_spans() == []
    assert [r["name"] for r in trace.TRACER.spans_between(
        t0 + 2.6, t0 + 3.0)] == []
    assert "t.child" in {r["name"] for r in trace.TRACER.spans_between(
        t0 + 2.0, t0 + 2.2)}
    events, _ = trace.TRACER.chrome_events([rec], shift_us=1e6)
    assert events[0]["ts"] == pytest.approx(
        (rec["start"] + trace.TRACER.epoch) * 1e6 - 1e6, abs=0.2)
    assert events[0]["dur"] == pytest.approx(1.5e6)


def test_span_ids_are_distinct_and_well_formed():
    ids = {trace.TRACER.record("t.id", 0.0, 0.0, None)["span"]
           for _ in range(5000)}
    assert len(ids) == 5000
    assert all(trace._valid_id(i) for i in ids)
