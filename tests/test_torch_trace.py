"""The port's span export helpers against `gol_tpu`'s: `Tracer.dropped`,
`validate_chrome` and `obs.sink.guarded_export`, through which the port's
`export_from_env` writes (`gol_tpu/obs/trace.py:344`). The port's Chrome
export passes both packages' `validate_chrome`; every malformed document
below is refused by both with the same message; a failing export returns
None in both and raises in neither. Tolerance: none."""

import json
import os

import pytest

from gol_tpu.obs import catalog as jcat
from gol_tpu.obs import sink as jsink
from gol_tpu.obs import trace as jtrace
from gol_tpu_torch.obs import catalog as obs_cat
from gol_tpu_torch.obs import sink
from gol_tpu_torch.obs import trace

IDS = {"trace_id": "a" * 16, "span_id": "b" * 16}


@pytest.fixture(autouse=True)
def _fresh_tracer():
    trace.TRACER.reset()
    yield
    trace.TRACER.reset()


def test_dropped_counts_refused_spans_as_gol_tpu_does():
    got = []
    for mod, cat in ((trace, obs_cat), (jtrace, jcat)):
        t = mod.Tracer(cap=4)
        before = cat.TRACE_SPAN_DROPS_TOTAL.value
        for i in range(7):
            t.finish(t.start(f"t.s{i}"))
        got.append((len(t.finished_spans()), t.dropped(),
                    cat.TRACE_SPAN_DROPS_TOTAL.value - before))
        t.reset()
        assert t.dropped() == 0
    assert got[0] == got[1] == (4, 3, 3)


def test_port_export_passes_both_validators(tmp_path):
    trace.finish(trace.start("t.done", attrs={"k": 3}))
    with trace.span("t.outer"):
        with trace.span("t.inner"):
            pass
    still_open = trace.start("t.open")
    path = trace.TRACER.export_chrome(str(tmp_path / "spans.json"))
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    trace.validate_chrome(doc)
    jtrace.validate_chrome(doc)
    phases = {ev["name"]: ev["ph"] for ev in doc["traceEvents"]}
    assert phases["t.done"] == phases["t.inner"] == "X"
    assert phases["t.open"] == "B"
    trace.finish(still_open)


def _bad_docs():
    x = {"name": "t", "ph": "X", "pid": 1, "tid": 2, "ts": 1.0,
         "dur": 2.0, "args": dict(IDS)}
    return {
        "not-a-dict": [x],
        "no-events": {"traceEvents": []},
        "events-not-list": {"traceEvents": {"a": 1}},
        "event-not-object": {"traceEvents": [7]},
        "bad-phase": {"traceEvents": [{**x, "ph": "Q"}]},
        "no-name": {"traceEvents": [{**x, "name": 3}]},
        "no-pid": {"traceEvents": [{**x, "pid": "1"}]},
        "no-ts": {"traceEvents": [{**x, "ts": None}]},
        "no-args": {"traceEvents": [{**x, "args": None}]},
        "bad-span-id": {"traceEvents": [
            {**x, "args": {**IDS, "span_id": "B" * 16}}]},
        "x-without-dur": {"traceEvents": [
            {k: v for k, v in x.items() if k != "dur"}]},
    }


@pytest.mark.parametrize("name", sorted(_bad_docs()))
def test_validators_refuse_alike(name):
    doc = _bad_docs()[name]
    msgs = []
    for mod in (trace, jtrace):
        with pytest.raises(ValueError) as e:
            mod.validate_chrome(doc)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_metadata_and_open_events_pass_both():
    doc = {"traceEvents": [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": "p"}},
        {"name": "t.open", "ph": "B", "pid": 1, "tid": 2, "ts": 5,
         "args": dict(IDS)}]}
    trace.validate_chrome(doc)
    jtrace.validate_chrome(doc)


def test_guarded_export_as_gol_tpu():
    for mod in (sink, jsink):
        hits = []
        assert mod.guarded_export(lambda: hits.append(1)) is True
        assert hits == [1]

        def boom():
            raise OSError("disk full")
        assert mod.guarded_export(boom) is False
    assert "guarded_export" in sink.__all__


def test_export_from_env_goes_through_the_guard(tmp_path, monkeypatch):
    """Unset: no export. A writable path: the path, a document both
    validators pass. An unwritable path: None, nothing raised — in both
    packages."""
    trace.finish(trace.start("t.env"))
    jtrace.finish(jtrace.start("t.env"))
    for mod in (trace, jtrace):
        monkeypatch.delenv(mod.TRACE_SPANS_ENV, raising=False)
        assert mod.export_from_env() is None
    target = tmp_path / "via_env.json"
    monkeypatch.setenv(trace.TRACE_SPANS_ENV, str(target))
    assert trace.export_from_env() == str(target)
    doc = json.load(open(target))
    trace.validate_chrome(doc)
    jtrace.validate_chrome(doc)
    missing = os.path.join(str(tmp_path), "no", "such", "dir", "x.json")
    monkeypatch.setenv(trace.TRACE_SPANS_ENV, missing)
    assert trace.export_from_env() is None
    assert jtrace.export_from_env() is None
    calls = []
    monkeypatch.setattr(sink, "guarded_export",
                        lambda thunk: calls.append(thunk) or False)
    monkeypatch.setenv(trace.TRACE_SPANS_ENV, str(target))
    assert trace.export_from_env() is None and len(calls) == 1
