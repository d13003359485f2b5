"""In-process span tracer with wire-propagated context — the counterpart
of `gol_tpu/obs/trace.py`.

  * `Span` — name, 16-hex trace id shared by a whole causal chain,
    16-hex span id, optional parent span id, monotonic start/end, the
    recording pid/tid, and a small attrs dict.
  * `Tracer` — thread-safe recorder. Finished spans land in a bounded
    first-N buffer (cap `GOL_TRACE_SPANS_CAP`, default 16384; overflow
    increments `gol_trace_span_drops_total`) and in the flight-recorder
    ring. Open spans are tracked so a crash dump can show what was in
    flight.
  * Thread-local context stack — `span()`/`push()` make the innermost
    open span the implicit parent for the current thread.
  * Wire propagation — `context()` renders the current span as the
    compact `{"t": trace_id, "s": span_id}` dict that `wire.send_msg`
    puts in the JSON header under `"tc"`; `parse_context()` validates it
    on the receiving side so a hostile peer cannot inject junk. This is
    part of the protocol: a JAX controller's spans parent a port server's
    handler spans, and the other way round.
  * Chrome trace-event export (`export_chrome`, `export_from_env`): the
    `{"traceEvents": [...]}` JSON that Perfetto loads.

Durations use `time.monotonic()`; a once-sampled wall-clock epoch places
them on one timeline across processes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import flight as obs_flight

TRACE_SPANS_ENV = "GOL_TRACE_SPANS"      # export destination
TRACE_SPANS_CAP_ENV = "GOL_TRACE_SPANS_CAP"
TRACE_SPANS_CAP_DEFAULT = 16384

_HEX = set("0123456789abcdef")


def _new_id() -> str:
    return os.urandom(8).hex()


def _valid_id(v: Any) -> bool:
    return (isinstance(v, str) and len(v) == 16
            and all(c in _HEX for c in v))


class Span:
    """One timed operation. Mutate attrs freely until `finish`."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id",
                 "start", "end", "pid", "tid", "thread", "attrs")

    def __init__(self, name: str, trace_id: str,
                 parent_id: Optional[str],
                 attrs: Optional[Dict[str, Any]] = None) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.start = time.monotonic()
        self.end: Optional[float] = None
        self.pid = os.getpid()
        self.tid = threading.get_ident()
        self.thread = threading.current_thread().name
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}

    def context(self) -> Dict[str, str]:
        """The compact wire form: what goes under `"tc"` in headers."""
        return {"t": self.trace_id, "s": self.span_id}

    def to_dict(self) -> dict:
        d = {"name": self.name, "trace": self.trace_id,
             "span": self.span_id, "parent": self.parent_id,
             "start": self.start, "end": self.end,
             "pid": self.pid, "tid": self.tid, "thread": self.thread}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


_INHERIT = object()  # default parent: innermost open span on this thread


def parse_context(obj: Any) -> Optional[Dict[str, str]]:
    """Validate a wire `"tc"` value; None unless it is exactly a dict
    with well-formed 16-hex `t` and `s` (peer input is untrusted)."""
    if (isinstance(obj, dict) and _valid_id(obj.get("t"))
            and _valid_id(obj.get("s"))):
        return {"t": obj["t"], "s": obj["s"]}
    return None


class Tracer:
    def __init__(self, cap: Optional[int] = None) -> None:
        if cap is None:
            try:
                cap = int(os.environ.get(TRACE_SPANS_CAP_ENV,
                                         TRACE_SPANS_CAP_DEFAULT))
            except ValueError:
                cap = TRACE_SPANS_CAP_DEFAULT
        self._cap = max(int(cap), 1)
        self._lock = threading.Lock()
        self._finished: List[dict] = []
        self._dropped = 0
        self._open: Dict[str, Span] = {}
        self._tls = threading.local()
        # Sampled once: shifts monotonic readings onto the wall clock
        # for export, so two processes' spans share one timeline.
        self.epoch = time.time() - time.monotonic()
        self._process_name = f"gol-pid-{os.getpid()}"

    def set_process_name(self, name: str) -> None:
        with self._lock:
            self._process_name = str(name)

    # ---- thread-local context stack -------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def context(self) -> Optional[Dict[str, str]]:
        cur = self.current()
        return cur.context() if cur is not None else None

    def push(self, span: Span) -> None:
        self._stack().append(span)

    def pop(self, span: Optional[Span] = None) -> None:
        st = self._stack()
        if not st:
            return
        if span is None or st[-1] is span:
            st.pop()
        elif span in st:  # misnested finish — drop it and everything above
            del st[st.index(span):]

    # ---- span lifecycle -------------------------------------------------

    def start(self, name: str, parent: Any = _INHERIT,
              attrs: Optional[Dict[str, Any]] = None) -> Span:
        """Open a span. `parent` defaults to this thread's innermost
        open span; pass a Span, a wire `tc` dict, or None for a root."""
        if parent is _INHERIT:
            parent = self.current()
        if isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            ctx = parse_context(parent)
            if ctx is not None:
                trace_id, parent_id = ctx["t"], ctx["s"]
            else:
                trace_id, parent_id = _new_id(), None
        span = Span(name, trace_id, parent_id, attrs)
        with self._lock:
            self._open[span.span_id] = span
        return span

    def finish(self, span: Span,
               error: Optional[BaseException] = None) -> None:
        if span.end is not None:
            return  # idempotent: recovery paths may double-finish
        span.end = time.monotonic()
        if error is not None:
            span.attrs["error"] = f"{type(error).__name__}: {error}"
        rec = span.to_dict()
        with self._lock:
            self._open.pop(span.span_id, None)
            if len(self._finished) < self._cap:
                self._finished.append(rec)
            else:
                self._dropped += 1
                obs.TRACE_SPAN_DROPS_TOTAL.inc()
        obs.TRACE_SPANS_TOTAL.inc()
        obs_flight.FLIGHT.record_span(rec)

    class _SpanCtx:
        __slots__ = ("_tracer", "span")

        def __init__(self, tracer: "Tracer", span: Span) -> None:
            self._tracer, self.span = tracer, span

        def __enter__(self) -> Span:
            self._tracer.push(self.span)
            return self.span

        def __exit__(self, et, ev, tb) -> bool:
            self._tracer.pop(self.span)
            self._tracer.finish(self.span, error=ev)
            return False

    def span(self, name: str, parent: Any = _INHERIT,
             attrs: Optional[Dict[str, Any]] = None) -> "_SpanCtx":
        """`with TRACER.span("serve.Ping", parent=tc):` — pushes onto
        the thread's context stack so nested spans parent under it."""
        return Tracer._SpanCtx(self, self.start(name, parent, attrs))

    # ---- introspection / export -----------------------------------------

    def open_spans(self) -> List[dict]:
        """Dicts for spans not yet finished (flight-dump provider)."""
        with self._lock:
            return [s.to_dict() for s in self._open.values()]

    def finished_spans(self) -> List[dict]:
        with self._lock:
            return list(self._finished)

    def dropped(self) -> int:
        """Spans refused since the last reset: the finished buffer was
        full (`gol_trace_span_drops_total` counts them too)."""
        with self._lock:
            return self._dropped

    def reset(self) -> None:
        """Tests only: forget everything recorded so far."""
        with self._lock:
            self._finished.clear()
            self._open.clear()
            self._dropped = 0

    def _wall_us(self, mono: float) -> float:
        return round((mono + self.epoch) * 1e6, 1)

    def chrome_doc(self) -> dict:
        """The span set as a Chrome trace-event document (Perfetto)."""
        with self._lock:
            finished = list(self._finished)
            open_ = [s.to_dict() for s in self._open.values()]
            pname = self._process_name
            dropped = self._dropped
        events: List[dict] = []
        threads = {}  # (pid, tid) -> thread name
        for rec in finished + open_:
            threads.setdefault((rec["pid"], rec["tid"]), rec["thread"])
            args = {"trace_id": rec["trace"], "span_id": rec["span"]}
            if rec.get("parent"):
                args["parent_id"] = rec["parent"]
            args.update(rec.get("attrs") or {})
            ev = {"name": rec["name"],
                  "cat": rec["name"].split(".", 1)[0],
                  "ts": self._wall_us(rec["start"]),
                  "pid": rec["pid"], "tid": rec["tid"], "args": args}
            if rec["end"] is None:
                ev["ph"] = "B"  # still open: begin with no end
            else:
                ev["ph"] = "X"
                ev["dur"] = round((rec["end"] - rec["start"]) * 1e6, 1)
            events.append(ev)
        meta: List[dict] = []
        for pid in sorted({pid for pid, _ in threads}):
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": pname}})
        for (pid, tid), tname in sorted(threads.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": tname}})
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "otherData": {"producer": "gol_tpu_torch.obs.trace",
                              "run_id": obs_flight.RUN_ID,
                              "dropped_spans": dropped}}

    def export_chrome(self, path: str) -> str:
        """Write the Chrome trace JSON; a directory path (or trailing
        separator) gets one `gol-spans-<pid>.json` per process so the
        controller and a server can share one setting."""
        if os.path.isdir(path) or path.endswith(os.sep):
            path = os.path.join(path, f"gol-spans-{os.getpid()}.json")
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.chrome_doc(), f, default=str)
            f.write("\n")
        os.replace(tmp, path)
        return path


# Process-wide tracer; its open spans feed every flight dump.
TRACER = Tracer()
obs_flight.FLIGHT.register_open_spans_provider(TRACER.open_spans)

# Module-level conveniences over the singleton.
start = TRACER.start
finish = TRACER.finish
span = TRACER.span
current = TRACER.current
context = TRACER.context
set_process_name = TRACER.set_process_name
export_chrome = TRACER.export_chrome


def export_from_env() -> Optional[str]:
    """Export to `GOL_TRACE_SPANS` if set (what `--trace-spans` sets);
    never raises — it runs on shutdown paths."""
    from gol_tpu_torch.obs.sink import guarded_export

    path = os.environ.get(TRACE_SPANS_ENV, "").strip()
    if not path:
        return None
    out: List[str] = []
    ok = guarded_export(lambda: out.append(TRACER.export_chrome(path)))
    return out[0] if ok and out else None


def validate_chrome(doc: dict) -> None:
    """Raise ValueError unless `doc` is structurally a Chrome trace-event
    document this exporter could have produced."""
    if not isinstance(doc, dict):
        raise ValueError(f"doc is {type(doc).__name__}, not object")
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        raise ValueError("traceEvents missing or empty")
    for ev in evs:
        if not isinstance(ev, dict):
            raise ValueError(f"event is not an object: {ev!r}")
        ph = ev.get("ph")
        if ph not in ("X", "B", "M"):
            raise ValueError(f"unexpected phase {ph!r}")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"event without name: {ev!r}")
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            raise ValueError(f"event without pid/tid: {ev!r}")
        if ph != "M":
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"event without ts: {ev!r}")
            args = ev.get("args")
            if not isinstance(args, dict) \
                    or not _valid_id(args.get("trace_id")) \
                    or not _valid_id(args.get("span_id")):
                raise ValueError(f"event without span ids: {ev!r}")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            raise ValueError(f"X event without dur: {ev!r}")


def hot_spans_enabled() -> bool:
    """Should spans whose count scales with dispatches (a sharded run's
    'halo.dispatch') be recorded? True when someone will consume them: a
    span export destination (GOL_TRACE_SPANS) or a flight-recorder dump
    path (GOL_FLIGHT) is configured — `gol_tpu`'s gate."""
    return bool(os.environ.get(TRACE_SPANS_ENV, "").strip()
                or os.environ.get(obs_flight.FLIGHT_ENV, "").strip())
