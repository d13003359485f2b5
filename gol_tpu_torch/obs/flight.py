"""Crash-time flight recorder: a bounded ring of recent spans and events —
the counterpart of `gol_tpu/obs/flight.py`.

Every finished span (`obs/trace.py`) and every structured-log event
(`obs/log.py`) is also appended to a small in-memory ring. When something
dies (SIGTERM on the server, the client heartbeat watchdog declaring the
engine lost, an unhandled exception in the engine's chunk loop, which
calls `crash`) the ring is dumped as ONE JSON document (schema
`gol-flight/1`): the recent spans, the spans still OPEN at the instant of
death, the recent log events, and a metrics-registry snapshot.

Recording is always on (a deque append per span/event); *writing* a dump
needs `GOL_FLIGHT=PATH` (a file path, or a directory to get one file per
pid+reason). With it unset a trigger writes nothing. Dump failures are
swallowed: the flight recorder exists to explain deaths, not cause them.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from typing import Callable, List, Optional

from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs.metrics import REGISTRY

FLIGHT_ENV = "GOL_FLIGHT"          # dump destination (file or directory)
FLIGHT_CAP_ENV = "GOL_FLIGHT_CAP"  # ring size (spans and events each)
FLIGHT_CAP_DEFAULT = 256
SCHEMA = "gol-flight/1"

# Process-level identity shared by every flight dump.
RUN_ID = f"run-{os.getpid()}-{int(time.time())}"
_T0 = time.monotonic()


def uptime_s() -> float:
    """Seconds since this module was first imported in this process."""
    return time.monotonic() - _T0


class FlightRecorder:
    """Thread-safe bounded ring of span records and log-event records,
    plus registered providers for spans still open at dump time."""

    def __init__(self, cap: Optional[int] = None) -> None:
        if cap is None:
            try:
                cap = int(os.environ.get(FLIGHT_CAP_ENV,
                                         FLIGHT_CAP_DEFAULT))
            except ValueError:
                cap = FLIGHT_CAP_DEFAULT
        cap = max(int(cap), 1)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=cap)
        self._events: deque = deque(maxlen=cap)
        # Callables returning a list of OPEN-span dicts (the tracer
        # registers one): what was in flight when the trigger fired.
        self._providers: List[Callable[[], List[dict]]] = []

    def record_span(self, rec: dict) -> None:
        with self._lock:
            self._spans.append(rec)

    def record_event(self, rec: dict) -> None:
        with self._lock:
            self._events.append(rec)

    def register_open_spans_provider(
            self, fn: Callable[[], List[dict]]) -> None:
        with self._lock:
            if fn not in self._providers:
                self._providers.append(fn)

    def snapshot(self, reason: str = "manual") -> dict:
        """The dump document (JSON-serializable)."""
        with self._lock:
            spans = list(self._spans)
            events = list(self._events)
            providers = list(self._providers)
        open_spans: List[dict] = []
        for fn in providers:
            try:
                open_spans.extend(fn())
            except Exception:
                pass  # a broken provider must not sink the dump
        return {
            "schema": SCHEMA,
            "reason": reason,
            "run_id": RUN_ID,
            "pid": os.getpid(),
            "ts": round(time.time(), 3),
            "uptime_s": round(uptime_s(), 3),
            "open_spans": open_spans,
            "spans": spans,
            "events": events,
            "metrics": REGISTRY.snapshot(),
        }

    def resolve_path(self, reason: str,
                     path: Optional[str] = None) -> Optional[str]:
        """Explicit path, else GOL_FLIGHT (a directory gets one file per
        pid+reason), else None (dump disabled)."""
        p = path or os.environ.get(FLIGHT_ENV, "").strip()
        if not p:
            return None
        if os.path.isdir(p) or p.endswith(os.sep):
            safe = re.sub(r"[^A-Za-z0-9_.-]+", "-", reason) or "unknown"
            p = os.path.join(p, f"gol-flight-{os.getpid()}-{safe}.json")
        return p

    def dump(self, reason: str = "manual",
             path: Optional[str] = None) -> Optional[str]:
        """Write the snapshot as JSON; returns the path written, or None
        (disabled or failed). Never raises — crash handlers call this."""
        try:
            target = self.resolve_path(reason, path)
            if target is None:
                return None
            doc = self.snapshot(reason)
            tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, default=str)
                f.write("\n")
            os.replace(tmp, target)
            obs.FLIGHT_DUMPS_TOTAL.labels(
                reason=obs.flight_reason_label(reason)).inc()
            return target
        except Exception:
            return None


# The process-wide recorder — what the tracer, the structured logger,
# and every crash trigger share.
FLIGHT = FlightRecorder()


def crash(event: str, exc: BaseException,
          reason: str = "exception", **fields) -> Optional[str]:
    """Record an exception event into the ring and dump: the one-call
    crash trigger for the engine loop. Never raises."""
    try:
        import traceback

        rec = {"ts": round(time.time(), 3), "level": "error",
               "event": event,
               "error": f"{type(exc).__name__}: {exc}",
               "traceback": "".join(traceback.format_exception(
                   type(exc), exc, exc.__traceback__))}
        rec.update(fields)
        FLIGHT.record_event(rec)
        return FLIGHT.dump(reason)
    except Exception:
        return None


def validate_dump(doc: dict) -> None:
    """Raise ValueError unless `doc` is a structurally valid flight dump
    (the test-side check; `gol_tpu`'s accepts the port's dumps)."""
    if not isinstance(doc, dict):
        raise ValueError(f"dump is {type(doc).__name__}, not object")
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"schema {doc.get('schema')!r} != {SCHEMA!r}")
    for key in ("reason", "run_id"):
        if not isinstance(doc.get(key), str) or not doc[key]:
            raise ValueError(f"missing {key}")
    for key in ("ts", "uptime_s", "pid"):
        if not isinstance(doc.get(key), (int, float)):
            raise ValueError(f"bad {key} {doc.get(key)!r}")
    for key in ("open_spans", "spans", "events"):
        if not isinstance(doc.get(key), list):
            raise ValueError(f"{key} is not a list")
    if not isinstance(doc.get("metrics"), dict):
        raise ValueError("metrics is not a dict")
