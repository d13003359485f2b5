"""Structured logging, `GOL_LOG=json|text` (default text) — a copy of
`gol_tpu/obs/log.py`.

One-line events that a log pipeline can parse (`json`) or a human can
read on a terminal (`text`). Events go to stderr so they never interleave
with the server banner that harnesses read from stdout.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

from gol_tpu_torch.obs import flight as _flight

LOG_ENV = "GOL_LOG"


def _mode() -> str:
    # Read per call, not at import: long-lived processes may flip
    # GOL_LOG after the package is imported.
    mode = os.environ.get(LOG_ENV, "text").strip().lower()
    return mode if mode in ("json", "text") else "text"


def log(event: str, level: str = "info", stream=None, **fields) -> None:
    """Emit one structured event. `fields` must be JSON-serializable."""
    stream = stream if stream is not None else sys.stderr
    rec = {"ts": round(time.time(), 3), "level": level, "event": event}
    rec.update(fields)
    # Every event also lands in the flight-recorder ring, whatever the
    # stderr format — a crash dump should carry the recent log tail.
    try:
        _flight.FLIGHT.record_event(rec)
    except Exception:
        pass
    if _mode() == "json":
        line = json.dumps(rec, sort_keys=True, default=str)
    else:
        extras = " ".join(f"{k}={v}" for k, v in fields.items())
        line = f"[gol:{level}] {event}" + (f" {extras}" if extras else "")
    try:
        print(line, file=stream, flush=True)
    except (OSError, ValueError):
        pass  # a closed/broken stderr must never sink the run


def exception(event: str, exc: BaseException,
              stream=None, **fields) -> None:
    """`log` for a caught exception; carries type, message, and the
    formatted traceback (as a field in json mode, as the familiar
    multi-line block in text mode)."""
    tb = "".join(traceback.format_exception(type(exc), exc,
                                            exc.__traceback__))
    if _mode() == "json":
        log(event, level="error", stream=stream,
            error=f"{type(exc).__name__}: {exc}", traceback=tb, **fields)
    else:
        log(event, level="error", stream=stream,
            error=f"{type(exc).__name__}: {exc}", **fields)
        try:
            print(tb, file=stream if stream is not None else sys.stderr,
                  end="", flush=True)
        except (OSError, ValueError):
            pass
