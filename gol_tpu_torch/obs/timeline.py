"""Chunk-timeline run reports: JSON-lines records of how a run paced —
the counterpart of `gol_tpu/obs/timeline.py`, the same
`gol-run-report/1` schema. Both engines' loops emit it under
`GOL_RUN_REPORT`, which the CLI's `--run-report` sets.

One `RunReporter` per engine run, activated by `GOL_RUN_REPORT=PATH`
(the `--run-report` CLI flag sets the env var, mirroring how `--trace`
drives `GOL_TRACE`). The engine chunk loop appends one record per
retired chunk plus `run_start` / `run_end` bookends; bench.py's
`--self-report` emits the same schema so bench artifacts and production
telemetry agree (this is the same schema *family* as the BENCH_*.json
one-JSON-object-per-line reports).

Schema `gol-run-report/1` — every record is one JSON object per line:

    common       schema, event, run_id, t (seconds since run start)
    run_start    w, h, model, repr, devices, turns_requested
    chunk        turn (after), turns (in chunk), chunk_size, wall_s,
                 cups, turns_per_s, token_wait_s, dispatch_s, flag_s,
                 alive
    traced_chunk turn, turns (profiler path: no wall/cups — excluded
                 from pace aggregates by design)
    run_end      turn, turns_total, chunks, traced_chunks, wall_s
    bench_leg    value (+ metric/unit/vs_baseline/detail — bench.py's
                 --self-report mirror of its stdout BENCH lines)

Reporter failures (disk full, bad path) must never sink a run: the
shared `obs.sink.GuardedLineSink` disables the reporter after the
first OSError and the engine carries on unmetered.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterator, Optional

from gol_tpu_torch.obs.sink import GuardedLineSink

SCHEMA = "gol-run-report/1"
RUN_REPORT_ENV = "GOL_RUN_REPORT"

_EVENT_FIELDS = {
    "run_start": ("w", "h"),
    "chunk": ("turn", "turns", "wall_s", "cups"),
    "traced_chunk": ("turn", "turns"),
    "run_end": ("turn", "turns_total", "chunks"),
    "bench_leg": ("value",),
}


class RunReporter:
    """Append-only JSON-lines writer for one run's timeline."""

    def __init__(self, path: str, run_id: Optional[str] = None) -> None:
        self.path = path
        self.run_id = run_id or f"run-{os.getpid()}-{int(time.time())}"
        self._t0 = time.monotonic()
        self._sink = GuardedLineSink(path)

    def emit(self, event: str, **fields) -> None:
        if self._sink.dead:
            return
        rec = {"schema": SCHEMA, "event": event, "run_id": self.run_id,
               "t": round(time.monotonic() - self._t0, 6)}
        rec.update(fields)
        self._sink.write_line(json.dumps(rec, sort_keys=True))

    def close(self) -> None:
        self._sink.close()


def from_env(environ=os.environ) -> Optional[RunReporter]:
    """A reporter for the path in GOL_RUN_REPORT, or None if unset."""
    path = environ.get(RUN_REPORT_ENV, "").strip()
    return RunReporter(path) if path else None


# ------------------------------------------------------------ validation

def validate_record(rec: dict) -> None:
    """Raise ValueError unless `rec` is a valid run-report record.
    Extra keys are fine (the schema grows by addition); missing
    required keys or wrong shapes are not."""
    if not isinstance(rec, dict):
        raise ValueError(f"record is {type(rec).__name__}, not object")
    if rec.get("schema") != SCHEMA:
        raise ValueError(f"schema {rec.get('schema')!r} != {SCHEMA!r}")
    event = rec.get("event")
    if event not in _EVENT_FIELDS:
        raise ValueError(f"unknown event {event!r}")
    if not isinstance(rec.get("run_id"), str) or not rec["run_id"]:
        raise ValueError("missing run_id")
    if not isinstance(rec.get("t"), (int, float)) or rec["t"] < 0:
        raise ValueError(f"bad t {rec.get('t')!r}")
    for key in _EVENT_FIELDS[event]:
        if key not in rec:
            raise ValueError(f"{event} record missing {key!r}")
        if not isinstance(rec[key], (int, float)):
            raise ValueError(
                f"{event}.{key} is {type(rec[key]).__name__}, "
                f"not a number")
    if event == "chunk":
        if rec["wall_s"] < 0:
            raise ValueError(f"chunk.wall_s {rec['wall_s']!r} < 0")
        if rec["turns"] <= 0:
            raise ValueError(f"chunk.turns {rec['turns']!r} <= 0")


def read_report(path: str) -> Iterator[dict]:
    """Parse and validate a run-report file, yielding records in order."""
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}") from e
            try:
                validate_record(rec)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}") from e
            yield rec
