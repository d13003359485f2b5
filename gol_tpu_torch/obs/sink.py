"""Shared "observability must never sink a run" sink guard — a copy of
`gol_tpu/obs/sink.py`.

The run journal (`gol_tpu_torch/journal.py`) writes through it: the
first OSError (disk full, bad path, permission) permanently disables
the sink and the engine carries on unjournaled.

`GuardedLineSink` is the append-only line writer: lazy open on first
write, write+flush under a lock, and `dead` latched forever after the
first OSError. `guarded_export` is the one-shot variant for an exporter
that dumps a whole artifact at close (the Chrome span trace).
"""

from __future__ import annotations

import threading
from typing import IO, Callable, Optional

__all__ = ["GuardedLineSink", "guarded_export"]


class GuardedLineSink:
    """Append-only line sink that disables itself after one OSError.

    Thread-safe; the file is opened lazily on the first `write_line`
    so constructing a sink for a bad path costs nothing until used.
    Once `dead`, every subsequent write is a silent no-op — the guard
    never un-latches (a sink that half-recovers would interleave holes
    into append-only logs, which is worse than stopping cleanly).
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._fh: Optional[IO[str]] = None
        self._dead = False

    @property
    def dead(self) -> bool:
        return self._dead

    def write_line(self, line: str) -> bool:
        """Append `line` + newline and flush. True iff it hit the file;
        False once the sink is dead (including the write that kills it).
        """
        with self._lock:
            if self._dead:
                return False
            try:
                if self._fh is None:
                    self._fh = open(self.path, "a", encoding="utf-8")
                self._fh.write(line + "\n")
                self._fh.flush()
                return True
            except OSError:
                self._kill_locked()
                return False

    def close(self) -> None:
        """Close the file and latch dead (idempotent)."""
        with self._lock:
            self._kill_locked()

    def _kill_locked(self) -> None:
        self._dead = True
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


def guarded_export(thunk: Callable[[], None]) -> bool:
    """Run a one-shot export thunk (the Chrome span dump at run end);
    True if it landed, False if it raised. Never raises: exporters run
    on shutdown paths."""
    try:
        thunk()
        return True
    except Exception:
        return False
