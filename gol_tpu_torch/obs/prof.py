"""On-demand `torch.profiler` capture (the Profile wire method and the HTTP
trigger) — the counterpart of `gol_tpu/obs/prof.py`.

A process started with a profile directory (``--profile-dir`` or
``GOL_PROFILE_DIR``) can be told — at any point, without restart — to
capture the next N engine turns. The request side (wire dispatch thread,
HTTP handler) only *arms* the controller; the engine run loop is the sole
consumer: it drains its in-flight chunks, takes the request, and steps
the N turns one chunk at a time inside a capture, which runs
``torch.profiler`` over them (CPU and, where there is one, CUDA
activity) and writes one Chrome trace (``*.trace.json``, loadable in
Perfetto or chrome://tracing) into the directory. The JAX package writes
XPlane and gzipped Perfetto files instead; the state machine, the
status document and the metric families are the same.

Security posture matches RestoreRun: remote peers never choose the
server's filesystem path. The capture directory is fixed by whoever
started the process; a Profile request can only pick the turn count.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from gol_tpu_torch.obs import catalog as _cat

PROFILE_DIR_ENV = "GOL_PROFILE_DIR"
PROFILE_TURNS_ENV = "GOL_PROFILE_TURNS"
DEFAULT_TURNS = 256
ARTIFACT_SUFFIX = ".trace.json"

_seq = itertools.count()


class ProfileUnavailable(RuntimeError):
    """No profile directory configured, or a capture is already armed."""


@dataclass
class ProfileRequest:
    turns: int
    directory: str
    source: str
    requested_unix: float = field(default_factory=time.time)


class Capture:
    """One running `torch.profiler` session that writes its Chrome trace
    into `directory` when finished. The engine's `GOL_TRACE` chunk trace
    uses it bare; `ProfileController.begin` adds the Profile bookkeeping."""

    def __init__(self, directory: str) -> None:
        import torch

        self.directory = directory
        self.path = os.path.join(
            directory, f"gol-{os.getpid()}-{int(time.time() * 1e3)}-"
                       f"{next(_seq)}{ARTIFACT_SUFFIX}")
        self.t0 = time.time()
        os.makedirs(directory, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()

    def finish(self, error: Optional[BaseException] = None
               ) -> Optional[str]:
        """Stop profiling and write the trace; returns an error string
        (the profiler must never sink the engine loop) or None. `error`,
        the exception that ended the profiled turns, if any, is the
        caller's to report."""
        try:
            self._prof.stop()
            self._prof.export_chrome_trace(self.path)
        except Exception as e:  # noqa: BLE001 — reported in status
            return repr(e)
        return None


class _ProfileCapture:
    """A Profile request's capture: `finish()` stops the profiler and
    records the outcome in the controller's status and counters."""

    def __init__(self, ctl: "ProfileController",
                 req: ProfileRequest) -> None:
        self._ctl = ctl
        self.req = req
        self._cap = Capture(req.directory)

    def finish(self, error: Optional[BaseException] = None) -> None:
        err = self._cap.finish()
        if error is not None and err is None:
            err = repr(error)
        path = self._cap.path
        self._ctl._record(self.req, self._cap.t0, err,
                          [path] if os.path.exists(path) else [])


class ProfileController:
    """Single-slot arm/take/capture state machine around torch.profiler."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._pending: Optional[ProfileRequest] = None
        self._capturing = False
        self._last: dict = {}

    def configure(self, directory: Optional[str]) -> None:
        """Set (or clear) the capture directory for this process."""
        with self._lock:
            self._dir = os.path.abspath(directory) if directory else None

    @property
    def directory(self) -> Optional[str]:
        with self._lock:
            return self._dir

    def request(self, turns: int = 0, source: str = "wire") -> dict:
        """Arm a capture of the next `turns` engine turns.

        Raises ProfileUnavailable when no directory is configured or a
        capture is already pending/running — the caller maps that to a
        wire/HTTP error rather than silently queueing."""
        turns = int(turns) if turns else 0
        if turns <= 0:
            turns = int(os.environ.get(PROFILE_TURNS_ENV, DEFAULT_TURNS))
        with self._lock:
            if self._dir is None:
                raise ProfileUnavailable(
                    "no profile directory configured (start with "
                    "--profile-dir or GOL_PROFILE_DIR)")
            if self._pending is not None or self._capturing:
                raise ProfileUnavailable("profile capture already armed")
            self._pending = ProfileRequest(turns=turns, directory=self._dir,
                                           source=source)
        _cat.PROFILE_ARMED.set(1.0)
        return {"armed": True, "turns": turns, "dir": self._dir}

    def take(self) -> Optional[ProfileRequest]:
        """Consume the pending request (engine run loop only)."""
        # The engine loop calls this once per chunk iteration; the
        # attribute read is atomic under the GIL, and request() only
        # ever transitions None -> request under the lock, so a racing
        # arm is picked up one iteration later at worst.
        if self._pending is None:
            return None
        with self._lock:
            req, self._pending = self._pending, None
        return req

    def begin(self, req: ProfileRequest) -> _ProfileCapture:
        """Start profiling a taken request; the caller steps the turns
        and then calls `finish()` (with the exception, if one ended the
        capture) on the returned object."""
        with self._lock:
            self._capturing = True
        try:
            return _ProfileCapture(self, req)
        except BaseException as e:
            self._record(req, time.time(), repr(e), [])
            raise

    def _record(self, req: ProfileRequest, t0: float, err: Optional[str],
                artifacts: List[str]) -> None:
        status = "error" if err else "ok"
        _cat.PROFILE_CAPTURES.labels(status=status).inc()
        _cat.PROFILE_ARMED.set(0.0)
        with self._lock:
            self._capturing = False
            self._last = {
                "status": status,
                "turns": req.turns,
                "source": req.source,
                "dir": req.directory,
                "artifacts": artifacts,
                "seconds": round(time.time() - t0, 3),
                "finished_unix": int(time.time()),
            }
            if err:
                self._last["error"] = err

    def status(self) -> dict:
        """Operator-facing snapshot for the /profile endpoint + Profile."""
        with self._lock:
            return {
                "dir": self._dir,
                "armed": self._pending is not None or self._capturing,
                "capturing": self._capturing,
                "pending_turns": (self._pending.turns
                                  if self._pending else None),
                "captures_ok": int(
                    _cat.PROFILE_CAPTURES.labels(status="ok").value),
                "captures_error": int(
                    _cat.PROFILE_CAPTURES.labels(status="error").value),
                "last": dict(self._last),
            }


PROFILER = ProfileController()


def arm_from_env() -> bool:
    """Configure PROFILER from GOL_PROFILE_DIR and arm one capture.

    Used by one-shot CLI runs: `--profile-dir` exports the env var and
    the engine captures the first GOL_PROFILE_TURNS turns of the run.
    Returns True if a capture was armed."""
    directory = os.environ.get(PROFILE_DIR_ENV)
    if not directory:
        return False
    PROFILER.configure(directory)
    try:
        PROFILER.request(source="env")
    except ProfileUnavailable:
        return False
    return True
