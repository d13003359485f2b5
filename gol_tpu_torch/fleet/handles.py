"""Run handles: the per-run identity every engine flavour serves — the
counterpart of `gol_tpu/fleet/handles.py`, the same records.

An engine is split from a run. The dense `Engine` and
`SparseEngine` each own exactly one run (the reference broker's
globals); the fleet engine owns thousands. Server/wire/obs/ckpt code
must stop reaching into one global run, so every engine now answers the
same three questions:

    resolve_run(run_id) -> a per-run ENGINE SURFACE (alive_count,
                           get_world/get_world_frame/get_view, cf_put,
                           drain_flags, checkpoint_now, stats,
                           describe_run) for that run.  run_id None/""
                           means the legacy default run — which is how
                           capability-less peers that never send a
                           run_id keep working bit-identically.
    list_runs()         -> [describe_run() dicts]
    runs_summary()      -> {"resident", "queued", ...} for /healthz,
                           ListRuns, and the fleet bench.

For the single-run engines the per-run surface IS the engine itself
(`SingleRunSurface` mixin below); the fleet engine returns a
`fleet.engine.RunView` bound to one `RunHandle`.

`RunHandle` is the fleet's per-run record: rule, turn, control-flag
queue, viewer subscriptions, checkpoint cadence, and the (bucket, slot)
placement of the run's board inside a batched device array. Handles are
mutated only by the fleet loop thread (placement, turn, alive) and by
request threads through the flag queue — the same discipline
`ControlFlagProtocol` uses, so the subtle flag semantics cannot drift.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np

from gol_tpu_torch.wire import valid_run_id  # noqa: F401  (re-exported)

# The implicit run every pre-fleet client is talking to when it sends
# no run_id. One constant, shared by the engines' mixin, the fleet
# engine's legacy path, the server's routing, and the tests.
LEGACY_RUN_ID = "run0"

# RunHandle.state values (ListRuns/AttachRun expose them verbatim):
#   queued      - admitted to the wait queue, no device placement yet
#   resident    - placed in a bucket slot; stepped while active
#   parked      - resident but frozen (target reached, FLAG_QUIT on an
#                 active run, or pause): board durable on the handle,
#                 readable, not stepped
#   quarantined - slot faulted (implausible popcount, step exception,
#                 restore failure): evicted from its bucket with the
#                 board DISCARDED as untrusted, admission charge held;
#                 the fleet loop auto-restores from the run's last
#                 per-run checkpoint under capped backoff
#                 (GOL_QUARANTINE_TRIES), re-queueing it for placement
#   removed     - slot released, capacity returned; terminal
RUN_STATES = ("queued", "resident", "parked", "quarantined", "removed")


class FleetUnsupported(RuntimeError):
    """A fleet-only operation (CreateRun on a single-run engine)."""


class RunHandle:
    """One resident (or queued) run of the fleet engine."""

    __slots__ = (
        "run_id", "rule", "h", "w", "bucket_key", "slot", "turn",
        "alive", "alive_turn", "state", "paused", "frozen", "flags",
        "viewers", "ckpt_every", "next_ckpt_turn", "target_turn",
        "done", "created_s", "pending_seed", "abort",
        "admitted_cost", "enqueued_s", "advanced_s",
        "quarantine_reason", "quarantine_tries", "quarantine_next_s",
        "adopted", "migrating",
    )

    def __init__(self, run_id: str, rule, h: int, w: int,
                 ckpt_every: int = 0,
                 target_turn: Optional[int] = None,
                 start_turn: int = 0) -> None:
        self.run_id = run_id
        self.rule = rule
        self.h = int(h)
        self.w = int(w)
        self.bucket_key: Optional[tuple] = None
        self.slot: Optional[int] = None
        self.turn = int(start_turn)
        self.alive = 0
        self.alive_turn = int(start_turn)
        self.state = "queued"
        self.paused = False
        # Host {0,1} board while parked/paused (the authoritative state
        # whenever the slot isn't being stepped on the run's behalf);
        # also the queued run's seed until placed.
        self.frozen: Optional[np.ndarray] = None
        # (board01, turn) a request thread wants installed — applied by
        # the fleet loop before the next quantum (reseed/restore path).
        self.pending_seed: Optional[tuple] = None
        # Bytes charged to the admission controller (0 for the legacy
        # run, which predates admission and is never rejected).
        self.admitted_cost = 0
        self.flags: "queue.Queue[int]" = queue.Queue()
        # vkeys of live-view viewers (GetView or Subscribe with run_id):
        # observational — lets ListRuns show which runs anyone is
        # actually watching.
        self.viewers: set = set()
        self.ckpt_every = int(ckpt_every)
        self.next_ckpt_turn = (self.turn + self.ckpt_every
                               if self.ckpt_every else 0)
        # None = free-running (serve until FLAG_QUIT); else park at it.
        self.target_turn = target_turn
        self.done = threading.Event()
        self.abort = threading.Event()
        self.created_s = time.time()
        # SLO telemetry, monotonic clock: when the run entered
        # the admission wait queue (None = never queued), and when its
        # board last advanced — placement stamps it, each stepped
        # quantum restamps it, and the fleet flush derives the per-run
        # TURN STALENESS signal (now - advanced_s) from it.
        self.enqueued_s: Optional[float] = None
        self.advanced_s = time.monotonic()
        # Quarantine bookkeeping: why the run left residency,
        # restore attempts so far, and the monotonic time before which
        # the fleet loop must not retry (exponential backoff).
        self.quarantine_reason: Optional[str] = None
        self.quarantine_tries = 0
        self.quarantine_next_s = 0.0
        # Federation: True while this handle is an adopted run whose
        # checkpoint restore has not resolved yet; the quarantine service
        # meters its outcome under gol_fed_adopted_runs_total.
        self.adopted = False
        # Live migration: None = not migrating; on a quiesced SOURCE the
        # state quiesce saw ("resident", "parked", ...), the rollback
        # anchor; on a staged TARGET import "staged" or "staged-parked"
        # (hidden from ListRuns, out of every bucket, never auto-resumed
        # until CommitRun).
        self.migrating: Optional[str] = None

    @property
    def active(self) -> bool:
        """Stepped by the fleet loop this quantum?"""
        return self.state == "resident" and not self.paused

    def describe(self) -> dict:
        """The ListRuns/AttachRun record for this run."""
        rec = {
            "run_id": self.run_id,
            "state": self.state,
            "board": [self.h, self.w],
            "rule": self.rule.rulestring,
            "turn": self.turn,
            "alive": self.alive,
            "alive_turn": self.alive_turn,
            "paused": self.paused,
            "bucket": ("%dx%d" % self.bucket_key[:2]
                       if self.bucket_key else None),
            "viewers": len(self.viewers),
            "ckpt_every": self.ckpt_every,
            "target_turn": self.target_turn,
        }
        # Only quarantined (or once-quarantined) runs carry the key, so
        # the record shape is unchanged for every healthy run.
        if self.quarantine_reason is not None:
            rec["quarantine_reason"] = self.quarantine_reason
            rec["quarantine_tries"] = self.quarantine_tries
        if self.migrating is not None:
            rec["migrating"] = self.migrating
        return rec


class SingleRunSurface:
    """Run-handle contract for the single-run engines.

    Mixed into `Engine` and `SparseEngine`: the per-run surface of the
    one run IS the engine object, so `resolve_run` hands the engine
    back and every existing call site keeps working. Relies only on
    the duck-typed engine surface (`stats`, `alive_count`) both
    engines already implement."""

    run_id = LEGACY_RUN_ID

    def resolve_run(self, run_id: Optional[str] = None):
        if run_id in (None, "", self.run_id):
            return self
        raise KeyError(f"unknown run {run_id!r}")

    def describe_run(self) -> dict:
        s = self.stats()
        board = s.get("board")
        return {
            "run_id": self.run_id,
            "state": "resident",
            "board": list(board) if board else None,
            "rule": s.get("rule"),
            "turn": s.get("turn"),
            "alive": s.get("alive"),
            "alive_turn": s.get("alive_turn"),
            "paused": False,
            "bucket": None,
            "viewers": 0,
            "ckpt_every": 0,
            "target_turn": None,
            "running": s.get("running"),
        }

    def list_runs(self) -> list:
        return [self.describe_run()]

    def runs_summary(self) -> dict:
        return {"resident": 1, "queued": 0,
                "engine": type(self).__name__}

    def create_run(self, *a, **kw):
        raise FleetUnsupported(
            f"{type(self).__name__} serves a single run; start the "
            "server with --fleet for CreateRun")

    def destroy_run(self, *a, **kw):
        raise FleetUnsupported(
            f"{type(self).__name__} serves a single run; start the "
            "server with --fleet for DestroyRun")


def tiles_for(h: int, w: int, hb: int, wb: int) -> int:
    """How many copies of an (h, w) board tile an (hb, wb) bucket."""
    return (hb // h) * (wb // w)


def fits_bucket(h: int, w: int, hb: int, wb: int) -> bool:
    """The tiling contract: a board occupies a bucket by PERIODIC
    tiling, so the bucket torus evolution restricted to any board-sized
    window is bit-identical to the board's own torus evolution (GoL
    commutes with translations; a periodic state stays periodic). That
    requires the board to divide the bucket exactly in both axes."""
    return (0 < h <= hb and 0 < w <= wb
            and hb % h == 0 and wb % w == 0)


def tile_board(board01: np.ndarray, hb: int, wb: int) -> np.ndarray:
    """(h, w) {0,1} board -> (hb, wb) periodic tiling."""
    h, w = board01.shape
    return np.tile(board01, (hb // h, wb // w))


def crop_alive(bucket_alive: int, tiles: int) -> int:
    """Per-run alive count from the tiled bucket popcount (exact: the
    bucket holds `tiles` identical copies of the board)."""
    return int(bucket_alive) // max(1, int(tiles))
