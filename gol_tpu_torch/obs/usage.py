"""Per-run usage metering and capacity attribution — the counterpart of
`gol_tpu/obs/usage.py`. The port's fleet loop, checkpoint writer,
journal, broadcast tier and server charge it; the `GetUsage` RPC and the
telemetry exporter read it.

The fleet engine dispatches one compiled program per bucket quantum; a
quantum's wall clock is the only device time there is, so attribution
is an apportionment problem: split each measured dispatch wall across
the slots that were active in it.  Batch placement shares one program
across slots, so each active run gets ``elapsed / n_active``.  Spatial
placement gives every device to one board per dispatch, so each run is
charged the FULL quantum and the conservation denominator grows by the
same amount — per-run shares always sum to the measured wall, and the
gated ``usage_attribution_error_pct`` stays at float-rounding noise.

Cardinality posture: exact accumulators exist only for runs the
owning member's engine registered via :func:`track` — a dict bounded by
the admission controller's ``max_runs``, not by lifetime run count.
Charges for unknown run ids fold into a single ``untracked`` aggregate
so late broadcast/checkpoint stragglers after a destroy can never grow
the map.  No per-run metric labels, ever: per-run detail lives on the
reference-swapped ``/healthz`` ``"usage"`` doc (top-K talkers, K
bounded by ``GOL_USAGE_TOPK``), the same pattern as
``obs_slo.set_fleet_health``.

Hot-path contract: the engine loop only appends plain tuples to
a local list; everything here runs at the batched <=0.5 s flush.  All
meter work is self-timed into ``gol_usage_wall_us_total`` so
``bench.py --usage`` can gate ``usage_overhead_pct`` as a wall share,
the same contention-immune method as ``journal_overhead_pct``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.utils.envcfg import env_float, env_int

TOPK_ENV = "GOL_USAGE_TOPK"
TOPK_DEFAULT = 8
FLUSH_ENV = "GOL_USAGE_FLUSH_S"
FLUSH_DEFAULT_S = 0.5

#: Compact per-run entries exported on the heartbeat snapshot ("use"
#: family) — deliberately smaller than the /healthz top-K so the
#: lowest-priority family stays cheap under GOL_FED_SNAPSHOT_MAX.
SNAP_TOP = 4


class RunUsage:
    """Exact accumulators for one resident run."""

    __slots__ = ("run_id", "device_s", "dispatches", "turns", "cells",
                 "wire_in", "wire_out", "bc_frames", "bc_bytes",
                 "sent_frames", "sent_bytes", "ckpt_bytes",
                 "journal_bytes", "created_s")

    def __init__(self, run_id: str, now: float) -> None:
        self.run_id = run_id
        self.device_s = 0.0      # apportioned dispatch wall
        self.dispatches = 0
        self.turns = 0
        self.cells = 0           # cell-updates advanced
        self.wire_in = 0         # RPC request bytes (ConnectionEncoder)
        self.wire_out = 0        # RPC reply bytes
        self.bc_frames = 0       # broadcast frames published
        self.bc_bytes = 0        # broadcast bytes published (pre fan-out)
        self.sent_frames = 0     # delivered frames, summed over subscribers
        self.sent_bytes = 0      # delivered bytes, summed over subscribers
        self.ckpt_bytes = 0
        self.journal_bytes = 0
        self.created_s = now

    def record(self, now: Optional[float] = None) -> dict:
        """Flat JSON-scalar record (journal ``usage`` event payload)."""
        rec = {
            "device_s": round(self.device_s, 6),
            "dispatches": self.dispatches,
            "turns": self.turns,
            "cells": self.cells,
            "wire_in": self.wire_in,
            "wire_out": self.wire_out,
            "bc_frames": self.bc_frames,
            "bc_bytes": self.bc_bytes,
            "sent_frames": self.sent_frames,
            "sent_bytes": self.sent_bytes,
            "ckpt_bytes": self.ckpt_bytes,
            "journal_bytes": self.journal_bytes,
        }
        if now is not None:
            rec["dur_s"] = round(max(0.0, now - self.created_s), 3)
        return rec


class UsageMeter:
    """Bounded per-run cost attribution for one member.

    Thread model: the engine loop never calls in here (it hands tuples
    to :meth:`ingest_dispatches` at its own flush); RPC threads, the
    gateway event loop and the checkpoint/journal writers do, so state
    moves under one small lock.  The public doc is swapped by
    reference and read without the lock (atomic under the GIL).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._runs: Dict[str, RunUsage] = {}
        self._untracked = RunUsage("", 0.0)
        self._untracked_events = 0
        # Conservation survives destroys: retired totals keep the
        # lifetime sums comparable against the lifetime wall.
        self._retired_device_s = 0.0
        self._retired_runs = 0
        self._wall_s = 0.0        # measured dispatch wall (denominator)
        self._attributed_s = 0.0  # sum of per-run shares (numerator)
        self._capacity: List[dict] = []
        self._doc: dict = {}
        self._doc_ts = 0.0

    # -- self-timing ---------------------------------------------------

    @staticmethod
    def _wall_begin() -> float:
        return time.perf_counter()

    @staticmethod
    def _wall_end(t0: float) -> None:
        obs.USAGE_WALL_US.inc((time.perf_counter() - t0) * 1e6)

    # -- lifecycle -------------------------------------------------------

    def track(self, run_id: str) -> None:
        """Open exact accumulators for a resident run (engine only)."""
        t0 = self._wall_begin()
        with self._lock:
            if run_id not in self._runs:
                self._runs[run_id] = RunUsage(run_id, time.time())
                obs.USAGE_RUNS_TRACKED.set(len(self._runs))
        self._wall_end(t0)

    def retire(self, run_id: str) -> Optional[dict]:
        """Close out a run; returns its final record, or None if the
        run was never tracked / already retired (idempotent — the
        migrate-out path retires before ``_remove_locked`` runs)."""
        t0 = self._wall_begin()
        now = time.time()
        with self._lock:
            u = self._runs.pop(run_id, None)
            if u is not None:
                self._retired_device_s += u.device_s
                self._retired_runs += 1
                obs.USAGE_RUNS_TRACKED.set(len(self._runs))
                rec = u.record(now)
            else:
                rec = None
        self._wall_end(t0)
        return rec

    def _get(self, run_id) -> RunUsage:
        """Accumulators for ``run_id``; the untracked fold otherwise.
        Callers hold the lock."""
        u = self._runs.get(run_id) if run_id else None
        if u is None:
            self._untracked_events += 1
            obs.USAGE_UNTRACKED.inc()
            return self._untracked
        return u

    # -- charging --------------------------------------------------------

    def ingest_dispatches(
            self,
            batch: Sequence[Tuple[str, float, int,
                                  Sequence[Tuple[str, int]]]]) -> None:
        """Apportion a flush window's dispatches.

        Each entry is ``(placement, elapsed_s, chunk_turns, active)``
        with ``active`` the ``(run_id, cells_per_turn)`` pairs stepped
        in that dispatch.  Spatial placement serializes boards across
        the full device mesh, so every active run is charged the whole
        quantum and the wall denominator scales with ``n`` — shares
        stay conservative under both placements.
        """
        if not batch:
            return
        t0 = self._wall_begin()
        with self._lock:
            for placement, elapsed, chunk, active in batch:
                n = len(active)
                if not n:
                    self._wall_s += elapsed
                    continue
                if placement == "spatial":
                    share = elapsed
                    self._wall_s += elapsed * n
                else:
                    share = elapsed / n
                    self._wall_s += elapsed
                for rid, cells in active:
                    u = self._get(rid)
                    u.device_s += share
                    u.dispatches += 1
                    u.turns += chunk
                    u.cells += chunk * cells
                    self._attributed_s += share
        self._wall_end(t0)

    def charge_turns(self, run_id: str, turns: int, cells: int) -> None:
        """Host-side turn advancement (e.g. fuse-trim) with no
        measured dispatch wall behind it."""
        t0 = self._wall_begin()
        with self._lock:
            u = self._get(run_id)
            u.turns += turns
            u.cells += cells
        self._wall_end(t0)

    def charge_wire(self, run_id, bytes_in: int, bytes_out: int) -> None:
        t0 = self._wall_begin()
        with self._lock:
            u = self._get(run_id)
            u.wire_in += bytes_in
            u.wire_out += bytes_out
        self._wall_end(t0)

    def charge_broadcast(self, run_id, frames: int, nbytes: int) -> None:
        """Publish-side frames (pre fan-out), from the hub."""
        t0 = self._wall_begin()
        with self._lock:
            u = self._get(run_id)
            u.bc_frames += frames
            u.bc_bytes += nbytes
        self._wall_end(t0)

    def charge_broadcast_sent(
            self, pend: Dict[str, Sequence[int]]) -> None:
        """Delivered (run -> [frames, bytes]) batch from the gateway's
        0.5 s flush — per-subscriber sends pre-summed per run."""
        if not pend:
            return
        t0 = self._wall_begin()
        with self._lock:
            for rid, (frames, nbytes) in pend.items():
                u = self._get(rid)
                u.sent_frames += frames
                u.sent_bytes += nbytes
        self._wall_end(t0)

    def charge_ckpt(self, run_id, nbytes: int) -> None:
        t0 = self._wall_begin()
        with self._lock:
            self._get(run_id).ckpt_bytes += nbytes
        self._wall_end(t0)

    def charge_journal(self, run_id, nbytes: int) -> None:
        t0 = self._wall_begin()
        with self._lock:
            self._get(run_id).journal_bytes += nbytes
        self._wall_end(t0)

    # -- publication -----------------------------------------------------

    def publish(self, now: Optional[float] = None,
                capacity: Optional[Iterable[dict]] = None) -> None:
        """Rebuild the reference-swapped doc and set gauges.  Called
        from the engine flush; throttled to ``GOL_USAGE_FLUSH_S`` so
        RPC-driven rebuilds stay cheap too."""
        t0 = self._wall_begin()
        now = time.time() if now is None else now
        flush_s = env_float(FLUSH_ENV, FLUSH_DEFAULT_S)
        with self._lock:
            if capacity is not None:
                self._capacity = list(capacity)
                for row in self._capacity:
                    b = str(row.get("bucket", ""))
                    obs.CAPACITY_ADMISSIBLE_RUNS.labels(bucket=b).set(
                        row.get("admissible", 0))
                    obs.CAPACITY_CUPS_HEADROOM.labels(bucket=b).set(
                        row.get("cups_headroom", 0.0))
                    obs.CAPACITY_RUN_COST_BYTES.labels(bucket=b).set(
                        row.get("run_cost_bytes", 0))
                if self._capacity:
                    obs.CAPACITY_FREE_BYTES.set(
                        self._capacity[0].get("free_bytes", 0))
            if now - self._doc_ts >= flush_s or not self._doc:
                self._doc = self._build_doc_locked(now)
                self._doc_ts = now
                obs.USAGE_FLUSHES.inc()
        self._wall_end(t0)

    def _build_doc_locked(self, now: float) -> dict:
        k = env_int(TOPK_ENV, TOPK_DEFAULT)
        ranked = sorted(self._runs.values(),
                        key=lambda u: u.device_s, reverse=True)
        total = self._attributed_s
        top = []
        for u in ranked[:k]:
            row = u.record(now)
            row["run_id"] = u.run_id
            row["share_pct"] = round(
                u.device_s / total * 100.0, 2) if total > 0 else 0.0
            top.append(row)
        err_pct = (abs(self._attributed_s - self._wall_s)
                   / self._wall_s * 100.0) if self._wall_s > 0 else 0.0
        doc = {
            "runs_tracked": len(self._runs),
            "retired_runs": self._retired_runs,
            "k": k,
            "top": top,
            "attribution": {
                "wall_s": round(self._wall_s, 6),
                "attributed_s": round(self._attributed_s, 6),
                "error_pct": round(err_pct, 4),
            },
            "untracked": {
                "events": self._untracked_events,
                "device_s": round(self._untracked.device_s, 6),
                "wire_in": self._untracked.wire_in,
                "wire_out": self._untracked.wire_out,
                "bc_bytes": self._untracked.bc_bytes,
            },
            "capacity": list(self._capacity),
        }
        return doc

    def usage_doc(self, now: Optional[float] = None) -> dict:
        """Current usage doc; rebuilt lazily when stale so members
        without a live engine flush (pure RPC contexts) still answer
        ``GetUsage`` with fresh numbers."""
        now = time.time() if now is None else now
        if now - self._doc_ts >= env_float(FLUSH_ENV, FLUSH_DEFAULT_S):
            self.publish(now)
        return self._doc

    def run_doc(self, run_id: str) -> dict:
        """Live record for one tracked run; KeyError when absent (the
        server maps it onto the standard unknown-run redirect)."""
        with self._lock:
            u = self._runs.get(run_id)
            if u is None:
                raise KeyError(f"unknown run {run_id!r}")
            rec = u.record(time.time())
            rec["run_id"] = run_id
            return rec

    def export_summary(self) -> Optional[dict]:
        """Compact "use" family for the heartbeat snapshot:
        scalars plus a tiny top list (``[[run_id, device_s], ...]``,
        at most ``SNAP_TOP`` rows).  None when there is nothing to
        report so the family costs zero snapshot bytes at idle."""
        with self._lock:
            if not self._runs and not self._capacity:
                return None
            ranked = sorted(self._runs.values(),
                            key=lambda u: u.device_s, reverse=True)
            adm = 0
            hr = 0.0
            for row in self._capacity:
                adm = max(adm, int(row.get("admissible", 0)))
                hr += float(row.get("cups_headroom", 0.0))
            return {
                "tracked": len(self._runs),
                "adm": adm,
                "hr": round(hr, 1),
                "top": [[u.run_id, round(u.device_s, 4)]
                        for u in ranked[:SNAP_TOP]],
            }

    def reset(self) -> None:
        """Test/bench hook: drop all state (not used in serving)."""
        with self._lock:
            self._runs.clear()
            self._untracked = RunUsage("", 0.0)
            self._untracked_events = 0
            self._retired_device_s = 0.0
            self._retired_runs = 0
            self._wall_s = 0.0
            self._attributed_s = 0.0
            self._capacity = []
            self._doc = {}
            self._doc_ts = 0.0
            obs.USAGE_RUNS_TRACKED.set(0)


METER = UsageMeter()


def usage_doc() -> dict:
    """Module-level accessor used by /healthz and the GetUsage RPC."""
    return METER.usage_doc()
