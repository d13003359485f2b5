"""The fleet audit log: who joined, who died, who adopted what, when —
the counterpart of `gol_tpu/obs/audit.py`, writing the same
`gol-fleet-audit/1` records. The port's fleet notes quarantines here and
the migration coordinator its phases; the `GetAudit` RPC reads the member
ring, and the federation agent's heartbeat drains the queue to the
router's durable log (`obs/export.SnapshotExporter`).

Two halves, one schema (`gol-fleet-audit/1`):

  * `AuditLog` — the registry-tier durable stream. Append-only JSONL
    records with a monotonic per-log `seq`, size-capped rotation
    (GOL_AUDIT_MAX_BYTES per file, GOL_AUDIT_KEEP rotated siblings),
    plus an in-memory ring tail that serves `GetAudit` without
    touching disk. Durability is opt-in: construct with a path (the
    router wires GOL_AUDIT_DIR) or run memory-only.

  * module-level `note(kind, ...)` — the member-side event queue.
    Data-plane hook points (quarantine in fleet/engine.py, migration
    phases in migrate.py) drop a bounded record here; the heartbeat
    exporter (obs/export.py) drains it into the next snapshot with
    commit-on-ack semantics, so member events land in the ROUTER's
    durable log over connections we already pay for.

Record shape:

    {"schema": "gol-fleet-audit/1", "seq": 17, "ts": 1754500000.1,
     "kind": "member_death", "member": "127.0.0.1:4242", ...}

Kinds are a closed set (clamped, metered via
gol_audit_records_total{kind}); free-form detail rides as extra keys.
Stdlib only.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from collections import deque
from typing import Optional

__all__ = ["SCHEMA", "AUDIT_KINDS", "AuditLog", "audit_kind_label",
           "note", "peek_pending", "commit_pending", "recent"]

SCHEMA = "gol-fleet-audit/1"

# The kind set is declared in the catalog (single source for the
# gol_audit_records_total label discipline).
from gol_tpu_torch.obs.catalog import AUDIT_KINDS  # noqa: E402

ENV_MAX_BYTES = "GOL_AUDIT_MAX_BYTES"   # rotate when file exceeds this
ENV_KEEP = "GOL_AUDIT_KEEP"             # rotated siblings kept
DEFAULT_MAX_BYTES = 4 << 20
DEFAULT_KEEP = 2
RING = 512                              # in-memory tail per log
FILE_NAME = "audit.jsonl"


def audit_kind_label(kind: str) -> str:
    """Clamp arbitrary record kinds to the declared set (metric label
    discipline; the record itself keeps the raw kind)."""
    return kind if kind in AUDIT_KINDS else "other"


class AuditLog:
    """Append-only JSONL with rotation and an in-memory ring tail."""

    def __init__(self, path: Optional[str] = None,
                 max_bytes: Optional[int] = None,
                 keep: Optional[int] = None) -> None:
        self.path = path
        if max_bytes is None:
            try:
                max_bytes = int(os.environ.get(ENV_MAX_BYTES, "")
                                or DEFAULT_MAX_BYTES)
            except ValueError:
                max_bytes = DEFAULT_MAX_BYTES
        if keep is None:
            try:
                keep = int(os.environ.get(ENV_KEEP, "") or DEFAULT_KEEP)
            except ValueError:
                keep = DEFAULT_KEEP
        self.max_bytes = max(int(max_bytes), 4096)
        self.keep = max(int(keep), 0)
        self._lock = threading.Lock()
        self._seq = 0
        self._ring: deque = deque(maxlen=RING)
        self._fh: Optional[io.TextIOBase] = None
        self._size = 0
        if path:
            os.makedirs(path, exist_ok=True)
            self._open()

    # ------------------------------------------------------------- disk

    def _file(self, n: int = 0) -> str:
        base = os.path.join(self.path, FILE_NAME)
        return base if n == 0 else f"{base}.{n}"

    def _open(self) -> None:
        self._fh = open(self._file(), "a", encoding="utf-8")
        self._size = self._fh.tell()

    def _rotate_locked(self) -> None:
        self._fh.close()
        for n in range(self.keep, 0, -1):
            src = self._file(n - 1) if n > 1 else self._file()
            dst = self._file(n)
            if os.path.exists(src):
                os.replace(src, dst)
        if self.keep == 0:
            os.remove(self._file())
        self._open()

    # ----------------------------------------------------------- append

    def append(self, kind: str, **fields) -> dict:
        """One durable record; returns it (with schema/seq/ts)."""
        with self._lock:
            self._seq += 1
            rec = {"schema": SCHEMA, "seq": self._seq,
                   "ts": fields.pop("ts", None) or time.time(),
                   "kind": str(kind)}
            rec.update(fields)
            self._ring.append(rec)
            if self._fh is not None:
                try:
                    line = json.dumps(rec, sort_keys=True,
                                      default=str) + "\n"
                    self._fh.write(line)
                    self._fh.flush()
                    self._size += len(line)
                    if self._size > self.max_bytes:
                        self._rotate_locked()
                except OSError:
                    pass  # a full disk must not take the router down
        try:
            from gol_tpu_torch.obs import catalog as obs
            obs.AUDIT_RECORDS.labels(
                kind=audit_kind_label(str(kind))).inc()
        except Exception:
            pass
        return rec

    # ------------------------------------------------------------ reads

    def tail(self, since_seq: int = 0, limit: int = 100) -> list:
        """Ring records with seq > since_seq, oldest first, capped."""
        limit = max(int(limit), 1)
        with self._lock:
            out = [r for r in self._ring if r["seq"] > since_seq]
        return out[:limit]

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


# --------------------------------------------------- member-side events

# Bounded queues: `_pending` holds events awaiting a heartbeat ride
# (drained with commit-on-ack by obs/export.py — a lost beat re-ships
# them); `_recent` keeps a local tail with its own seq so a member can
# answer GetAudit about itself even though the durable log lives at the
# router. Overflow drops the OLDEST pending event — recency wins.
_PENDING_MAX = 256
_events_lock = threading.Lock()
_pending: deque = deque(maxlen=_PENDING_MAX)
_recent: deque = deque(maxlen=RING)
_local_seq = 0


def note(kind: str, **fields) -> dict:
    """Queue one member-side audit event for the next heartbeat
    snapshot. Cheap (a deque append) — safe from data-plane paths."""
    global _local_seq
    with _events_lock:
        _local_seq += 1
        rec = {"schema": SCHEMA, "seq": _local_seq, "ts": time.time(),
               "kind": str(kind)}
        rec.update(fields)
        _pending.append(rec)
        _recent.append(rec)
    try:
        from gol_tpu_torch.obs import catalog as obs
        obs.AUDIT_RECORDS.labels(kind=audit_kind_label(str(kind))).inc()
    except Exception:
        pass
    return rec


def peek_pending(limit: int = 32) -> list:
    """Up to `limit` queued events, oldest first — NOT removed until
    `commit_pending` confirms the ack."""
    with _events_lock:
        return list(_pending)[:max(int(limit), 0)]


def commit_pending(n: int) -> None:
    """Drop the n oldest pending events (they reached the router)."""
    with _events_lock:
        for _ in range(min(max(int(n), 0), len(_pending))):
            _pending.popleft()


def recent(since_seq: int = 0, limit: int = 100) -> list:
    """The member-local event tail (serves GetAudit on members)."""
    limit = max(int(limit), 1)
    with _events_lock:
        out = [r for r in _recent if r["seq"] > since_seq]
    return out[:limit]
