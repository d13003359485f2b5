"""Retention: keep-last-N ∪ keep-every-K-turns, crash-safe GC — a copy of
`gol_tpu/ckpt/retention.py`.

Deletion order is the mirror of publish order: the MANIFEST goes first
(the checkpoint stops being durable in one atomic unlink), the payload
second — a crash between the two leaves an orphan payload, which is
exactly the state a crash mid-publish leaves, and the same aged-orphan
sweep collects both. `keep_last` is clamped to >= 1 so no configuration
can delete the newest durable checkpoint.

Orphans and `*.tmp` litter are only swept once they are older than
`ORPHAN_GRACE_SECONDS`: a payload published moments ago by ANOTHER
process (the in-process writer holds `dir_lock` across
publish+retention, but a second process — say a SIGTERM'd predecessor —
does not share that lock) may still be waiting on its manifest.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict

from gol_tpu_torch.ckpt import manifest as mf
from gol_tpu_torch.obs.log import log as obs_log

ORPHAN_GRACE_SECONDS = 60.0

_DIR_LOCKS: Dict[str, threading.Lock] = {}
_DIR_LOCKS_GUARD = threading.Lock()


def dir_lock(directory: str) -> threading.Lock:
    """Process-wide per-directory mutation lock, so the run's background
    writer and an emergency write_sync on another thread never interleave
    publishes or sweep each other's in-flight payloads."""
    key = os.path.realpath(directory)
    with _DIR_LOCKS_GUARD:
        lock = _DIR_LOCKS.get(key)
        if lock is None:
            lock = _DIR_LOCKS[key] = threading.Lock()
        return lock


class RetentionPolicy:
    """keep_last newest checkpoints (always >= 1) plus every checkpoint
    whose turn is divisible by keep_every (0 disables pinning)."""

    def __init__(self, keep_last: int = 3, keep_every: int = 0) -> None:
        self.keep_last = max(1, int(keep_last))
        self.keep_every = max(0, int(keep_every))

    def apply(self, directory: str, locked: bool = False) -> dict:
        """Delete non-retained checkpoints and aged garbage; returns
        {"removed": [...], "kept": [...]} of checkpoint turns. `locked`
        asserts the caller already holds dir_lock (the writer's publish
        path, which must not re-acquire)."""
        if not locked:
            with dir_lock(directory):
                return self.apply(directory, locked=True)

        entries = list(mf.list_checkpoints(directory))  # turn-ascending
        keep = set(t for t, _, _ in entries[-self.keep_last:])
        if self.keep_every:
            keep.update(t for t, _, _ in entries
                        if t % self.keep_every == 0)
        removed = []
        for turn, man_path, m in entries:
            if turn in keep:
                continue
            payload = mf.payload_path(man_path, m)
            try:
                os.unlink(man_path)  # durability bit cleared FIRST
                if os.path.exists(payload):
                    os.unlink(payload)
                removed.append(turn)
            except OSError as e:
                obs_log("ckpt.gc_failed", level="warn",
                        path=man_path, error=str(e))
        swept = _sweep_garbage(directory)
        if removed or swept:
            obs_log("ckpt.gc", removed=len(removed), swept=swept,
                    kept=len(keep))
        return {"removed": removed, "kept": sorted(keep)}


def _sweep_garbage(directory: str) -> int:
    """Remove aged *.tmp litter and orphan payloads (payload without a
    manifest = a crash between the two publishes)."""
    now = time.time()
    swept = 0
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return 0
    present = set(names)
    for name in names:
        path = os.path.join(directory, name)
        orphan = (name.startswith(mf.CKPT_PREFIX)
                  and name.endswith(mf.PAYLOAD_SUFFIX)
                  and name[:-len(mf.PAYLOAD_SUFFIX)] + mf.MANIFEST_SUFFIX
                  not in present)
        if not (name.endswith(".tmp") or orphan):
            continue
        try:
            if now - os.path.getmtime(path) < ORPHAN_GRACE_SECONDS:
                continue
            os.unlink(path)
            swept += 1
        except OSError:
            continue
    return swept
