"""Fleet engine: thousands of resident runs, one device launch a quantum —
the counterpart of `gol_tpu/fleet/engine.py` on one CUDA device.

Runs are binned into padded size buckets (`fleet/buckets.py`), each
stepped as ONE launch of K9 (`ops/cuda_stencil.fleet_run_turns`) per
serving quantum: the per-quantum serving cost (launch, sync, flag
service, telemetry) is amortized across every run of the bucket.

Scheduling: a single loop thread round-robins the non-empty buckets,
dispatching a fixed quantum of GOL_FLEET_CHUNK turns per visit. The
quantum is deliberately SMALL (default 8): it bounds every run's flag
latency to one rotation and keeps the serving fair — throughput comes
from the batch axis, not from long chunks. Between dispatches the loop
services per-run control flags (the same pause/quit/kill semantics as
`ControlFlagProtocol`, per handle), admissions, reseeds, and target
completions; a run whose remaining turns are smaller than the quantum
is trimmed by stepping its slot's bucket torus outside the batch
(`Bucket.run_slot`: K1 for a slot K1 holds, K2 beyond, the sharded
deep-halo path on a spatial bucket) so targets are hit EXACTLY.

Pause/park freeze mechanics: the batch steps every slot every quantum,
so a paused or parked run's authoritative board is COPIED to the handle
(`frozen`) and the slot steps on as garbage; resume restamps the slot.
State never leaks: readers always prefer `frozen` when set.

Legacy contract: the engine itself is the run surface for run "run0" —
capability-less peers that never send a run_id get bit-identical
single-run behaviour (`server_distributor`/`get_world`/flags/ckpt all
route to the legacy handle), and the legacy run bypasses admission (it
predates the quota; fleet-created runs are the ones policed).

The legacy drive counts only turns stepped from its current seed. In
`gol_tpu` a quantum dispatched before `_drive` installs a seed can be
credited after it, park the run at the new target and release the
drive with the old stepping's board or the unstepped seed (ROADMAP C,
"behaviours of the reference"); here the post-sync bookkeeping skips a
handle whose seed is pending (only the loop applies seeds, at its next
service pass, so a pending seed is the one way a reseed meets a quantum
in flight).

Federation adoption and live migration are the engine halves of
`federation/router.py` and `migrate.py`: `adopt_run` registers a dead
member's run quarantined so the restore path re-homes it from its
per-run checkpoints; `migrate_quiesce` parks a run with a readback of
its slot ordered after every K9 launch before it on the device's stream;
`import_run` stages a migrated-in board hidden from ListRuns and out of
every bucket until `activate_imported` (CommitRun) queues it.

Mesh placement: an explicit `devices=[...]` list (a device may repeat,
as `Engine(devices=)` allows) wins; else GOL_FLEET_MESH_DEVICES=N takes
the first N distinct visible CUDA devices; else the fleet stays on one
device. Each bucket class is placed by `choose_placement` over those
devices ('single', 'batch' or 'spatial', `fleet/buckets.py`). The device
is CUDA unless the caller passes `device="cpu"`
(`engine.resolve_device`); there is no fallback.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gol_tpu_torch import ckpt as ckpt_mod
from gol_tpu_torch import journal as journal_mod
from gol_tpu_torch.ckpt import CKPT_DIR_ENV as CKPT_ENV
from gol_tpu_torch.engine import (
    ControlFlagProtocol,
    EngineBusy,
    EngineKilled,
    FLAG_KILL,
    FLAG_PAUSE,
    FLAG_QUIT,
    resolve_device,
    view_factor,
)
from gol_tpu_torch.fleet.admission import AdmissionController, run_cost
from gol_tpu_torch.fleet.buckets import (
    Bucket,
    DEFAULT_BUCKET_SIZES,
    DEFAULT_SLOT_BASE,
    board_to_words,
    cell_dtype,
    choose_bucket_size,
    choose_placement,
    private_shape,
    words_to_board,
)
from gol_tpu_torch.fleet.handles import (
    LEGACY_RUN_ID,
    FleetUnsupported,
    RunHandle,
    crop_alive,
    tiles_for,
    valid_run_id,
)
from gol_tpu_torch.models.lifelike import CONWAY, LifeLikeRule
from gol_tpu_torch.obs import audit as obs_audit
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import devstats as obs_devstats
from gol_tpu_torch.obs import slo as obs_slo
from gol_tpu_torch.obs import timeline as obs_timeline
from gol_tpu_torch.obs import usage as obs_usage
from gol_tpu_torch.obs.log import exception as obs_exception
from gol_tpu_torch.obs.log import log as obs_log
from gol_tpu_torch.ops.bitpack import WORD_BITS, words_to_numpy
from gol_tpu_torch.parallel.mesh import (
    default_devices,
    make_batch_mesh,
    make_mesh,
    mesh_geometry,
)
from gol_tpu_torch.utils.envcfg import env_float, env_int

BUCKETS_ENV = "GOL_FLEET_BUCKETS"     # csv of square class sides
CHUNK_ENV = "GOL_FLEET_CHUNK"         # serving quantum in turns
SLOT_BASE_ENV = "GOL_FLEET_SLOT_BASE"  # initial slots per bucket
MESH_DEVICES_ENV = "GOL_FLEET_MESH_DEVICES"  # placement mesh width
DEFAULT_CHUNK = 8

METRICS_FLUSH_SECONDS = 0.5  # same batched-flush cadence as engine.py

# How long create_run/load_checkpoint wait for the loop to place a run.
_PLACE_TIMEOUT_S = 60.0

# Quarantine auto-restore policy: a faulted run is re-seeded from its
# last per-run checkpoint at most TRIES times, spaced by exponential
# backoff starting at BACKOFF seconds. Past the cap the run stays
# "quarantined" until an operator destroys (or reseeds) it — a board
# that faults repeatedly must never oscillate back into the shared
# batched dispatch.
QUARANTINE_TRIES_ENV = "GOL_QUARANTINE_TRIES"
QUARANTINE_TRIES_DEFAULT = 3
QUARANTINE_BACKOFF_ENV = "GOL_QUARANTINE_BACKOFF"
QUARANTINE_BACKOFF_DEFAULT_S = 0.5

# A staged migration import whose coordinator died (source process
# killed mid-cutover) must not hold admission budget forever: the
# fleet loop expires it after this long. Any live cutover commits or
# rolls it back within GOL_MIGRATE_DEADLINE, well before this fires.
IMPORT_STALE_ENV = "GOL_MIGRATE_STALE"
IMPORT_STALE_DEFAULT_S = 60.0



def _parse_sizes(raw: str) -> Tuple[int, ...]:
    sizes = tuple(int(s) for s in raw.split(",") if s.strip())
    if not sizes or any(s <= 0 or s % WORD_BITS for s in sizes):
        raise ValueError(f"bad {BUCKETS_ENV} value {raw!r}")
    return sizes


def _soup(run_id: str, h: int, w: int) -> np.ndarray:
    """Deterministic random seed board for seedless CreateRun: keyed by
    run_id via crc32 (hash() is salted per process and would break
    create-then-reattach reproducibility)."""
    rng = np.random.default_rng(zlib.crc32(run_id.encode("utf-8")))
    return (rng.random((h, w)) < 0.3).astype(np.uint8)


class FleetEngine(ControlFlagProtocol):
    """Batched multi-run engine behind the single-run engine surface."""

    frames_diffable = True
    binary_pixels = True  # life-like only: snapshots are strict {0,255}
    run_id = LEGACY_RUN_ID

    def __init__(
        self,
        rule=CONWAY,
        bucket_sizes: Optional[Sequence[int]] = None,
        chunk_turns: Optional[int] = None,
        slot_base: Optional[int] = None,
        admission: Optional[AdmissionController] = None,
        device=None,
        devices=None,
    ) -> None:
        if not isinstance(rule, LifeLikeRule):
            raise ValueError(
                "fleet engine batches the packed life-like stencil; "
                f"rule {getattr(rule, 'rulestring', rule)!r} unsupported")
        self._rule = rule
        # Placement devices: the mesh the fleet shards buckets over, as
        # stamped in stats and bench records. Explicit `devices` wins;
        # else GOL_FLEET_MESH_DEVICES takes the first N distinct visible
        # CUDA devices; else the fleet stays on one device.
        if devices is not None:
            self._devices = [resolve_device(d) for d in devices]
        else:
            first = resolve_device(device)
            want = env_int(MESH_DEVICES_ENV, 0, minimum=0)
            self._devices = ([first] if want <= 1 or first.type != "cuda"
                             else default_devices()[:want])
        if not self._devices:
            raise ValueError("fleet engine needs at least one device")
        self._device = self._devices[0]
        self._mesh_batch = (make_batch_mesh(self._devices)
                            if len(self._devices) > 1 else None)
        if self._mesh_batch is not None:
            obs_devstats.note_mesh(mesh_geometry(self._mesh_batch))
        obs.FLEET_MESH_DEVICES.set(len(self._devices))
        if bucket_sizes is not None:
            sizes = tuple(int(s) for s in bucket_sizes)
        else:
            sizes = _parse_sizes(
                os.environ.get(BUCKETS_ENV, "") or
                ",".join(str(s) for s in DEFAULT_BUCKET_SIZES))
        if any(s <= 0 or s % WORD_BITS for s in sizes):
            raise ValueError(f"bucket sizes must be word-aligned: {sizes}")
        self.bucket_sizes = tuple(sorted(sizes))
        self.chunk_turns = int(chunk_turns) if chunk_turns else env_int(
            CHUNK_ENV, DEFAULT_CHUNK, minimum=1)
        # Temporal fusion (GOL_FUSE_K): every serving quantum advances
        # chunk_turns × fuse_k turns in ONE bucket dispatch — k× fewer
        # popcount syncs and wrapper calls per turn. Resolved once at
        # construction (auto/0 means unfused here: the bucket step has
        # no adaptive depth to keep).
        from gol_tpu_torch.ops.fused import configured_fuse_k

        self.fuse_k = max(1, configured_fuse_k())
        obs_devstats.note_fuse(self.fuse_k)
        self.slot_base = int(slot_base) if slot_base else env_int(
            SLOT_BASE_ENV, DEFAULT_SLOT_BASE, minimum=1)
        self.admission = admission or AdmissionController(
            devices=len(self._devices), device=self._devices)
        # Shared checkpoint writer pool: a bounded worker set
        # serves every run's cadence checkpoints round-robin instead of
        # one lazy thread per resident run. Created on first use.
        self._ckpt_pool = None

        # ControlFlagProtocol state (legacy flags stash until run0
        # exists; then flags go straight to the handle's queue).
        self._flags: "queue_mod.Queue[int]" = queue_mod.Queue()
        self._killed = False
        self._abort = threading.Event()
        self._state_lock = threading.RLock()
        self._running = False
        self._run_token: Optional[str] = None
        self._turn = 0
        self._alive_pub: Optional[Tuple[int, int]] = None

        # Fleet scheduling state: one lock guards runs/buckets/queues;
        # the loop condition-waits on it when idle.
        self._fleet_lock = threading.RLock()
        self._wake = threading.Condition(self._fleet_lock)
        self._runs: Dict[str, RunHandle] = {}
        self._buckets: Dict[tuple, Bucket] = {}
        self._rr: deque = deque()          # bucket keys, rotation order
        self._placeq: List[RunHandle] = []  # admitted, awaiting a slot
        self._waitq: deque = deque()        # beyond capacity, queued
        self._run_seq = 0
        self._loop_thread: Optional[threading.Thread] = None
        # Broadcast publish hook: poked once per serving quantum (same
        # contract as Engine._bcast_notify — cheap, never raises).
        self._bcast_notify = None

        # Telemetry (legacy stats keys + the fleet bench counters).
        self._turns_per_s = 0.0
        self._chunk_overhead_us = 0.0
        self._board_turns = 0        # per-run turns retired, summed
        self._cell_updates = 0       # board cells x turns retired
        self._dispatches = 0
        self._latency_samples: deque = deque(maxlen=8192)
        # SLO aggregates: bounded-memory log-bucket estimators,
        # touched ONLY at the batched flush cadence (never per quantum).
        self._quantum_est: Dict[str, obs_slo.LogBucketEstimator] = {}
        self._queue_wait_est = obs_slo.LogBucketEstimator()

    # ------------------------------------------------------ run surface

    @property
    def device(self) -> torch.device:
        return self._device

    def resolve_run(self, run_id: Optional[str] = None):
        """None/""/"run0" -> the engine itself (the legacy surface);
        a fleet run_id -> a RunView bound to that handle."""
        if run_id in (None, "", LEGACY_RUN_ID):
            return self
        with self._fleet_lock:
            handle = self._runs.get(run_id)
        if handle is None:
            raise KeyError(f"unknown run {run_id!r}")
        return RunView(self, handle)

    def list_runs(self) -> list:
        # Staged (un-committed) migration imports are hidden: until
        # CommitRun flips authority, the SOURCE member's copy is the
        # one listed copy fleet-wide — never zero, never two.
        with self._fleet_lock:
            return [h.describe() for h in sorted(
                self._runs.values(), key=lambda h: h.created_s)
                if h.migrating is None
                or not h.migrating.startswith("staged")]

    def runs_summary(self) -> dict:
        with self._fleet_lock:
            by_state: Dict[str, int] = {}
            for h in self._runs.values():
                by_state[h.state] = by_state.get(h.state, 0) + 1
            return {
                "resident": by_state.get("resident", 0),
                "queued": by_state.get("queued", 0),
                "parked": by_state.get("parked", 0),
                "quarantined": by_state.get("quarantined", 0),
                "total": len(self._runs),
                "engine": "FleetEngine",
            }

    def describe_run(self) -> dict:
        with self._fleet_lock:
            h = self._runs.get(LEGACY_RUN_ID)
            if h is not None:
                return h.describe()
        return {"run_id": LEGACY_RUN_ID, "state": "queued", "board": None,
                "rule": self._rule.rulestring, "turn": 0, "alive": None,
                "alive_turn": None, "paused": False, "bucket": None,
                "viewers": 0, "ckpt_every": 0, "target_turn": None}

    # -------------------------------------------------------- admission

    def create_run(self, h: int, w: int, board: Optional[np.ndarray] = None,
                   run_id: Optional[str] = None, rule=None,
                   ckpt_every: int = 0,
                   target_turn: Optional[int] = None,
                   queue: bool = False, wait: bool = True) -> dict:
        """Admit + place a new run; returns its describe() record.

        Rejections raise RuntimeError("admission rejected: <reason>")
        after metering `gol_runs_rejected_total{reason}`; with
        `queue=True` a capacity rejection parks the request in the
        bounded wait queue instead (state "queued" in the returned
        record — it becomes resident when capacity frees).
        `wait=False` skips blocking on device placement (the record
        comes back "queued"; the loop drains the whole placement queue
        in one service pass — how a bench admits hundreds of runs
        without serializing on the serving quantum)."""
        self._check_alive()
        run_rule = self._resolve_rule(rule)
        h, w = int(h), int(w)
        if run_id is None:
            run_id = self._next_run_id()
        elif not valid_run_id(run_id) or run_id == LEGACY_RUN_ID:
            self.admission.reject("run_id")
            raise RuntimeError("admission rejected: run_id")
        size = choose_bucket_size(h, w, self.bucket_sizes)
        if size is None:
            self.admission.reject("shape")
            raise RuntimeError(
                "admission rejected: shape (board sides must divide a "
                f"bucket class {self.bucket_sizes})")
        derived = board is None
        if board is None:
            board = _soup(run_id, h, w)
        board01 = self._board01(board, h, w)
        cost = run_cost(size, size // WORD_BITS)

        handle = RunHandle(run_id, run_rule, h, w, ckpt_every=ckpt_every,
                           target_turn=target_turn)
        handle.bucket_key = (size, size, run_rule.rulestring,
                             cell_dtype(run_rule))
        handle.frozen = board01
        handle.admitted_cost = cost
        with self._fleet_lock:
            if run_id in self._runs:
                self.admission.reject("run_id")
                raise RuntimeError("admission rejected: run_id")
            ok, reason = self.admission.try_admit(cost)
            if not ok:
                if queue:
                    qok, qreason = self.admission.try_enqueue()
                    if qok:
                        handle.enqueued_s = time.monotonic()
                        self._runs[run_id] = handle
                        obs_usage.METER.track(run_id)
                        self._waitq.append(handle)
                        self._journal_create(handle, board01, derived)
                        self._wake.notify_all()
                        return handle.describe()
                    reason = qreason
                self.admission.reject(reason or "unknown")
                raise RuntimeError(f"admission rejected: {reason}")
            self._runs[run_id] = handle
            obs_usage.METER.track(run_id)
            self._placeq.append(handle)
            self._journal_create(handle, board01, derived)
            self._wake.notify_all()
        self._ensure_loop()
        if wait:
            self._await_placement(handle)
        with self._fleet_lock:
            return handle.describe()

    def destroy_run(self, run_id: str) -> dict:
        """Explicitly retire a fleet run: frees its bucket slot, returns
        the admission charge (so a queued waiter can promote on the next
        service pass), and drops the handle. Returns the run's final
        describe() record. The legacy run0 is refused — it IS the
        engine's single-run surface, not a fleet-created run; stop it
        with control flags instead."""
        self._check_alive()
        rid = str(run_id or "")
        with self._fleet_lock:
            if rid in ("", LEGACY_RUN_ID):
                raise PermissionError(
                    f"run {LEGACY_RUN_ID!r} is the legacy engine "
                    "surface; send QUIT/KILL control flags to stop it")
            h = self._runs.get(rid)
            if h is None:
                raise KeyError(f"unknown run {rid!r}")
            if h.migrating and not h.migrating.startswith("staged"):
                # A quiesced source copy is the rollback anchor; only
                # the migration coordinator may retire it (a staged
                # TARGET copy is destroyable — that IS the rollback).
                raise EngineBusy(f"run {rid} is migrating")
            rec = h.describe()
            self._remove_locked(h)
            rec["state"] = h.state
            # Capacity just freed: poke the loop so promotion/placement
            # happens now, not at the next natural wakeup.
            self._wake.notify_all()
        obs.RUNS_DESTROYED.inc()
        return rec

    def adopt_run(self, run_id: str, ckpt_every: int = 0,
                  target_turn: Optional[int] = None) -> dict:
        """Adopt a dead federation member's run from its per-run
        checkpoint directory under the shared GOL_CKPT root.

        Only the newest durable MANIFEST is read here — geometry, rule
        and turn; the payload itself stays untrusted. The run is
        admitted against the local budget and registered directly in
        state "quarantined", so the quarantine machinery performs the
        capped-backoff, integrity-verified restore and re-queues it for
        placement — adoption moves only checkpoint bytes and route
        state, never live board traffic."""
        from gol_tpu_torch.ckpt import manifest as mf

        self._check_alive()
        rid = str(run_id or "")
        if not valid_run_id(rid) or rid == LEGACY_RUN_ID:
            self.admission.reject("run_id")
            raise RuntimeError("admission rejected: run_id")
        with self._fleet_lock:
            existing = self._runs.get(rid)
            staged = (existing is not None and
                      (existing.migrating or "").startswith("staged"))
        if staged:
            # This member already holds the run's board as a staged
            # migration import (the source died mid-cutover, after the
            # transfer): promote it instead of restoring from the
            # checkpoint — its board is at the quiesce turn, at least
            # as new as any durable manifest.
            obs_log("fleet.adopt_staged", run_id=rid)
            rec = self.activate_imported(rid)
            obs.FED_ADOPTED_RUNS.labels(status="ok").inc()
            return rec
        base = os.environ.get(CKPT_ENV, "")
        if not base:
            raise RuntimeError(
                "checkpointing not configured (set GOL_CKPT)")
        directory = self._ckpt_dir(rid, base)
        latest = mf.latest_checkpoint(directory)
        if latest is None:
            raise FileNotFoundError(
                f"no durable checkpoint for run {rid} in {directory}")
        m = latest[2]
        board_meta = m.get("board")
        if not board_meta:
            raise RuntimeError(
                f"manifest for run {rid} carries no board dims")
        h_, w_ = int(board_meta["h"]), int(board_meta["w"])
        run_rule = self._resolve_rule(m.get("rule"))
        size = choose_bucket_size(h_, w_, self.bucket_sizes)
        if size is None:
            self.admission.reject("shape")
            raise RuntimeError(
                "admission rejected: shape (board sides must divide a "
                f"bucket class {self.bucket_sizes})")
        cost = run_cost(size, size // WORD_BITS)
        handle = RunHandle(rid, run_rule, h_, w_,
                           ckpt_every=int(ckpt_every),
                           target_turn=target_turn,
                           start_turn=int(m["turn"]))
        handle.bucket_key = (size, size, run_rule.rulestring,
                             cell_dtype(run_rule))
        handle.admitted_cost = cost
        # Born quarantined: no trusted board yet. The fleet loop's
        # restore path verifies + loads the checkpoint and queues the
        # run for placement; h.adopted routes the outcome to
        # gol_fed_adopted_runs_total.
        handle.state = "quarantined"
        handle.quarantine_reason = "restore"
        handle.adopted = True
        with self._fleet_lock:
            if rid in self._runs:
                self.admission.reject("run_id")
                raise RuntimeError("admission rejected: run_id")
            ok, reason = self.admission.try_admit(cost)
            if not ok:
                self.admission.reject(reason or "unknown")
                raise RuntimeError(f"admission rejected: {reason}")
            self._runs[rid] = handle
            obs_usage.METER.track(rid)
            self._wake.notify_all()
        obs_log("fleet.adopt", run_id=rid, turn=handle.turn,
                rule=run_rule.rulestring, board=f"{h_}x{w_}")
        # Lineage link: if the predecessor journaled, reference its
        # chain head so verify_segments can stitch across the failover
        # (the manifest's journal stamp is the durable carrier).
        jstamp = m.get("journal") or {}
        self._journal_event(
            rid, "link", turn=int(m["turn"]),
            prev_head=jstamp.get("head"), prev_seq=jstamp.get("seq"),
            reason="adopt")
        self._ensure_loop()
        return handle.describe()

    # ------------------------------------------------- live migration
    #
    # Engine-side halves of the Rescale cutover (migrate.py is the
    # coordinator). Authority discipline: quiesce marks the SOURCE copy
    # migrating (frozen board authoritative, flags deferred, destroy
    # refused) but it stays the listed owner; import_run stages a
    # hidden TARGET copy; only commit/rollback resolve which one
    # survives — at every instant exactly one copy is authoritative.

    def migrate_quiesce(self, run_id: str) -> dict:
        """Phase 1: freeze a run for transfer. Parks a resident run (a
        device readback to `frozen`: the slot's copy is enqueued on the
        stream every K9 launch of the bucket is on, so it reads the
        words of the last launch credited to `h.turn`, and the host copy
        waits for it), pulls a queued run out of the placement queue,
        and marks the handle migrating with its PRIOR state so rollback
        restores exactly what quiesce saw. The recorded target_turn
        rides the transfer, so a drive continues on the new owner.
        Returns the transfer record (board copy + identity)."""
        self._check_alive()
        rid = str(run_id or "")
        with self._fleet_lock, self._on_device():
            if rid in ("", LEGACY_RUN_ID):
                raise PermissionError(
                    f"run {LEGACY_RUN_ID!r} is the legacy engine "
                    "surface; it cannot be live-migrated")
            h = self._runs.get(rid)
            if h is None:
                raise KeyError(f"unknown run {rid!r}")
            if h.migrating is not None:
                raise EngineBusy(f"run {rid} is already migrating")
            if h.state == "quarantined" or h in self._waitq:
                raise EngineBusy(
                    f"run {rid} is {h.state} (no trusted board to "
                    "transfer); retry once it is placed")
            prior = h.state
            if h.state == "resident":
                self._park_locked(self._buckets[h.bucket_key], h)
            elif h.state == "queued":
                if h in self._placeq:
                    self._placeq.remove(h)
                h.state = "parked"
            if h.frozen is None:
                raise RuntimeError(
                    f"run {rid} has no board to transfer")
            h.migrating = prior
            self._wake.notify_all()
            jw = journal_mod.get(rid)
            return {
                "run_id": rid,
                "board": h.frozen.copy(),
                "turn": int(h.turn),
                "rule": h.rule.rulestring,
                "h": int(h.h), "w": int(h.w),
                "ckpt_every": int(h.ckpt_every),
                "target_turn": h.target_turn,
                "state": prior,
                # Chain head rides the transfer so the target's link
                # event can reference this segment's lineage.
                "journal_head": (jw.head_info() if jw is not None
                                 else None),
            }

    def migrate_checkpoint(self, run_id: str,
                           trigger: str = "migrate"):
        """Phase 2: durable belt under the transfer — if GOL_CKPT is
        configured, write a synchronous verified checkpoint of the
        quiesced board so a crash of BOTH processes mid-migration still
        resumes from this exact turn (adoption path). No-op without a
        checkpoint root."""
        if not os.environ.get(CKPT_ENV, ""):
            return None
        with self._fleet_lock:
            h = self._runs.get(str(run_id or ""))
            if h is None:
                raise KeyError(f"unknown run {run_id!r}")
        return self._ckpt_sync(h, None, trigger)

    def migrate_commit(self, run_id: str) -> list:
        """Final phase on the SOURCE: retire the migrated-away copy and
        hand back any control flags that arrived while quiesced (the
        coordinator relays them to the new owner). Idempotent: a second
        commit (or a commit after rollback already ran) returns []."""
        with self._fleet_lock:
            h = self._runs.get(str(run_id or ""))
            if h is None or h.migrating is None:
                return []
            flags = []
            while True:
                try:
                    flags.append(h.flags.get_nowait())
                except queue_mod.Empty:
                    break
            h.migrating = None
            # The run lives on elsewhere: flush its final usage
            # accounting, then bookend this segment with migrate_out
            # (not "end") so the stitched lineage reads as a handoff,
            # not a termination.
            self._retire_usage_locked(h)
            self._journal_event(h.run_id, "migrate_out",
                                turn=int(h.turn))
            self._remove_locked(h, journal_end=False)
            self._wake.notify_all()
        return flags

    def migrate_rollback(self, run_id: str) -> dict:
        """Undo a quiesce: restore the run to the state migrate_quiesce
        recorded. Idempotent — a handle that is gone or not migrating
        reports {"restored": False} and changes nothing."""
        with self._fleet_lock, self._on_device():
            h = self._runs.get(str(run_id or ""))
            if h is None or h.migrating is None:
                return {"restored": False}
            prior = h.migrating
            h.migrating = None
            if (prior in ("resident", "queued")
                    and h.state == "parked"
                    and (h.target_turn is None
                         or h.turn < h.target_turn)):
                # frozen reseeds the slot (or the placement queue for a
                # never-placed run) on the next service pass; a drive
                # the quiesce park disarmed re-arms. A run quiesced
                # resident AT its target stays parked — the loop only
                # parks armed drives, so resuming it would free-run it
                # past the target.
                self._resume_locked(h)
                if h.target_turn is not None:
                    h.done.clear()
            self._wake.notify_all()
            rec = h.describe()
        rec["restored"] = True
        return rec

    def import_run(self, run_id: str, board: np.ndarray, turn: int,
                   rule=None, ckpt_every: int = 0,
                   target_turn: Optional[int] = None,
                   activate: bool = True,
                   journal_head: Optional[dict] = None) -> dict:
        """TARGET half of the transfer: stage a migrated-in run. The
        board is admitted and registered parked+hidden ("staged"), with
        no slot in any bucket — invisible to list_runs and never
        auto-resumed — until CommitRun activates it. `activate=False`
        stages "staged-parked": commit leaves the run parked, preserving
        a source run that was itself parked (it must not start advancing
        because it moved)."""
        self._check_alive()
        rid = str(run_id or "")
        if not valid_run_id(rid) or rid == LEGACY_RUN_ID:
            self.admission.reject("run_id")
            raise RuntimeError("admission rejected: run_id")
        run_rule = self._resolve_rule(rule)
        board01 = np.asarray(board)
        h_, w_ = int(board01.shape[-2]), int(board01.shape[-1])
        board01 = self._board01(board01, h_, w_)
        size = choose_bucket_size(h_, w_, self.bucket_sizes)
        if size is None:
            self.admission.reject("shape")
            raise RuntimeError(
                "admission rejected: shape (board sides must divide a "
                f"bucket class {self.bucket_sizes})")
        cost = run_cost(size, size // WORD_BITS)
        handle = RunHandle(rid, run_rule, h_, w_,
                           ckpt_every=int(ckpt_every),
                           target_turn=target_turn,
                           start_turn=int(turn))
        handle.bucket_key = (size, size, run_rule.rulestring,
                             cell_dtype(run_rule))
        handle.frozen = board01
        handle.alive = int(board01.sum())
        handle.alive_turn = handle.turn
        handle.admitted_cost = cost
        handle.state = "parked"
        handle.migrating = "staged" if activate else "staged-parked"
        # A staged run with a target_turn must NOT look drivable to the
        # loop (it would auto-resume before commit) — done is only
        # cleared by a real drive request after activation.
        handle.done.set()
        with self._fleet_lock:
            if rid in self._runs:
                self.admission.reject("run_id")
                raise RuntimeError("admission rejected: run_id")
            ok, reason = self.admission.try_admit(cost)
            if not ok:
                self.admission.reject(reason or "unknown")
                raise RuntimeError(f"admission rejected: {reason}")
            self._runs[rid] = handle
            obs_usage.METER.track(rid)
        obs_log("fleet.import", run_id=rid, turn=handle.turn,
                rule=run_rule.rulestring, board=f"{h_}x{w_}")
        jstamp = journal_head or {}
        self._journal_event(
            rid, "link", turn=int(turn),
            prev_head=jstamp.get("head"), prev_seq=jstamp.get("seq"),
            reason="migrate")
        return handle.describe()

    def activate_imported(self, run_id: str) -> dict:
        """CommitRun on the TARGET: flip a staged import live. "staged"
        queues the run for placement (it resumes stepping where the
        source parked it); "staged-parked" stays parked — readable, not
        advancing — exactly as it was on the source."""
        self._check_alive()
        rid = str(run_id or "")
        with self._fleet_lock:
            h = self._runs.get(rid)
            if h is None:
                raise KeyError(f"unknown run {rid!r}")
            if not (h.migrating or "").startswith("staged"):
                raise RuntimeError(
                    f"run {rid} is not a staged import")
            staged = h.migrating
            h.migrating = None
            if staged == "staged":
                if (h.target_turn is not None
                        and h.turn >= h.target_turn):
                    # The source was resident only transiently (e.g.
                    # quiesced between placement and the loop's
                    # target-park pass). Nothing left to step — and the
                    # loop only parks runs with an ARMED drive, so
                    # queueing this one would free-run it past its
                    # target forever. Activate parked instead.
                    h.state = "parked"
                else:
                    h.state = "queued"
                    self._placeq.append(h)
                    # Re-arm the drive the staging deliberately
                    # disarmed: a run migrated mid-flight resumes
                    # stepping toward its original target.
                    if h.target_turn is not None:
                        h.done.clear()
                    self._wake.notify_all()
            rec = h.describe()
        self._ensure_loop()
        return rec

    def geometry(self) -> dict:
        """Placement stamp for checkpoint manifests / reshard deltas."""
        return {"kind": "fleet", "devices": len(self._devices)}

    def set_rule(self, run_id: str, rule) -> dict:
        """Migrate a fleet run to a new life-like rule WITHOUT dropping
        its board: the run is evicted from its current bucket (an exact
        device readback), its bucket key re-homed under the new
        rulestring, and readmitted through the existing placement queue.
        The admission charge is held across the migration — geometry is
        unchanged, so a migrating run can never lose its capacity to a
        waiter. Returns the run's describe() record (state "queued"
        until the loop re-places it). The legacy run0 is refused: its
        rule is the engine's construction-time rule."""
        self._check_alive()
        rid = str(run_id or "")
        if rule is None or rule == "":
            raise RuntimeError("admission rejected: rule (empty)")
        new_rule = self._resolve_rule(rule)
        with self._fleet_lock:
            if rid in ("", LEGACY_RUN_ID):
                raise PermissionError(
                    f"run {LEGACY_RUN_ID!r} is the legacy engine "
                    "surface; its rule is fixed at construction")
            h = self._runs.get(rid)
            if h is None:
                raise KeyError(f"unknown run {rid!r}")
            if h.rule.rulestring != new_rule.rulestring:
                self._migrate_rule_locked(h, new_rule)
                obs.RUNS_RULE_MIGRATIONS.inc()
                self._journal_event(rid, "rule", turn=int(h.turn),
                                    rule=new_rule.rulestring)
            rec = h.describe()
            self._wake.notify_all()
        self._ensure_loop()
        return rec

    def _migrate_rule_locked(self, h: RunHandle, new_rule) -> None:
        """Move a run between rule-keyed buckets, board intact. The old
        slot frees immediately; placement into the new-rule bucket rides
        the normal queue (same pass ordering as admissions)."""
        if h.slot is not None:
            bucket = self._buckets.get(h.bucket_key)
            if bucket is not None:
                if h.frozen is not None:
                    # Paused/parked: the handle copy is authoritative
                    # and the slot was stepping garbage — free it
                    # without readback.
                    bucket.release(h.slot)
                else:
                    h.frozen = bucket.evict(h.slot, h.h, h.w)
            h.slot = None
            if h.state == "resident":
                h.state = "queued"
                self._placeq.append(h)
            # Parked runs stay parked, slotless: _resume_locked requeues
            # them through placement when a drive resumes them.
        hb, wb = h.bucket_key[:2]
        h.rule = new_rule
        h.bucket_key = (hb, wb, new_rule.rulestring,
                        cell_dtype(new_rule))
        obs_log("fleet.rule_migrated", run_id=h.run_id,
                rule=new_rule.rulestring, turn=h.turn, state=h.state)

    def _resolve_rule(self, rule):
        if rule is None:
            return self._rule
        if isinstance(rule, str):
            from gol_tpu_torch.models import parse_rule

            rule = parse_rule(rule)
        if not isinstance(rule, LifeLikeRule):
            self.admission.reject("rule")
            raise RuntimeError(
                "admission rejected: rule (the fleet batches the packed "
                "life-like stencil; LtL/Lenia runs are served by the "
                "dense engine's conv/FFT tier)")
        return rule

    @staticmethod
    def _board01(board: np.ndarray, h: int, w: int) -> np.ndarray:
        board = np.asarray(board)
        if board.ndim != 2 or board.shape != (h, w):
            raise ValueError(
                f"seed board is {board.shape}, run is {(h, w)}")
        return np.ascontiguousarray((board != 0).astype(np.uint8))

    def _next_run_id(self) -> str:
        with self._fleet_lock:
            while True:
                self._run_seq += 1
                rid = f"run{self._run_seq}"
                if rid not in self._runs:
                    return rid

    def _await_placement(self, handle: RunHandle) -> None:
        deadline = time.monotonic() + _PLACE_TIMEOUT_S
        with self._wake:
            while handle.state == "queued" and handle.pending_seed is None:
                if self._killed:
                    raise EngineKilled("engine has been killed")
                if handle.slot is not None or handle.state != "queued":
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f"run {handle.run_id} not placed in "
                        f"{_PLACE_TIMEOUT_S:.0f}s")
                self._wake.wait(timeout=min(left, 0.2))

    # ----------------------------------------------------- legacy drive

    def server_distributor(self, params, world, sub_workers=(),
                           start_turn: int = 0,
                           token: Optional[str] = None
                           ) -> Tuple[np.ndarray, int]:
        """The reference blocking run, served from the fleet: the
        submitted world becomes (or reseeds) the legacy run0 handle,
        the loop steps it to start_turn + params.turns, and the final
        board comes back {0,255} — bit-identical to the dense engine
        (same packed stencil, same torus; the bucket tiling is exact)."""
        self._check_alive()
        with self._state_lock:
            if self._running:
                raise EngineBusy("engine already running a board")
            self._running = True
            self._run_token = token
        try:
            handle = self._legacy_handle(world, start_turn)
            return self._drive(handle, np.asarray(world), start_turn,
                               int(params.turns))
        finally:
            with self._state_lock:
                self._running = False
                self._run_token = None

    def _legacy_handle(self, world, start_turn: int) -> RunHandle:
        world = np.asarray(world)
        h, w = world.shape
        with self._fleet_lock:
            handle = self._runs.get(LEGACY_RUN_ID)
            if handle is not None and (handle.h, handle.w) != (h, w):
                # Board-shape change: retire the old legacy run (its
                # bucket slot frees) and re-create at the new geometry.
                self._remove_locked(handle)
                handle = None
            if handle is None:
                handle = RunHandle(LEGACY_RUN_ID, self._rule, h, w,
                                   start_turn=start_turn)
                size = choose_bucket_size(h, w, self.bucket_sizes)
                hb, wb = (size, size) if size else private_shape(h, w)
                handle.bucket_key = (hb, wb, self._rule.rulestring,
                                     cell_dtype(self._rule))
                handle.frozen = self._board01(world, h, w)
                # Legacy runs predate admission: never rejected, never
                # charged (admitted_cost stays 0).
                self._runs[LEGACY_RUN_ID] = handle
                obs_usage.METER.track(LEGACY_RUN_ID)
                # Transfer any flags posted before the run existed.
                try:
                    while True:
                        handle.flags.put(self._flags.get_nowait())
                except queue_mod.Empty:
                    pass
                self._placeq.append(handle)
                self._wake.notify_all()
            self._ensure_loop()
        return handle

    def _drive(self, handle: RunHandle, world: np.ndarray,
               start_turn: int, turns: int) -> Tuple[np.ndarray, int]:
        board01 = self._board01(world, handle.h, handle.w)
        with self._wake:
            if self._driving(handle):
                raise EngineBusy("run already being driven")
            handle.pending_seed = (board01, int(start_turn))
            handle.target_turn = int(start_turn) + int(turns)
            handle.done.clear()
            self._wake.notify_all()
        self._ensure_loop()
        while not handle.done.wait(timeout=0.2):
            if self._killed:
                raise EngineKilled("engine has been killed")
        if self._killed:
            raise EngineKilled("engine has been killed")
        with self._fleet_lock:
            board = handle.frozen
            turn = handle.turn
        if board is None:  # defensive: done implies parked/removed
            board, turn = self._run_board(handle)
        return (board * np.uint8(255)).astype(np.uint8), turn

    def _drive_run(self, handle: RunHandle, params, world,
                   start_turn: int) -> Tuple[np.ndarray, int]:
        """Run-scoped ServerDistributor: drive a FLEET run to a target.
        A submitted world reseeds the run at start_turn first; without
        one the run advances from wherever it is."""
        self._check_alive()
        if world is not None:
            return self._drive(handle, np.asarray(world), start_turn,
                               int(params.turns))
        with self._wake:
            if self._driving(handle):
                raise EngineBusy("run already being driven")
            handle.target_turn = handle.turn + int(params.turns)
            handle.done.clear()
            self._wake.notify_all()
        self._ensure_loop()
        while not handle.done.wait(timeout=0.2):
            if self._killed:
                raise EngineKilled("engine has been killed")
        if self._killed:
            raise EngineKilled("engine has been killed")
        with self._fleet_lock:
            board, turn = handle.frozen, handle.turn
        return (board * np.uint8(255)).astype(np.uint8), turn

    @staticmethod
    def _driving(handle: RunHandle) -> bool:
        return handle.target_turn is not None and not handle.done.is_set()

    # ------------------------------------------- legacy engine surface

    def ping(self) -> int:
        self._check_alive()
        with self._fleet_lock:
            h = self._runs.get(LEGACY_RUN_ID)
            return h.turn if h is not None else 0

    def alive_count(self) -> Tuple[int, int]:
        self._check_alive()
        with self._fleet_lock:
            h = self._runs.get(LEGACY_RUN_ID)
            if h is None:
                return 0, 0
            return h.alive, h.alive_turn

    def get_world(self) -> Tuple[np.ndarray, int]:
        self._check_alive()
        h = self._legacy_or_raise()
        board, turn = self._run_board(h)
        return (board * np.uint8(255)).astype(np.uint8), turn

    def get_world_frame(self, caps) -> Tuple[object, int]:
        from gol_tpu_torch import wire

        px, turn = self.get_world()
        return wire.encode_board(px, frozenset(caps), binary=True), turn

    def get_view(self, max_cells: int):
        self._check_alive()
        h = self._legacy_or_raise()
        return self._view_of(h, max_cells)

    @property
    def turns_per_dispatch(self) -> int:
        """Effective turns one serving quantum advances: the configured
        chunk × the temporal-fusion depth. Every turn-accounting site
        (handle advance, rollback, trim, counters, latency) uses THIS,
        not chunk_turns — a fused fleet's turn ledger stays exact."""
        return self.chunk_turns * self.fuse_k

    def stats(self) -> dict:
        self._check_alive()
        with self._fleet_lock:
            h = self._runs.get(LEGACY_RUN_ID)
            bucket_rows = [
                {"shape": f"{b.hb}x{b.wb}", "cap": b.cap,
                 "occupied": b.occupied, "dispatches": b.dispatches,
                 "placement": b.placement, "devices": b.devices}
                for b in self._buckets.values()]
            doc = {
                "turn": h.turn if h else 0,
                "running": bool(h and self._driving(h)),
                "board": [h.h, h.w] if h else None,
                "alive": h.alive if h else None,
                "alive_turn": h.alive_turn if h else None,
                "packed": True,
                "chunk": self.chunk_turns,
                "turns_per_s": round(self._turns_per_s, 1),
                "chunk_overhead_us": round(self._chunk_overhead_us, 2),
                "rule": self._rule.rulestring,
                "devices": len(self._devices),
                "fleet": {
                    "buckets": bucket_rows,
                    "chunk_turns": self.chunk_turns,
                    "fuse_k": self.fuse_k,
                    "turns_per_dispatch": self.turns_per_dispatch,
                    "mesh": self._mesh_doc_locked(),
                    **self.runs_summary(),
                },
            }
        doc["fleet"]["admission"] = self.admission.summary()
        return doc

    def _mesh_doc_locked(self) -> dict:
        """The placement mesh's stamp for stats() and bench records: the
        devices the fleet shards over, with the batch mesh's geometry
        when there is one."""
        doc: dict = {"devices": len(self._devices)}
        if self._mesh_batch is not None:
            doc.update(mesh_geometry(self._mesh_batch))
        return doc

    def _legacy_or_raise(self) -> RunHandle:
        with self._fleet_lock:
            h = self._runs.get(LEGACY_RUN_ID)
        if h is None:
            raise RuntimeError("no board loaded")
        return h

    # Flag routing: before run0 exists flags stash on the engine queue
    # (transferred at creation); after, they go to the handle and the
    # loop applies the protocol semantics per run.

    def cf_put(self, flag: int) -> None:
        self._check_alive()
        if flag not in (FLAG_PAUSE, FLAG_QUIT, FLAG_KILL):
            raise ValueError(f"unknown control flag {flag}")
        with self._fleet_lock:
            h = self._runs.get(LEGACY_RUN_ID)
            if h is not None and h.state != "removed":
                h.flags.put(flag)
                self._wake.notify_all()
            else:
                self._flags.put(flag)

    def drain_flags(self, pause_only: bool = False) -> None:
        self._check_alive()
        with self._fleet_lock:
            h = self._runs.get(LEGACY_RUN_ID)
            if h is not None and self._driving(h):
                return  # same contract as the single-run engines
            q = h.flags if h is not None else self._flags
            _drain_queue(q, pause_only)

    def kill_prog(self) -> None:
        self._killed = True
        with self._fleet_lock:
            for h in self._runs.values():
                h.done.set()
            self._wake.notify_all()
            t = self._loop_thread
        # Wait for the loop to drain its in-flight dispatch, so no daemon
        # thread is still inside a launch or a sync at interpreter exit.
        # Bounded — a wedged device must not turn kill into a hang.
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)
        with self._fleet_lock:
            pool, self._ckpt_pool = self._ckpt_pool, None
        if pool is not None:
            try:
                pool.close(timeout=5.0)
            except Exception:
                pass

    # --------------------------------------------------- checkpointing

    def checkpoint_now(self, directory: Optional[str] = None,
                       trigger: str = "manual") -> Tuple[str, int]:
        h = self._legacy_or_raise()
        return self._ckpt_sync(h, directory, trigger)

    def checkpoint_fleet(self, trigger: str = "sigterm") -> int:
        """Durably checkpoint every fleet run that has a board (the
        graceful-drain hook): returns how many runs were written. The
        legacy run is excluded — the SIGTERM handler already writes it
        through the pre-fleet path. Per-run failures are logged and
        skipped; drain must make progress past one bad run."""
        base = os.environ.get(CKPT_ENV, "")
        if not base:
            return 0
        with self._fleet_lock:
            handles = [
                h for h in self._runs.values()
                if h.run_id != LEGACY_RUN_ID
                and (h.state == "resident" or h.frozen is not None)]
        n = 0
        for h in handles:
            try:
                self._ckpt_sync(h, None, trigger)
                n += 1
            except Exception as e:
                obs_exception("fleet.drain_ckpt_failed", e,
                              run_id=h.run_id)
        return n

    def _ckpt_dir(self, run_id: str, base: str) -> str:
        """Per-run checkpoint directory: the legacy run keeps writing
        at the configured root (pre-fleet resume tooling reads there);
        fleet runs get contained run-<id> subdirectories. run_id is
        re-validated here so no request-supplied string ever reaches
        os.path.join unchecked."""
        if run_id == LEGACY_RUN_ID:
            return base
        if not valid_run_id(run_id):
            raise PermissionError(f"invalid run id {run_id!r}")
        return os.path.join(base, f"run-{run_id}")

    def _ckpt_sync(self, handle: RunHandle, directory: Optional[str],
                   trigger: str) -> Tuple[str, int]:
        base = directory or os.environ.get(CKPT_ENV, "")
        if not base:
            raise RuntimeError(
                "checkpointing not configured: set GOL_CKPT or pass "
                "--checkpoint DIR")
        self._check_alive()
        with self._fleet_lock, self._on_device():
            snap = self._snapshot_locked(handle, trigger)
        writer = ckpt_mod.CheckpointWriter(
            self._ckpt_dir(handle.run_id, base), run_id=handle.run_id,
            keep_last=env_int(ckpt_mod.CKPT_KEEP_ENV,
                              ckpt_mod.CKPT_KEEP_DEFAULT),
            keep_every=env_int(ckpt_mod.CKPT_KEEP_EVERY_ENV, 0,
                               minimum=0))
        return writer.write_sync(snap), snap.turn

    def _snapshot_locked(self, h: RunHandle, trigger: str):
        """A ckpt.Snapshot of one run, word-aligned runs as packed words
        (for resident runs, a view of the slot on the device: a dispatch
        writes a new batch, so the view keeps its turn's words while the
        writer copies them), others as {0,1} cells."""
        board_meta = (h.h, h.w)
        rulestring = h.rule.rulestring
        mesh = {"devices": len(self._devices)}
        if h.frozen is not None and (h.paused or h.state != "resident"):
            if h.w % WORD_BITS == 0:
                cells = np.ascontiguousarray(board_to_words(h.frozen))
                return ckpt_mod.Snapshot(
                    cells, "packed", h.turn, board_meta, rulestring,
                    trigger=trigger, mesh=mesh, fuse=self.fuse_k)
            return ckpt_mod.Snapshot(
                h.frozen.copy(), "u8", h.turn, board_meta, rulestring,
                trigger=trigger, mesh=mesh, fuse=self.fuse_k)
        bucket = self._buckets[h.bucket_key]
        if h.w % WORD_BITS == 0:
            cells = bucket.slot_words(h.slot)[: h.h, : h.w // WORD_BITS]
            return ckpt_mod.Snapshot(
                cells.contiguous(), "packed", h.turn, board_meta,
                rulestring, trigger=trigger, mesh=mesh, fuse=self.fuse_k,
                stream=(torch.cuda.current_stream(cells.device)
                        if cells.is_cuda else None))
        board = bucket.read_board(h.slot, h.h, h.w)
        return ckpt_mod.Snapshot(
            board, "u8", h.turn, board_meta, rulestring, trigger=trigger,
            mesh=mesh, fuse=self.fuse_k)

    def _ckpt_cadence_locked(self, h: RunHandle) -> None:
        """Async per-run cadence checkpoint (loop thread, lock held):
        snapshot capture is a pointer copy; the shared writer POOL does
        the rest — a bounded worker set draining runs round-robin, not
        one thread per resident run."""
        base = os.environ.get(CKPT_ENV, "")
        if not base:
            return
        if self._ckpt_pool is None:
            self._ckpt_pool = ckpt_mod.CheckpointWriterPool()
        self._ckpt_pool.submit(
            self._ckpt_dir(h.run_id, base), h.run_id,
            self._snapshot_locked(h, "periodic"),
            keep_last=env_int(ckpt_mod.CKPT_KEEP_ENV,
                              ckpt_mod.CKPT_KEEP_DEFAULT),
            keep_every=env_int(ckpt_mod.CKPT_KEEP_EVERY_ENV, 0,
                               minimum=0))

    # ------------------------------------------------------ run journal
    #
    # Every state-mutating input to a fleet run is appended to its
    # hash-chained gol-journal/1 log (gol_tpu/journal.py). Board
    # digests ride the existing bounded checkpoint-writer pool: the
    # CheckpointWriter appends a digest event from the packed payload
    # it already hashes for the manifest, so journaling adds no device
    # readbacks of its own. All hooks are best-effort — observability
    # must never sink a run.

    def _journal_event(self, run_id: str, kind: str, **fields) -> None:
        """Append one event to `run_id`'s journal; never raises."""
        try:
            jw = journal_mod.for_run(run_id)
            if jw is not None:
                jw.append(kind, **fields)
        except Exception:
            pass

    @staticmethod
    def _journal_board_sha(board01: np.ndarray) -> dict:
        """Digest fields for a {0,1} board, using the SAME payload
        representation _snapshot_locked would checkpoint it as (packed
        words when word-aligned, u8 otherwise) so journal digests and
        manifest board_sha256 values agree for the same turn."""
        if board01.shape[-1] % WORD_BITS == 0:
            words = np.ascontiguousarray(board_to_words(board01))
            return {"board_sha256": journal_mod.board_digest(
                words, "packed"), "repr": "packed"}
        return {"board_sha256": journal_mod.board_digest(
            board01, "u8"), "repr": "u8"}

    @staticmethod
    def _journal_seed(board01: np.ndarray, derived: bool) -> dict:
        """Seed provenance for create/reseed events. Derived soups are
        replayable from the run_id alone (seed_kind "soup"); small
        explicit boards ride inline; big ones only by digest."""
        fields = FleetEngine._journal_board_sha(board01)
        if derived:
            fields["seed_kind"] = "soup"
            return fields
        if board01.size <= (1 << 22):
            seed = journal_mod.encode_board(board01)
            if seed is not None:
                fields["seed_kind"] = "inline"
                fields["seed"] = seed
                return fields
        fields["seed_kind"] = "external"
        return fields

    def _journal_create(self, h: RunHandle, board01: np.ndarray,
                        derived: bool) -> None:
        """Journal a run's birth (called under the fleet lock, right
        after registration — the loop can't have submitted any pool
        digest for it yet, so create is always seq-first)."""
        if not journal_mod.enabled():
            return
        try:
            fields = self._journal_seed(board01, derived)
            fields.update(turn=int(h.turn), h=int(h.h), w=int(h.w),
                          rule=h.rule.rulestring)
            if h.target_turn is not None:
                fields["target_turn"] = int(h.target_turn)
            self._journal_event(h.run_id, "create", **fields)
        except Exception:
            pass

    def restore_run(self, path: str, reshard: bool = False) -> int:
        return ckpt_mod.restore_engine(self, path, reshard=reshard)

    def save_checkpoint(self, path: str) -> None:
        """Legacy .npz autosave of run0 (SIGTERM handler parity)."""
        h = self._legacy_or_raise()
        board, turn = self._run_board(h)
        arrays: dict = {}
        if h.w % WORD_BITS == 0:
            arrays = {"words": np.ascontiguousarray(
                board_to_words(board)), "width": h.w}
        else:
            arrays = {"world": (board * np.uint8(255)).astype(np.uint8)}
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez_compressed(
                    f, turn=turn, rulestring=h.rule.rulestring, **arrays)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def load_checkpoint(self, path: str) -> int:
        """Restore the LEGACY run from a dense-engine-format checkpoint
        payload — the restore_engine/--resume path works unchanged on a
        fleet server."""
        self._check_alive()
        with np.load(path) as z:
            turn = int(z["turn"])
            if "rulestring" in z.files:
                ckpt_rule = str(z["rulestring"])
                if ckpt_rule != self._rule.rulestring:
                    raise ValueError(
                        f"checkpoint rule {ckpt_rule!r} does not match "
                        f"engine rule {self._rule.rulestring!r}")
            if "world" in z.files:
                board01 = (np.asarray(z["world"]) != 0).astype(np.uint8)
            elif "words" in z.files:
                words = np.asarray(z["words"])
                width = int(z["width"])
                board01 = words_to_board(words, words.shape[-2], width)
            else:
                raise ValueError(
                    "unsupported checkpoint payload for the fleet "
                    f"engine: {sorted(z.files)}")
        h, w = board01.shape
        with self._fleet_lock:
            handle = self._runs.get(LEGACY_RUN_ID)
            if handle is not None and (handle.h, handle.w) != (h, w):
                self._remove_locked(handle)
                handle = None
            if handle is None:
                self._legacy_handle(board01 * np.uint8(255), turn)
                handle = self._runs[LEGACY_RUN_ID]
                handle.turn = turn
                handle.alive = int(board01.sum())
                handle.alive_turn = turn
            else:
                handle.pending_seed = (board01, turn)
                self._wake.notify_all()
        self._ensure_loop()
        self._await_seed(handle)
        with self._state_lock:
            self._turn = turn
            self._alive_pub = (int(board01.sum()), turn)
        return turn

    def _await_seed(self, handle: RunHandle) -> None:
        deadline = time.monotonic() + _PLACE_TIMEOUT_S
        with self._wake:
            while (handle.pending_seed is not None
                   or (handle.state == "queued"
                       and handle in self._placeq)):
                if self._killed:
                    raise EngineKilled("engine has been killed")
                if time.monotonic() > deadline:
                    raise RuntimeError("fleet loop did not apply seed")
                self._wake.wait(timeout=0.2)

    # ----------------------------------------------------- shared reads

    def _run_board(self, h: RunHandle) -> Tuple[np.ndarray, int]:
        """({0,1} board, turn) for any run, coherent: the slot's device
        copy is enqueued under the scheduling lock (the stream orders it
        after every write before it), the host copy that waits for it
        happens outside the lock."""
        with self._fleet_lock:
            self._check_alive()
            if h.state == "removed":
                raise RuntimeError(f"run {h.run_id} removed")
            if h.frozen is not None and (h.paused
                                         or h.state != "resident"):
                return h.frozen.copy(), h.turn
            bucket = self._buckets.get(h.bucket_key)
            if bucket is None or h.slot is None:
                if h.frozen is not None:
                    return h.frozen.copy(), h.turn
                raise RuntimeError("no board loaded")
            with self._on_device():
                words = bucket.slot_copy(h.slot)
            turn = h.turn
        return words_to_board(words_to_numpy(words), h.h, h.w), turn

    def _view_of(self, h: RunHandle, max_cells: int):
        board, turn = self._run_board(h)
        px = (board * np.uint8(255)).astype(np.uint8)
        if max_cells <= 0 or h.h * h.w <= max_cells:
            return px, turn, (1, 1)
        f = view_factor(h.h, h.w, max_cells)
        vh, vw = -(-h.h // f), -(-h.w // f)
        padded = np.zeros((vh * f, vw * f), dtype=np.uint8)
        padded[: h.h, : h.w] = px
        view = padded.reshape(vh, f, vw, f).max(axis=(1, 3))
        return np.ascontiguousarray(view), turn, (f, f)

    # ------------------------------------------------- bench telemetry

    def throughput_counters(self) -> dict:
        """Monotonic retirement counters for the fleet bench: deltas
        over a wall interval give honest (fully-synced) aggregate CUPS."""
        with self._fleet_lock:
            return {"board_turns": self._board_turns,
                    "cell_updates": self._cell_updates,
                    "dispatches": self._dispatches,
                    "chunk_overhead_us": self._chunk_overhead_us}

    def latency_percentiles(self) -> Tuple[float, float]:
        """(p50, p99) per-run turn latency seconds: rotation gap between
        a bucket's consecutive dispatches divided by the quantum."""
        with self._fleet_lock:
            samples = sorted(self._latency_samples)
        if not samples:
            return 0.0, 0.0

        def pct(p: float) -> float:
            return samples[min(len(samples) - 1, int(p * len(samples)))]

        return pct(0.50), pct(0.99)

    def reset_bench_window(self) -> None:
        with self._fleet_lock:
            self._latency_samples.clear()

    # -------------------------------------------------------- the loop

    def _ensure_loop(self) -> None:
        with self._fleet_lock:
            t = self._loop_thread
            if t is None or not t.is_alive():
                t = threading.Thread(target=self._loop, daemon=True,
                                     name="gol-fleet-loop")
                self._loop_thread = t
                t.start()

    def _bucket_for(self, h: RunHandle) -> Bucket:
        key = h.bucket_key
        bucket = self._buckets.get(key)
        if bucket is None:
            hb, wb, _rs, dtype = key
            if dtype != "bit":
                # Defense in depth: admission already rejects non-
                # binary families (the dense engine's conv/FFT tier
                # serves them), but a float board reaching placement
                # must never be bit-packed into a Bucket.
                raise FleetUnsupported(
                    f"no fleet bucket class for cell dtype {dtype!r}; "
                    "float-state (Lenia) runs are served by the dense "
                    "engine's conv/FFT kernel tier")
            ndev = len(self._devices)
            placement = choose_placement(hb, wb, self.slot_base, ndev)
            if placement == "batch":
                mesh = self._mesh_batch
            elif placement == "spatial":
                # Big-board fallback: too few slots a device to keep the
                # batch axis occupied, so each board is row-sharded.
                mesh = make_mesh(ndev, devices=self._devices)
            else:
                mesh = None
            bucket = Bucket(hb, wb, h.rule, slot_base=self.slot_base,
                            device=self._device, placement=placement,
                            mesh=mesh)
            self._buckets[key] = bucket
            self._rr.append(key)
        return bucket

    def _loop(self) -> None:
        """The fleet's single scheduling thread: service, pick the next
        non-empty bucket round-robin, dispatch one quantum, sync, update
        handles. Registry metrics move only at the batched-flush cadence
        — the per-quantum hot path touches plain locals."""
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        reporter = obs_timeline.from_env()
        last_end: Dict[tuple, float] = {}
        pend_chunks = 0
        pend_turns = 0
        pend_elapsed: List[float] = []
        # Per-bucket quantum wall latencies since the last flush:
        # plain local lists on the hot path, folded into the bounded
        # log-bucket estimators only at flush time.
        pend_quantum: Dict[str, List[float]] = {}
        # Per-dispatch usage attribution tuples: plain local
        # appends on the hot path, apportioned by the meter at flush.
        pend_usage: List[tuple] = []
        overhead_accum = 0.0
        overhead_iters = 0
        last_cups = 0.0
        last_rate = 0.0
        last_flush = time.monotonic()

        def _flush(now: float) -> None:
            nonlocal pend_chunks, pend_turns, last_flush
            nonlocal overhead_accum, overhead_iters
            if pend_chunks:
                if self.fuse_k > 1:
                    obs.FUSED_DISPATCHES.labels(tier="fleet").inc(
                        pend_chunks)
                obs.ENGINE_CHUNKS_TOTAL.inc(pend_chunks)
                obs.ENGINE_TURNS_TOTAL.inc(pend_turns)
                obs.ENGINE_CHUNK_SECONDS.observe_batch(pend_elapsed)
                pend_elapsed.clear()
                pend_chunks = pend_turns = 0
            if overhead_iters:
                self._chunk_overhead_us = (
                    overhead_accum / overhead_iters * 1e6)
                obs.ENGINE_CHUNK_OVERHEAD_US.set(self._chunk_overhead_us)
                overhead_accum = 0.0
                overhead_iters = 0
            if last_cups > 0:
                obs.ENGINE_CUPS.set(last_cups)
            if last_rate > 0:
                obs.ENGINE_TURNS_PER_S.set(last_rate)
            with self._state_lock:
                obs.ENGINE_TURN.set(self._turn)
            obs.ENGINE_CHUNK_SIZE.set(self.turns_per_dispatch)
            obs.RUNS_RESIDENT.set(self.runs_summary()["resident"])
            obs.FLEET_MESH_DEVICES.set(len(self._devices))
            for dev, n in enumerate(self._device_resident_locked()):
                obs.FLEET_DEVICE_RESIDENT.labels(device=str(dev)).set(n)
            if self._ckpt_pool is not None:
                obs.CKPT_POOL_DEPTH.set(self._ckpt_pool.depth())
            self._flush_slo_locked(now, pend_quantum)
            self._flush_usage_locked(pend_usage)
            last_flush = now

        while not self._killed:
            t0 = time.monotonic()
            with self._wake:
                self._service_locked()
                picked = self._next_bucket_locked()
                if picked is None:
                    if pend_chunks or overhead_iters:
                        _flush(time.monotonic())
                    self._wake.wait(timeout=0.2)
                    continue
                key, bucket = picked
                chunk = self.turns_per_dispatch
                try:
                    alive_dev = bucket.dispatch(self.chunk_turns,
                                                fuse=self.fuse_k)
                except Exception as e:
                    self._dispatch_failed_locked(bucket, e)
                    continue
                stepped: List[Tuple[int, RunHandle]] = []
                for slot, h in enumerate(bucket.slots):
                    if h is not None and h.active:
                        h.turn += chunk
                        stepped.append((slot, h))
            t_disp = time.monotonic()
            try:
                # The device wait point.
                alive_host = alive_dev.cpu().numpy()
            except Exception as e:
                # The dispatch was async; the fault surfaces at the sync.
                with self._wake:
                    self._dispatch_failed_locked(bucket, e, stepped)
                continue
            t_done = time.monotonic()
            with self._wake:
                rotation = t_done - last_end.get(key, t0)
                last_end[key] = t_done
                useful_cells = 0
                run_ids: List[str] = []
                active_usage: List[Tuple[str, int]] = []
                top_turn = 0
                slot_bits = bucket.hb * bucket.wb
                poison_on = bool(os.environ.get("GOL_CHAOS"))
                for slot, h in stepped:
                    if h.state != "resident":
                        continue  # parked/removed while we waited
                    if h.pending_seed is not None:
                        # Reseeded while we waited (a legacy drive): these
                        # turns were stepped from the old board, and the
                        # seed resets the turn at the next service pass.
                        # Crediting them could reach the new target and
                        # release the drive before its seed is stepped.
                        continue
                    tiles = tiles_for(h.h, h.w, bucket.hb, bucket.wb)
                    raw_alive = int(alive_host[slot])
                    if poison_on:
                        from gol_tpu_torch import chaos

                        if chaos.take_poison(h.run_id, h.turn):
                            raw_alive = -1  # fabricated device fault
                    if not 0 <= raw_alive <= slot_bits:
                        # A popcount outside [0, slot bits] cannot come
                        # from a healthy dispatch: the slot's words are
                        # untrusted. Evict without readback.
                        self._quarantine_locked(bucket, h, "popcount")
                        continue
                    h.alive = crop_alive(raw_alive, tiles)
                    h.alive_turn = h.turn
                    h.advanced_s = t_done
                    useful_cells += h.h * h.w
                    active_usage.append((h.run_id, h.h * h.w))
                    top_turn = max(top_turn, h.turn)
                    if len(run_ids) < 8:
                        run_ids.append(h.run_id)
                    if h.run_id == LEGACY_RUN_ID:
                        with self._state_lock:
                            self._turn = h.turn
                            self._alive_pub = (h.alive, h.turn)
                    if h.ckpt_every and h.turn >= h.next_ckpt_turn:
                        try:
                            self._ckpt_cadence_locked(h)
                        except Exception:
                            pass  # checkpoint trouble never stops serving
                        while h.next_ckpt_turn <= h.turn:
                            h.next_ckpt_turn += h.ckpt_every
                    if (h.target_turn is not None
                            and h.turn >= h.target_turn
                            and not h.done.is_set()):
                        self._park_locked(bucket, h)
                elapsed = t_done - t0
                wait_s = t_done - t_disp
                pend_quantum.setdefault(
                    f"{bucket.hb}x{bucket.wb}", []).append(elapsed)
                self._latency_samples.append(rotation / chunk)
                self._board_turns += chunk * len(stepped)
                self._cell_updates += chunk * useful_cells
                self._dispatches += 1
                pend_chunks += 1
                pend_turns += chunk * len(stepped)
                pend_elapsed.append(elapsed)
                pend_usage.append(
                    (bucket.placement, elapsed, chunk, active_usage))
                overhead_accum += max(0.0, elapsed - wait_s)
                overhead_iters += 1
                if elapsed > 0:
                    last_cups = chunk * useful_cells / elapsed
                    last_rate = chunk / elapsed
                    self._turns_per_s = last_rate
                if reporter is not None and stepped:
                    reporter.emit(
                        "chunk", run_id=f"fleet-{bucket.hb}x{bucket.wb}",
                        turn=top_turn, turns=chunk * len(stepped),
                        chunk_size=chunk, wall_s=round(elapsed, 6),
                        cups=last_cups, turns_per_s=last_rate,
                        token_wait_s=round(wait_s, 6),
                        runs=len(stepped), run_ids=run_ids,
                        alive=int(alive_host.sum()))
                self._wake.notify_all()
            cb = self._bcast_notify
            if cb is not None:
                cb()
            now = time.monotonic()
            if now - last_flush >= METRICS_FLUSH_SECONDS:
                with self._wake:
                    _flush(now)
        # Engine killed: flush the tail and release every waiter.
        with self._wake:
            _flush(time.monotonic())
            for h in self._runs.values():
                h.done.set()
            self._wake.notify_all()

    def _flush_slo_locked(self, now: float,
                          pend_quantum: Dict[str, List[float]]) -> None:
        """Publish the fleet SLO aggregates (fleet lock held, batched
        flush cadence only): per-bucket serving-quantum latency
        percentiles, admission queue depth/wait, per-run turn staleness
        — as bounded-cardinality gauges plus the cached /healthz doc
        (top-K worst runs by staleness, never a per-run label)."""
        qs = (0.50, 0.95, 0.99)
        for blabel, samples in pend_quantum.items():
            est = self._quantum_est.get(blabel)
            if est is None:
                est = self._quantum_est[blabel] = \
                    obs_slo.LogBucketEstimator()
            est.observe_batch(samples)
            for q, v in zip(obs.SLO_QUANTILES, est.percentiles(qs)):
                if v is not None:
                    obs.FLEET_QUANTUM_MS.labels(
                        bucket=blabel, q=q).set(round(v * 1e3, 3))
        pend_quantum.clear()
        waits = self.admission.drain_queue_waits()
        if waits:
            self._queue_wait_est.observe_batch(waits)
            for q, v in zip(obs.SLO_QUANTILES,
                            self._queue_wait_est.percentiles(qs)):
                if v is not None:
                    obs.FLEET_QUEUE_WAIT_MS.labels(q=q).set(
                        round(v * 1e3, 3))
        obs.FLEET_QUEUE_DEPTH.set(len(self._waitq))
        rows: List[Tuple[float, RunHandle]] = []
        for h in self._runs.values():
            if h.state != "resident" or h.paused:
                continue
            rows.append(((now - h.advanced_s) * 1e3, h))
        doc: dict = {"resident_active": len(rows),
                     "queue_depth": len(self._waitq),
                     "flushed_s": round(now, 3)}
        if rows:
            pcts = obs_slo.exact_percentiles([ms for ms, _ in rows], qs)
            for q, v in zip(obs.SLO_QUANTILES, pcts):
                obs.FLEET_STALENESS_MS.labels(q=q).set(round(v, 3))
            doc["staleness_ms"] = {
                q: round(v, 3)
                for q, v in zip(obs.SLO_QUANTILES, pcts)}
            rows.sort(key=lambda r: r[0], reverse=True)
            doc["worst_runs"] = [
                {"run_id": h.run_id, "staleness_ms": round(ms, 1),
                 "turn": h.turn, "state": h.state}
                for ms, h in rows[:5]]
        obs_slo.set_fleet_health(doc)

    def _flush_usage_locked(self, pend_usage: List[tuple]) -> None:
        """Hand the flush window's dispatch tuples to the usage meter
        and refresh the capacity headroom model (fleet lock
        held, batched flush cadence only). Headroom per bucket class:
        min(free admission budget // per-run memory charge, free
        slots) runs, converted to CUPS via the class's measured mean
        quantum wall — unmeasured classes project 0 CUPS headroom
        rather than inventing a rate."""
        try:
            obs_usage.METER.ingest_dispatches(pend_usage)
            pend_usage.clear()
            adm = self.admission.summary()
            free = max(0, adm["budget_bytes"] - adm["committed_bytes"])
            slots_free = max(0, adm["max_runs"] - adm["resident"])
            rows: List[dict] = []
            for size in self.bucket_sizes:
                wpb = (size + WORD_BITS - 1) // WORD_BITS
                cost = run_cost(size, wpb)
                projected = min(free // cost, slots_free) if cost else 0
                est = self._quantum_est.get(f"{size}x{size}")
                snap = est.snapshot() if est is not None else None
                mean_s = (snap["sum"] / snap["count"]
                          if snap and snap["count"] else 0.0)
                cups_hr = (projected * size * size
                           * self.turns_per_dispatch / mean_s
                           if mean_s > 0 else 0.0)
                rows.append({
                    "bucket": f"{size}x{size}",
                    "run_cost_bytes": cost,
                    "admissible": int(projected),
                    "quantum_mean_ms": round(mean_s * 1e3, 3),
                    "cups_headroom": round(cups_hr, 1),
                    "free_bytes": free,
                    "slots_free": slots_free,
                })
            obs_usage.METER.publish(capacity=rows)
        except Exception:
            pass  # accounting trouble never stops serving

    def _retire_usage_locked(self, h: RunHandle) -> None:
        """Flush a run's final lifetime accounting into its journal
        before the terminal bookend, so GetJournal can audit a
        destroyed or migrated-away run's resource totals. Idempotent:
        the meter retires a run exactly once."""
        try:
            rec = obs_usage.METER.retire(h.run_id)
        except Exception:
            rec = None
        if rec:
            self._journal_event(h.run_id, "usage", turn=int(h.turn),
                                **rec)

    def _device_resident_locked(self) -> List[int]:
        """Resident-run count per placement-device index. A batch bucket
        holds slot s on the device of its block (`Bucket.slot_device`); a
        spatial bucket holds every board on every device; a single one
        on device 0."""
        counts = [0] * len(self._devices)
        for b in self._buckets.values():
            for slot, h in enumerate(b.slots):
                if h is None or h.state != "resident":
                    continue
                if b.placement == "spatial":
                    counts = [c + 1 for c in counts]
                else:
                    counts[b.slot_device(slot)] += 1
        return counts

    def _next_bucket_locked(self):
        """Fair rotation: each non-empty bucket gets one quantum per
        cycle regardless of how many buckets exist or how full they
        are — no bucket can starve another."""
        for _ in range(len(self._rr)):
            key = self._rr[0]
            self._rr.rotate(-1)
            bucket = self._buckets.get(key)
            if bucket is not None and bucket.active_count() > 0:
                return key, bucket
        return None

    # ------------------------------------------------- loop service ops

    def _service_locked(self) -> None:
        # Token-scoped legacy abort (ControlFlagProtocol.abort_run).
        if self._abort.is_set():
            h = self._runs.get(LEGACY_RUN_ID)
            if h is not None and h.state == "resident":
                self._park_locked(self._buckets[h.bucket_key], h)
            elif h is not None:
                h.done.set()
            self._abort.clear()
        # Promote capacity-waiters in FIFO order while budget allows.
        while self._waitq:
            h = self._waitq[0]
            ok, _reason = self.admission.try_admit(h.admitted_cost)
            if not ok:
                break
            self._waitq.popleft()
            # Measured promotion wait feeds the queue-wait SLO.
            self.admission.dequeue(
                time.monotonic() - h.enqueued_s
                if h.enqueued_s is not None else None)
            self._placeq.append(h)
        # Placements.
        while self._placeq:
            h = self._placeq.pop(0)
            if h.state != "queued":
                continue
            bucket = self._bucket_for(h)
            board = h.frozen if h.frozen is not None \
                else _soup(h.run_id, h.h, h.w)
            h.slot = bucket.place(h, board)
            # A PAUSED handle's frozen board stays authoritative (the
            # slot steps garbage until resume restamps it) — clearing
            # it here would corrupt a paused run placed after a rule
            # migration or checkpoint restore.
            if not h.paused:
                h.frozen = None
            h.state = "resident"
            h.advanced_s = time.monotonic()
        # Per-run: quarantine restores, seeds, flags, resumes, trims.
        for h in list(self._runs.values()):
            if h.state == "removed":
                continue
            if ((h.migrating or "").startswith("staged")
                    and time.time() - h.created_s
                    > env_float(IMPORT_STALE_ENV,
                                IMPORT_STALE_DEFAULT_S)):
                # Orphaned import: its migration coordinator never came
                # back to commit or roll back. The source (or adopter)
                # copy is authoritative; this hidden copy only holds
                # budget — expire it.
                obs_log("fleet.import_expired", level="warning",
                        run_id=h.run_id, turn=h.turn)
                self._remove_locked(h)
                continue
            if h.state == "quarantined":
                self._service_quarantined_locked(h)
            if h.pending_seed is not None:
                try:
                    self._apply_seed_locked(h)
                except Exception as e:
                    # A seed/restore that cannot be installed leaves the
                    # run with no trustworthy board: quarantine it (the
                    # auto-restore path retries from its checkpoint).
                    h.pending_seed = None
                    obs_exception("fleet.seed_failed", e, run_id=h.run_id)
                    self._quarantine_locked(
                        self._buckets.get(h.bucket_key), h, "restore")
            if not h.flags.empty():
                self._service_flags_locked(h)
            if h.abort.is_set():
                h.abort.clear()
                if h.state == "resident":
                    self._park_locked(self._buckets[h.bucket_key], h)
                else:
                    h.done.set()
            if self._driving(h):
                if h.state == "parked":
                    self._resume_locked(h)
                if h.state == "resident" and not h.paused:
                    rem = h.target_turn - h.turn
                    if rem <= 0:
                        self._park_locked(self._buckets[h.bucket_key], h)
                    elif rem < self.turns_per_dispatch:
                        self._trim_locked(h, rem)
        self._wake.notify_all()

    def _apply_seed_locked(self, h: RunHandle) -> None:
        board01, turn = h.pending_seed
        h.pending_seed = None
        h.turn = int(turn)
        h.alive = int(board01.sum())
        h.alive_turn = h.turn
        if h.state == "resident" and not h.paused:
            self._buckets[h.bucket_key].stamp(h.slot, board01)
        else:
            h.frozen = board01
            if h.state == "quarantined":
                # An explicit reseed is operator recovery: requeue the
                # run for placement with fresh quarantine bookkeeping.
                h.state = "queued"
                h.quarantine_next_s = 0.0
                self._placeq.append(h)
        if h.run_id == LEGACY_RUN_ID:
            with self._state_lock:
                self._turn = h.turn
                self._alive_pub = (h.alive, h.turn)
        if journal_mod.enabled():
            try:
                fields = self._journal_seed(board01, False)
                fields["turn"] = h.turn
                self._journal_event(h.run_id, "reseed", **fields)
            except Exception:
                pass

    def _service_flags_locked(self, h: RunHandle) -> None:
        # Flags arriving mid-migration are DEFERRED, not dropped: the
        # coordinator drains them at commit and relays them to the new
        # owner (or rollback leaves them queued for local service).
        if h.migrating is not None:
            return
        while True:
            try:
                flag = h.flags.get_nowait()
            except queue_mod.Empty:
                return
            if flag == FLAG_PAUSE:
                self._toggle_pause_locked(h)
            elif flag == FLAG_QUIT:
                if h.state == "resident":
                    self._park_locked(self._buckets[h.bucket_key], h)
                else:
                    self._remove_locked(h)
            elif flag == FLAG_KILL:
                self._remove_locked(h)

    def _toggle_pause_locked(self, h: RunHandle) -> None:
        if h.state == "resident":
            if not h.paused:
                bucket = self._buckets[h.bucket_key]
                h.frozen = bucket.read_board(h.slot, h.h, h.w)
                h.paused = True
            else:
                bucket = self._buckets[h.bucket_key]
                bucket.stamp(h.slot, h.frozen)
                h.frozen = None
                h.paused = False
        else:
            h.paused = not h.paused
        self._journal_event(h.run_id,
                            "pause" if h.paused else "resume",
                            turn=int(h.turn))

    def _park_locked(self, bucket: Bucket, h: RunHandle) -> None:
        """Freeze a resident run: its board copies to the handle, the
        slot keeps its place (stepping garbage) for a cheap resume."""
        if h.frozen is None:
            h.frozen = bucket.read_board(h.slot, h.h, h.w)
        h.alive = int(h.frozen.sum())
        h.alive_turn = h.turn
        h.state = "parked"
        if h.run_id == LEGACY_RUN_ID:
            with self._state_lock:
                self._turn = h.turn
                self._alive_pub = (h.alive, h.turn)
        h.done.set()

    def _resume_locked(self, h: RunHandle) -> None:
        if h.slot is None:
            # Slotless park (rule migration freed the old-bucket slot):
            # resume goes back through placement — frozen reseeds the
            # new bucket on the next service pass.
            h.state = "queued"
            if h not in self._placeq:
                self._placeq.append(h)
            return
        bucket = self._buckets[h.bucket_key]
        if not h.paused and h.frozen is not None:
            bucket.stamp(h.slot, h.frozen)
            h.frozen = None
        h.state = "resident"

    # ------------------------------------------------------- quarantine

    def _quarantine_locked(self, bucket: Optional[Bucket], h: RunHandle,
                           reason: str) -> None:
        """Evict a faulted run from the shared batch: its slot frees
        WITHOUT readback (the contents are untrusted by definition) and
        its host copy is discarded. The admission charge stays held —
        auto-restore re-places the run without re-admission, so a
        transient fault cannot lose the run its capacity to a waiter."""
        reason = obs.quarantine_label(reason)
        if h.slot is not None and bucket is not None:
            bucket.release(h.slot)
        h.slot = None
        h.frozen = None
        h.paused = False
        h.state = "quarantined"
        h.quarantine_reason = reason
        h.quarantine_tries = 0
        h.quarantine_next_s = 0.0  # first restore attempt: immediately
        obs.RUNS_QUARANTINED.labels(reason=reason).inc()
        obs_log("fleet.quarantine", level="error", run_id=h.run_id,
                reason=reason, turn=h.turn)
        # Fleet audit: a gol-fleet-audit/1 record in the member-side
        # queue and ring (GetAudit reads the ring).
        obs_audit.note("quarantine", run_id=h.run_id, reason=reason,
                       turn=h.turn)
        # NOTE: h.done is NOT set — a driven run stays driven; the
        # restore path re-queues it and the drive completes normally.
        # Only exhausted restores (below) release waiting drives.

    def _dispatch_failed_locked(self, bucket: Bucket, exc: Exception,
                                stepped: Optional[List[Tuple[int,
                                                   RunHandle]]] = None,
                                ) -> None:
        """A batched dispatch (or its device sync) raised: no slot of
        this bucket produced a trustworthy result. Quarantine every run
        that was being stepped and rebuild the device array from the
        host copies of the survivors (paused/parked residents)."""
        obs_exception("fleet.dispatch_failed", exc,
                      bucket=f"{bucket.hb}x{bucket.wb}")
        if stepped is None:  # dispatch itself raised: turns never moved
            victims = [(s, h) for s, h in enumerate(bucket.slots)
                       if h is not None and h.active]
        else:  # sync raised: roll the optimistic turn advance back
            victims = stepped
            for _slot, h in victims:
                if h.state == "resident":
                    h.turn -= self.turns_per_dispatch
        for _slot, h in victims:
            if h.state == "resident":
                self._quarantine_locked(bucket, h, "step")
        try:
            bucket.rebuild()
        except Exception as e:  # device truly wedged; keep serving rest
            obs_exception("fleet.bucket_rebuild_failed", e,
                          bucket=f"{bucket.hb}x{bucket.wb}")

    def _service_quarantined_locked(self, h: RunHandle) -> None:
        """Capped, backed-off auto-restore: re-seed a quarantined run
        from its newest durable per-run checkpoint and requeue it for
        placement. Past the try cap the run is left quarantined and any
        waiting drive is released (it will surface the failure)."""
        now = time.monotonic()
        if now < h.quarantine_next_s:
            return
        max_tries = env_int(QUARANTINE_TRIES_ENV,
                            QUARANTINE_TRIES_DEFAULT, minimum=0)
        if h.quarantine_tries >= max_tries:
            return
        h.quarantine_tries += 1
        try:
            board01, turn = self._load_run_ckpt(h)
        except Exception as e:
            obs.RUNS_QUARANTINE_RESTORES.labels(status="error").inc()
            backoff = env_float(QUARANTINE_BACKOFF_ENV,
                                QUARANTINE_BACKOFF_DEFAULT_S)
            h.quarantine_next_s = now + backoff * (
                2 ** (h.quarantine_tries - 1))
            obs_log("fleet.quarantine_restore_failed", level="error",
                    run_id=h.run_id, attempt=h.quarantine_tries,
                    error=f"{type(e).__name__}: {e}")
            if h.quarantine_tries >= max_tries:
                obs_log("fleet.quarantine_terminal", level="error",
                        run_id=h.run_id, tries=h.quarantine_tries)
                if h.adopted:
                    h.adopted = False
                    obs.FED_ADOPTED_RUNS.labels(status="error").inc()
                h.done.set()  # drives must not wait on a dead run
            return
        h.frozen = board01
        h.turn = int(turn)
        h.alive = int(board01.sum())
        h.alive_turn = h.turn
        if h.ckpt_every:
            h.next_ckpt_turn = h.turn + h.ckpt_every
        h.state = "queued"
        self._placeq.append(h)
        obs.RUNS_QUARANTINE_RESTORES.labels(status="ok").inc()
        if h.adopted:
            h.adopted = False
            obs.FED_ADOPTED_RUNS.labels(status="ok").inc()
        obs_log("fleet.quarantine_restored", run_id=h.run_id,
                turn=h.turn, attempt=h.quarantine_tries,
                reason=h.quarantine_reason)
        if journal_mod.enabled():
            try:
                fields = self._journal_board_sha(board01)
                fields.update(turn=h.turn, reason=h.quarantine_reason,
                              attempt=h.quarantine_tries)
                self._journal_event(h.run_id, "restore", **fields)
            except Exception:
                pass

    def _load_run_ckpt(self, h: RunHandle) -> Tuple[np.ndarray, int]:
        """(board01, turn) from the run's newest durable checkpoint,
        verified end-to-end before any byte is trusted."""
        from gol_tpu_torch.ckpt import manifest as mf

        base = os.environ.get(CKPT_ENV, "")
        if not base:
            raise RuntimeError(
                "checkpointing not configured (set GOL_CKPT)")
        directory = self._ckpt_dir(h.run_id, base)
        latest = mf.latest_checkpoint(directory)
        if latest is None:
            raise FileNotFoundError(
                f"no durable checkpoint for run {h.run_id} "
                f"in {directory}")
        target = latest[1]
        m = mf.verify_manifest(target)
        payload = mf.payload_path(target, m)
        # Canonical decode (ckpt/reshard.py) instead of a members
        # switch: any representation family an engine can write —
        # packed words, raw pixels, sparse windows — restores here.
        from gol_tpu_torch.ckpt import reshard as reshard_mod

        can = reshard_mod.load_canonical(payload)
        board01 = reshard_mod.board01_of(can)
        turn = int(can.turn)
        if board01.shape != (h.h, h.w):
            raise ValueError(
                f"checkpoint board {board01.shape} does not match "
                f"run {(h.h, h.w)}")
        return np.ascontiguousarray(board01), turn

    def _remove_locked(self, h: RunHandle,
                       journal_end: bool = True) -> None:
        """Terminal: free the slot, return the admission charge, drop
        the handle from the registry. The final board stays on
        `h.frozen` so an in-flight _drive can still return it.
        `journal_end=False` suppresses the journal's "end" bookend —
        migrate_commit writes "migrate_out" instead (the run lives on
        elsewhere)."""
        if h in self._placeq:
            self._placeq.remove(h)
        if h in self._waitq:
            self._waitq.remove(h)
            self.admission.dequeue()
        elif h.slot is not None:
            bucket = self._buckets.get(h.bucket_key)
            if bucket is not None:
                h.frozen = bucket.evict(h.slot, h.h, h.w)
            h.slot = None
            if h.admitted_cost:
                self.admission.release(h.admitted_cost)
        elif (h.state in ("queued", "parked", "quarantined")
              and h.admitted_cost):
            self.admission.release(h.admitted_cost)
        h.state = "removed"
        if self._ckpt_pool is not None:
            # Pending snapshots drain (same flush-then-close semantics
            # the per-run writer had); only the directory core is
            # dropped so the pool's map cannot grow unboundedly.
            self._ckpt_pool.forget(h.run_id)
        self._retire_usage_locked(h)
        if journal_end:
            self._journal_event(h.run_id, "end", turn=int(h.turn))
        journal_mod.forget(h.run_id)
        self._runs.pop(h.run_id, None)
        h.done.set()

    def _trim_locked(self, h: RunHandle, rem: int) -> None:
        """Exact-target remainder: the slot's FULL bucket torus advances
        `rem` turns outside the batch (`Bucket.run_slot`: K1 for a slot K1
        holds, K2 beyond, the sharded path on a spatial bucket — the same
        torus as the batch, bit-identical), then the run parks at its
        target."""
        bucket = self._buckets[h.bucket_key]
        obs_devstats.note_signature(
            ("fleet-trim", bucket.hb, bucket.wpb, rem,
             h.rule.rulestring))
        out = bucket.run_slot(h.slot, rem)
        h.turn += rem
        h.frozen = words_to_board(words_to_numpy(out), h.h, h.w)
        self._board_turns += rem
        self._cell_updates += rem * h.h * h.w
        # Host-side remainder turns: no dispatch wall to apportion,
        # but the advancement itself is attributable work.
        obs_usage.METER.charge_turns(h.run_id, rem, rem * h.h * h.w)
        self._park_locked(bucket, h)


def _drain_queue(q: "queue_mod.Queue[int]", pause_only: bool) -> None:
    kept = []
    try:
        while True:
            flag = q.get_nowait()
            if pause_only and flag != FLAG_PAUSE:
                kept.append(flag)
    except queue_mod.Empty:
        pass
    for flag in kept:
        q.put(flag)


class RunView:
    """The per-run engine surface of one fleet run: what the server
    dispatches run-scoped wire methods against. Implements the same
    duck-typed contract the single-run engines expose, so every
    existing handler (Stats/Alivecount/GetWorld/GetView/CFput/
    DrainFlags/Checkpoint/ServerDistributor) works per run unchanged."""

    frames_diffable = True
    binary_pixels = True

    def __init__(self, engine: FleetEngine, handle: RunHandle) -> None:
        self._engine = engine
        self._handle = handle
        self.run_id = handle.run_id

    def describe_run(self) -> dict:
        with self._engine._fleet_lock:
            return self._handle.describe()

    def ping(self) -> int:
        self._engine._check_alive()
        return self._handle.turn

    def alive_count(self) -> Tuple[int, int]:
        self._engine._check_alive()
        with self._engine._fleet_lock:
            return self._handle.alive, self._handle.alive_turn

    def get_world(self) -> Tuple[np.ndarray, int]:
        self._engine._check_alive()
        board, turn = self._engine._run_board(self._handle)
        return (board * np.uint8(255)).astype(np.uint8), turn

    def get_world_frame(self, caps) -> Tuple[object, int]:
        from gol_tpu_torch import wire

        px, turn = self.get_world()
        return wire.encode_board(px, frozenset(caps), binary=True), turn

    def get_view(self, max_cells: int):
        self._engine._check_alive()
        return self._engine._view_of(self._handle, max_cells)

    def stats(self) -> dict:
        self._engine._check_alive()
        e, h = self._engine, self._handle
        with e._fleet_lock:
            return {
                "turn": h.turn,
                "running": FleetEngine._driving(h),
                "board": [h.h, h.w],
                "alive": h.alive,
                "alive_turn": h.alive_turn,
                "packed": True,
                "chunk": e.chunk_turns,
                "turns_per_s": round(e._turns_per_s, 1),
                "chunk_overhead_us": round(e._chunk_overhead_us, 2),
                "rule": h.rule.rulestring,
                "devices": len(e._devices),
                "run_id": h.run_id,
                "state": h.state,
            }

    def cf_put(self, flag: int) -> None:
        self._engine._check_alive()
        if flag not in (FLAG_PAUSE, FLAG_QUIT, FLAG_KILL):
            raise ValueError(f"unknown control flag {flag}")
        with self._engine._wake:
            self._handle.flags.put(flag)
            self._engine._wake.notify_all()

    def drain_flags(self, pause_only: bool = False) -> None:
        self._engine._check_alive()
        with self._engine._fleet_lock:
            if FleetEngine._driving(self._handle):
                return
            _drain_queue(self._handle.flags, pause_only)

    def checkpoint_now(self, directory: Optional[str] = None,
                       trigger: str = "manual") -> Tuple[str, int]:
        return self._engine._ckpt_sync(self._handle, directory, trigger)

    def server_distributor(self, params, world, sub_workers=(),
                           start_turn: int = 0,
                           token: Optional[str] = None):
        return self._engine._drive_run(self._handle, params, world,
                                       start_turn)

    def subscribe_view(self, vkey: str) -> None:
        """Record a live-view subscription (observational today; the
        set sizes ListRuns' viewer column and is the fan-out list a
        future push-snapshot path would use)."""
        with self._engine._fleet_lock:
            self._handle.viewers.add(vkey)
