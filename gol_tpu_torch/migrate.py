"""Live run migration: the Rescale coordinator — the counterpart of
`gol_tpu/migrate.py`, speaking the same RPCs, so a port member migrates a
run to a `gol_tpu` member and back.

Moves ONE fleet run from this member to another federation member with
no caller-visible errors, via a failure-atomic two-phase cutover run
inside the SOURCE member's server process:

    quiesce    - park the run (a device readback of its slot to the
                 handle), mark it migrating: control flags defer,
                 destroy is refused, reads keep serving the frozen board
    checkpoint - synchronous durable per-run checkpoint (belt under the
                 transfer: if BOTH processes die, the federation's
                 adoption path resumes from this exact turn)
    transfer   - stream the board to the target over the ordinary wire
                 codec (CAP_PACKED frame) as ReceiveRun; the target
                 STAGES it — registered, hidden from ListRuns, never
                 auto-resumed
    resume     - CommitRun flips the staged copy live on the target
                 (queued for placement, or parked if the source run was
                 parked)
    redirect   - PinRun atomically re-points the router placement at
                 the target; the source retires its copy, relays any
                 deferred control flags to the new owner, and re-keys
                 viewers (broadcast end sentinel -> subscribers
                 reconnect through the router's new pin)

Rollback: any failure BEFORE the redirect pin lands unwinds in reverse —
destroy the staged/committed target copy (best effort, retried), restore
the source run to the exact state quiesce recorded — and the migration
reports status="rolled_back". Authority lives in the router placement map
and flips exactly once, at PinRun: before it, the source copy is the one
listed, routable copy (the target's is staged-hidden); after it, the
target's is, and the source answers stragglers with a retryable "moved:"
error. At no instant are there zero or two routable copies.

GOL_CHAOS `migrate_fail=<phase>` injects a one-shot failure at any phase
boundary; `kill_member=<addr>@migrating` lets a harness SIGKILL the
source mid-migration (`chaos.take_kill_member` polls True while a Rescale
is in flight, `in_flight()`).

Besides `gol_tpu`'s summary keys the record carries `phase_ms` (each
phase's wall time) and `transfer_bytes` (the ReceiveRun frame's payload).

Env:

    GOL_MIGRATE_DEADLINE   total wall budget in seconds (default 30);
                           each member/router RPC gets the remainder
"""

from __future__ import annotations

import contextlib
import socket
import threading
import time
import uuid
from collections import deque
from typing import Optional

import numpy as np

from gol_tpu_torch import chaos, wire
from gol_tpu_torch.obs import audit as obs_audit
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import trace
from gol_tpu_torch.obs.log import exception as obs_exception
from gol_tpu_torch.obs.log import log as obs_log
from gol_tpu_torch.utils.envcfg import env_float

DEADLINE_ENV = "GOL_MIGRATE_DEADLINE"
DEADLINE_DEFAULT_S = 30.0

# The cutover's phase names, in order — chaos specs and trace spans use
# them verbatim (GOL_CHAOS=migrate_fail=transfer).
PHASES = ("quiesce", "checkpoint", "transfer", "resume", "redirect")

# Client-visible cutover wall samples (resume+redirect slice) feeding
# the gol_migration_downtime_ms{q} gauges: bounded, process-wide.
_DOWNTIME_S: "deque[float]" = deque(maxlen=256)
_DOWNTIME_LOCK = threading.Lock()

# How many Rescale cutovers this process coordinates now: a harness's
# kill_member@migrating poll keys off it.
_IN_FLIGHT = 0
_IN_FLIGHT_LOCK = threading.Lock()


class MigrationFailed(RuntimeError):
    """A phase failed; the cutover was rolled back to the source."""


def in_flight() -> int:
    """How many Rescale cutovers this process is coordinating now."""
    with _IN_FLIGHT_LOCK:
        return _IN_FLIGHT


def _publish_downtime(seconds: float) -> None:
    with _DOWNTIME_LOCK:
        _DOWNTIME_S.append(seconds)
        samples = sorted(_DOWNTIME_S)
    n = len(samples)
    for q, frac in zip(obs.SLO_QUANTILES, (0.50, 0.95, 0.99)):
        v = samples[min(n - 1, int(frac * n))]
        obs.MIGRATION_DOWNTIME_MS.labels(q=q).set(round(v * 1e3, 3))


def _rpc(addr: str, header: dict, frame=None,
         timeout: Optional[float] = None) -> dict:
    """One direct wire round trip to `addr` ("host:port"). Raises on
    transport failure or an error reply — phase code treats any raise as
    that phase failing."""
    host, _, port = addr.rpartition(":")
    sock = socket.create_connection((host or "127.0.0.1", int(port)),
                                    timeout=min(timeout or 5.0, 5.0))
    try:
        wire.enable_nodelay(sock)
        sock.settimeout(timeout)
        wire.send_msg(sock, header, frame=frame)
        resp, _ = wire.recv_msg(sock)
    finally:
        try:
            sock.close()
        except OSError:
            pass
    if resp.get("error") or not resp.get("ok", True):
        raise RuntimeError(
            f"{header.get('method')} to {addr}: "
            f"{resp.get('error', 'refused')}")
    return resp


def _chaos_gate(phase: str) -> None:
    if chaos.take_migrate_fail(phase):
        raise RuntimeError(f"chaos: migrate_fail at phase {phase!r}")


def _audit_phase(rid: str, target: str, phase: str) -> None:
    """One fleet-audit event per migration phase, queued for the next
    heartbeat snapshot, so phase history lands in the router's durable
    gol-fleet-audit/1 log."""
    obs_audit.note("migrate", run_id=rid, target=target, phase=phase)


@contextlib.contextmanager
def _phase(name: str, rid: str, target: str, times: dict):
    """One phase of the cutover: its trace span, chaos gate and audit
    event; its wall time goes into `times`."""
    t0 = time.monotonic()
    try:
        with trace.span(f"migrate.{name}"):
            _chaos_gate(name)
            _audit_phase(rid, target, name)
            yield
    finally:
        times[name] = round((time.monotonic() - t0) * 1e3, 3)


def rescale(server, run_id: str, target: str) -> dict:
    """Coordinate one live migration of `run_id` from `server`'s engine to
    the member advertised at `target` ("host:port" — also its federation
    member_id). Returns a summary record; raises MigrationFailed after a
    rollback, or the underlying error if even the rollback could not
    restore the source."""
    engine = server.engine
    if getattr(engine, "migrate_quiesce", None) is None:
        from gol_tpu_torch.fleet.handles import FleetUnsupported

        raise FleetUnsupported(
            f"{type(engine).__name__} serves a single run; start the "
            "server with --fleet for Rescale")
    rid = str(run_id or "")
    target = str(target or "")
    if not target or ":" not in target:
        raise ValueError(f"Rescale needs a target member host:port, "
                         f"got {target!r}")
    # Unknown run BEFORE the self-target check: "run X is already on me"
    # about a run this member never heard of would mask the real problem
    # (and the server's unknown-run branch turns this KeyError into the
    # retryable moved:/unknown answer).
    engine.resolve_run(rid)
    self_addr = getattr(server, "_self_addr", "") or ""
    if target == self_addr:
        raise ValueError(f"run {rid} is already on {target}")
    deadline = time.monotonic() + env_float(DEADLINE_ENV,
                                            DEADLINE_DEFAULT_S)

    def remaining() -> float:
        left = deadline - time.monotonic()
        if left <= 0:
            raise RuntimeError(
                f"migrate deadline ({DEADLINE_ENV}) exceeded")
        return left

    global _IN_FLIGHT
    with _IN_FLIGHT_LOCK:
        _IN_FLIGHT += 1
    # Every RPC this ATTEMPT sends carries a nonce in its req_id. The ids
    # must be unique per attempt, not per run: a run that migrates to a
    # member it has visited before (ping-pong, retry after a coordinator
    # death) would otherwise have its ReceiveRun/CommitRun answered from
    # that member's dedupe window — "ok" replayed, no copy actually
    # staged — and the source would then retire the only real copy.
    nonce = uuid.uuid4().hex[:12]
    staged_on_target = False
    quiesced = None
    times: dict = {}
    try:
        with trace.span("migrate", attrs={"run_id": rid,
                                          "target": target}) as root:
            with _phase("quiesce", rid, target, times):
                quiesced = engine.migrate_quiesce(rid)
            with _phase("checkpoint", rid, target, times):
                engine.migrate_checkpoint(rid)
            with _phase("transfer", rid, target, times):
                px = (quiesced["board"] * np.uint8(255)).astype(np.uint8)
                frame = wire.encode_board(
                    px, frozenset({wire.CAP_PACKED}), binary=True)
                header = {
                    "method": "ReceiveRun", "run_id": rid,
                    "turn": quiesced["turn"],
                    "rule": quiesced["rule"],
                    "ckpt_every": quiesced["ckpt_every"],
                    "state": quiesced["state"],
                    "req_id": f"mig-{rid}-{nonce}-recv",
                    "caps": sorted(wire.local_caps()),
                }
                if quiesced["target_turn"] is not None:
                    header["target_turn"] = quiesced["target_turn"]
                if quiesced.get("journal_head"):
                    header["journal_head"] = quiesced["journal_head"]
                _rpc(target, header, frame=frame, timeout=remaining())
                staged_on_target = True
            t_cut = time.monotonic()
            with _phase("resume", rid, target, times):
                _rpc(target, {"method": "CommitRun", "run_id": rid,
                              "req_id": f"mig-{rid}-{nonce}-commit"},
                     timeout=remaining())
            with _phase("redirect", rid, target, times):
                # Stragglers relayed to us before the pin flips get a
                # RETRYABLE "moved:" answer once our copy retires —
                # registered before anything can observe the removal.
                server.note_moved(rid, target)
                router = getattr(server, "_fed_router", "") or ""
                if router:
                    pin = {"method": "PinRun", "run_id": rid,
                           "member_id": target,
                           "ckpt_every": quiesced["ckpt_every"],
                           "req_id": f"mig-{rid}-{nonce}-pin"}
                    if quiesced["target_turn"] is not None:
                        pin["target_turn"] = quiesced["target_turn"]
                    _rpc(router, pin, timeout=remaining())
            downtime_s = time.monotonic() - t_cut
            # Commit: the source retires (past the point of no return).
            flags = engine.migrate_commit(rid)
            for flag in flags:
                try:
                    _rpc(target, {"method": "CFput", "flag": int(flag),
                                  "run_id": rid,
                                  "req_id": f"mig-{rid}-{nonce}-cf-{flag}",
                                  }, timeout=5.0)
                except Exception as e:
                    obs_exception("migrate.flag_relay_failed", e,
                                  run_id=rid, flag=flag)
            # Viewer re-key: per-viewer xrle bases die with the source
            # copy; broadcast subscribers get the end sentinel and
            # reconnect through the router's new pin (epoch-bump
            # keyframe on the target's stream).
            server.drop_run_viewers(
                rid, f"killed: run {rid} migrated to {target}")
            _publish_downtime(downtime_s)
            root.attrs["downtime_ms"] = round(downtime_s * 1e3, 3)
        obs.MIGRATIONS.labels(status="ok").inc()
        _audit_phase(rid, target, "ok")
        obs_log("migrate.ok", run_id=rid, target=target,
                turn=quiesced["turn"],
                downtime_ms=round(downtime_s * 1e3, 3),
                relayed_flags=len(flags))
        return {"run_id": rid, "target": target,
                "turn": int(quiesced["turn"]),
                "downtime_ms": round(downtime_s * 1e3, 3),
                "status": "ok", "phase_ms": times,
                "transfer_bytes": int(frame.nbytes)}
    except Exception as e:
        failed_phase = _rollback(engine, rid, target, staged_on_target,
                                 quiesced, e, nonce)
        raise MigrationFailed(
            f"migration of run {rid} to {target} rolled back "
            f"({failed_phase}): {e}") from e
    finally:
        with _IN_FLIGHT_LOCK:
            _IN_FLIGHT -= 1


def _rollback(engine, rid: str, target: str, staged_on_target: bool,
              quiesced, cause: Exception, nonce: str) -> str:
    """Unwind in reverse: destroy the target's staged/committed copy, then
    restore the source run to its pre-quiesce state. Meters rolled_back
    on success, error when the source could not be restored."""
    obs_exception("migrate.failed", cause, run_id=rid, target=target)
    if staged_on_target:
        for attempt in (1, 2):
            try:
                _rpc(target, {"method": "DestroyRun", "run_id": rid,
                              "req_id": f"mig-{rid}-{nonce}-undo-"
                                        f"{attempt}"},
                     timeout=5.0)
                break
            except Exception as e:
                obs_exception("migrate.rollback_destroy_failed", e,
                              run_id=rid, target=target,
                              attempt=attempt)
                # Unknown-run means the copy never landed (or already
                # expired) — nothing to destroy.
                if "unknown run" in str(e):
                    break
                time.sleep(0.05)
    status = "rolled_back"
    try:
        if quiesced is not None:
            rec = engine.migrate_rollback(rid)
            if not rec.get("restored"):
                # Source handle gone mid-rollback (operator destroy is
                # refused while migrating, so the engine died) — nothing
                # to restore into.
                status = "error"
    except Exception as e:
        status = "error"
        obs_exception("migrate.rollback_failed", e, run_id=rid)
    obs.MIGRATIONS.labels(status=status).inc()
    _audit_phase(rid, target, status)
    obs_log("migrate.rolled_back", level="warning", run_id=rid,
            target=target, status=status,
            cause=f"{type(cause).__name__}: {cause}")
    return status
