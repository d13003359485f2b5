"""The federation router tier: placement, proxying, failover — the
counterpart of `gol_tpu/federation/router.py`. It serves either
package's members and clients: the registry, the placement (the same
rendezvous score), PinRun, the relay and the dedupe window speak the
same wire, byte for byte.

A thin TCP front speaking the ordinary wire protocol. It does three jobs
and deliberately nothing else:

* **Membership** — `RegisterMember` feeds the `MemberRegistry` (and its
  telemetry snapshot the `FleetTelemetry` aggregator); a sweeper thread
  declares death when heartbeats lapse (`GOL_FED_HEARTBEAT` /
  `GOL_FED_DEAD_AFTER`).
* **Placement** — `CreateRun` is placed by rendezvous (HRW) hashing on
  `run_id` over the live members (`hrw.place`); `ListRuns` fans out to
  every live member and merges. Run-scoped RPCs follow the placement
  map, falling back to the HRW owner for runs the router never saw
  created (a restarted router re-derives identical placements).
  `PinRun` (the live-migration redirect) atomically re-points one run's
  placement at its new owner.
* **Failover** — a dead member's placed runs are adopted by survivors
  (`AdoptRun` → `FleetEngine.adopt_run` → the quarantine→restore
  machinery, reading the per-run `run-<id>/` manifests under the shared
  checkpoint root). Proxied calls that land in the failover window WAIT
  (bounded by `GOL_FED_REROUTE`) for the adoption to re-home the run
  instead of failing — that wait IS the failover downtime.

Proxying is a transparent byte relay (`wire.recv_head_raw` / `send_raw`
/ `relay_payload`): the member sees the client's exact bytes — `req_id`,
`tc` trace context, negotiated codecs — and vice versa, so the
retry/dedupe semantics survive the extra hop unchanged. The router also
keeps its OWN req_id dedupe window for mutating methods: a retried
mutate whose first attempt already committed on a member that has since
died is answered from the recorded reply instead of re-executing on the
adopting member. A member's "moved:" answer is never recorded there.

Viewer re-routing needs no special machinery: an adopting member has no
per-viewer xrle basis, so its first reply to a re-routed viewer is a
keyframe, which the client's basis bookkeeping accepts.

Router overhead (client-facing wall time minus the member-facing round
trip) feeds a log-bucket estimator published as
`gol_fed_router_overhead_ms{q}`. `GetTelemetry` answers with the fleet
rollups (and one tsdb series when the request names `series`),
`GetAudit` with the durable fleet audit log.

Run:  python -m gol_tpu_torch.federation.router [--port 8799]
          [--host 127.0.0.1] [--metrics-port PORT] [--audit-dir DIR]
"""

from __future__ import annotations

import argparse
import collections
import os
import socket
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from gol_tpu_torch import wire
from gol_tpu_torch.federation import hrw
from gol_tpu_torch.federation import registry as registry_mod
from gol_tpu_torch.federation.registry import Member, MemberRegistry
from gol_tpu_torch.obs import audit as obs_audit
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import export as obs_export
from gol_tpu_torch.obs import slo as obs_slo
from gol_tpu_torch.obs.log import log as obs_log
from gol_tpu_torch.utils.envcfg import env_float

AUDIT_DIR_ENV = "GOL_AUDIT_DIR"

REROUTE_ENV = "GOL_FED_REROUTE"
REROUTE_DEFAULT_S = 10.0
DIAL_TIMEOUT_ENV = "GOL_FED_DIAL_TIMEOUT"
DIAL_TIMEOUT_DEFAULT_S = 2.0
MEMBER_TIMEOUT_ENV = "GOL_FED_MEMBER_TIMEOUT"
MEMBER_TIMEOUT_DEFAULT_S = 30.0

# Same window geometry as the member servers (server.py): bounded
# entries, bounded wait for a duplicate racing its first attempt.
DEDUPE_MAX = 512
DEDUPE_WAIT_S = 60.0

# Mutating methods mirror server.MUTATING_METHODS (a copy: server.py
# pulls the engines in, and a router process needs none of them).
MUTATING_METHODS = frozenset({
    "CreateRun", "DestroyRun", "SetRule", "Checkpoint", "CFput",
    "DrainFlags", "RestoreRun", "AbortRun", "Profile", "KillProg",
    "AdoptRun", "Rescale", "ReceiveRun", "CommitRun", "PinRun",
})


class _DedupeEntry:
    __slots__ = ("done", "raw")

    def __init__(self) -> None:
        self.done = threading.Event()
        self.raw: Optional[bytes] = None


class FederationRouter:
    """One router process (or in-process instance, for tests/bench)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MemberRegistry] = None,
                 audit_dir: Optional[str] = None) -> None:
        self.host = host
        self.registry = registry or MemberRegistry()
        # Fleet telemetry plane: durable audit log (memory-only unless
        # GOL_AUDIT_DIR / audit_dir names a directory), bounded tsdb +
        # rollups + alerting fed by heartbeat snapshots.
        if audit_dir is None:
            audit_dir = os.environ.get(AUDIT_DIR_ENV) or None
        self.audit_log = obs_audit.AuditLog(path=audit_dir)
        self.telemetry = obs_export.FleetTelemetry(
            audit_log=self.audit_log)
        # run_id -> {"member", "ckpt_every", "target_turn"}
        self._placements: Dict[str, dict] = {}
        self._plock = threading.Lock()
        self._dedupe: "collections.OrderedDict[str, _DedupeEntry]" = \
            collections.OrderedDict()
        self._dlock = threading.Lock()
        self._overhead = obs_slo.LogBucketEstimator()
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        registry_mod.set_active(self.registry)
        obs_export.set_active_telemetry(self.telemetry)

    # -- lifecycle ----------------------------------------------------

    def start_background(self) -> "FederationRouter":
        for name, fn in (("gol-fed-accept", self._accept_loop),
                         ("gol-fed-sweep", self._sweep_loop)):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def shutdown(self) -> None:
        self._shutdown.set()
        try:
            # Wakes the thread blocked in accept(); close() alone does
            # not, and the accept thread is joined below.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=2.0)
        registry_mod.set_active(None)
        obs_export.set_active_telemetry(None)
        self.audit_log.close()

    # -- accept / dispatch --------------------------------------------

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            wire.enable_nodelay(conn)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 name="gol-fed-conn", daemon=True)
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        t0 = time.perf_counter()
        try:
            conn.settimeout(30.0)
            header, head_raw = wire.recv_head_raw(conn)
            n = wire.payload_nbytes(header)
            # Requests are buffered whole so a dial failure can retry
            # against another member (client payloads are seed boards
            # and control frames — small by construction; multi-GB
            # boards only ever ride REPLIES, which stream).
            payload = wire._recv_exact(conn, n) if n else b""
            method = str(header.get("method", ""))
            if method == "RegisterMember":
                mid = str(header.get("member_id", ""))
                ack = self.registry.register(
                    mid,
                    str(header.get("address", "")),
                    int(header.get("seq", 0)),
                    capacity=int(header.get("capacity", 0)),
                    mesh=header.get("mesh"))
                if ack.get("joined"):
                    self.audit_log.append("member_join", member=mid)
                elif ack.get("rejoined"):
                    self.audit_log.append("member_rejoin", member=mid)
                # Heartbeat-borne telemetry: ingest may mark the ack
                # with snap_resync when a delta finds no base state.
                self.telemetry.ingest(mid, header.get("snap"), ack)
                wire.send_msg(conn, ack)
                return
            if method == "GetTelemetry":
                wire.send_msg(conn, self._get_telemetry(header))
                return
            if method == "GetAudit":
                wire.send_msg(conn, self._get_audit(header))
                return
            if method == "ListRuns":
                wire.send_msg(conn, self._list_runs(header))
                return
            if method == "PinRun":
                # Live migration redirect: the migration
                # coordinator re-points a run's placement at its new
                # owner. Served locally — this IS the atomic authority
                # flip; every later proxied call follows the new pin.
                wire.send_msg(conn, self._pin_run(header))
                return
            self._proxy(conn, header, head_raw, payload, method, t0)
        except (ConnectionError, OSError, wire.WireProtocolError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- ListRuns fan-out ---------------------------------------------

    def _list_runs(self, header: dict) -> dict:
        merged: List[dict] = []
        errors = 0
        for m in self.registry.live_members():
            try:
                resp, _ = self._member_call(
                    m, {"method": "ListRuns",
                        "run_id": header.get("run_id")})
                if "error" in resp:
                    errors += 1
                else:
                    for rec in resp.get("runs", []):
                        rec = dict(rec)
                        rec["member"] = m.member_id
                        merged.append(rec)
            except (ConnectionError, OSError,
                    wire.WireProtocolError):
                errors += 1
        merged.sort(key=lambda r: str(r.get("run_id", "")))
        doc = {"ok": True, "runs": merged}
        if errors:
            doc["members_unreachable"] = errors
        return doc

    # -- proxying -----------------------------------------------------

    def _proxy(self, conn: socket.socket, header: dict,
               head_raw: bytes, payload: bytes, method: str,
               t0: float) -> None:
        rid = header.get("run_id")
        if method == "CreateRun" and not rid:
            # The router owns id generation when the client left it to
            # the server: HRW needs the id BEFORE the member sees the
            # request, so stamp one and rewrite the header (the only
            # rewrite the relay ever performs).
            rid = uuid.uuid4().hex
            header = dict(header)
            header["run_id"] = rid
            head_raw = wire.frame_header(header)
        req_id = header.get("req_id")
        key = None
        ent = None
        if method in MUTATING_METHODS and req_id:
            key = f"{method}|{req_id}"
            ent, replay = self._dedupe_check(key)
            if replay is not None:
                obs.SERVER_DEDUP_HITS.labels(
                    method=obs.method_label(method)).inc()
                wire.send_raw(conn, replay)
                return
        try:
            reply_raw = self._forward_with_failover(
                conn, header, head_raw, payload, method, rid, t0)
            if ent is not None:
                ent.raw = reply_raw
        finally:
            if ent is not None:
                ent.done.set()

    def _dedupe_check(self, key: str) -> Tuple[Optional[_DedupeEntry],
                                               Optional[bytes]]:
        """(owned entry, None) for a first-seen req_id; (None, raw
        reply) for a duplicate whose first attempt committed. A
        duplicate racing an in-flight first attempt waits on it."""
        with self._dlock:
            ent = self._dedupe.get(key)
            if ent is None:
                ent = _DedupeEntry()
                self._dedupe[key] = ent
                while len(self._dedupe) > DEDUPE_MAX:
                    old_key, old = next(iter(self._dedupe.items()))
                    if old is ent or not old.done.is_set():
                        break
                    self._dedupe.pop(old_key, None)
                return ent, None
        if ent.done.wait(DEDUPE_WAIT_S) and ent.raw is not None:
            return None, ent.raw
        # First attempt never produced a recordable reply: the retry
        # proceeds as its own attempt (the MEMBER's dedupe window still
        # protects a same-member replay).
        return ent, None

    def _forward_with_failover(self, conn: socket.socket, header: dict,
                               head_raw: bytes, payload: bytes,
                               method: str, rid, t0: float,
                               ) -> Optional[bytes]:
        deadline = t0 + env_float(REROUTE_ENV, REROUTE_DEFAULT_S)
        excluded: set = set()
        member_s = 0.0
        while True:
            target = self._pick_target(method, rid, excluded)
            if target is None:
                if time.perf_counter() >= deadline:
                    wire.send_msg(conn, {
                        "error": "overloaded: no live federation "
                                 "member for this request"})
                    return None
                if excluded and not set(
                        self.registry.live_ids()) - excluded:
                    excluded.clear()  # everyone failed once: retry all
                time.sleep(0.02)
                continue
            tm0 = time.perf_counter()
            try:
                reply_raw = self._relay_once(conn, target, head_raw,
                                             payload)
            except _MemberUnreachable:
                excluded.add(target.member_id)
                if time.perf_counter() >= deadline:
                    wire.send_msg(conn, {
                        "error": "overloaded: federation reroute "
                                 "deadline exceeded"})
                    return None
                continue
            member_s = time.perf_counter() - tm0
            total_s = time.perf_counter() - t0
            self._overhead.observe(max(0.0, total_s - member_s))
            if method == "CreateRun" and rid:
                self._record_placement(rid, header, target.member_id)
            return reply_raw

    def _pick_target(self, method: str, rid,
                     excluded: set) -> Optional[Member]:
        live = {m.member_id: m for m in self.registry.live_members()}
        candidates = [mid for mid in live if mid not in excluded]
        if not candidates:
            return None
        if rid:
            with self._plock:
                pl = self._placements.get(rid)
            if pl is not None:
                mid = pl["member"]
                if mid in live and mid not in excluded:
                    return live[mid]
                # Placed on a dead/unreachable member: wait for the
                # sweeper's adoption to re-home it rather than guessing
                # (the caller loops under the reroute deadline).
                return None
            if method != "CreateRun":
                # Never saw this run created (router restart): the HRW
                # owner is where CreateRun would have put it.
                owner = hrw.place(str(rid), candidates)
                return live[owner] if owner else None
            placed = hrw.place(str(rid), candidates)
            return live[placed] if placed else None
        # No run scope (Ping/Stats/GetMetrics/...): deterministic pick.
        return live[sorted(candidates)[0]]

    def _relay_once(self, conn: socket.socket, target: Member,
                    head_raw: bytes, payload: bytes) -> Optional[bytes]:
        """One member round trip, bytes verbatim both ways. Raises
        _MemberUnreachable while nothing has been relayed to the
        client (safe to retry elsewhere); once reply bytes flow the
        call is committed."""
        host, _, port = target.address.rpartition(":")
        try:
            msock = socket.create_connection(
                (host or "127.0.0.1", int(port)),
                timeout=env_float(DIAL_TIMEOUT_ENV,
                                  DIAL_TIMEOUT_DEFAULT_S))
        except (OSError, ConnectionError) as e:
            raise _MemberUnreachable(str(e)) from e
        try:
            msock.settimeout(env_float(MEMBER_TIMEOUT_ENV,
                                       MEMBER_TIMEOUT_DEFAULT_S))
            wire.enable_nodelay(msock)
            try:
                wire.send_raw(msock, head_raw)
                if payload:
                    msock.sendall(payload)
                reply_header, reply_raw = wire.recv_head_raw(msock)
                rn = wire.payload_nbytes(reply_header)
            except (ConnectionError, OSError,
                    wire.WireProtocolError) as e:
                # Nothing reached the client yet — retryable.
                raise _MemberUnreachable(str(e)) from e
            wire.send_raw(conn, reply_raw)
            if rn:
                wire.relay_payload(msock, conn, rn)
                return None  # framed replies aren't replayable
            if str(reply_header.get("error", "")).startswith("moved:"):
                # A migration-window straggler: the member's answer is
                # "retry via the new pin", not a commit outcome — it
                # must never be replayed from the dedupe window or the
                # client's retry would see "moved:" forever.
                return None
            return reply_raw
        finally:
            try:
                msock.close()
            except OSError:
                pass

    def _pin_run(self, header: dict) -> dict:
        """Atomically re-point (or insert) a run's placement at a named
        live member. The single authority flip of a live migration: one
        dict store under _plock — calls relayed before it land on the
        source (which answers post-commit stragglers with a retryable
        "moved:"), calls after it land on the target."""
        rid = str(header.get("run_id") or "")
        mid = str(header.get("member_id") or "")
        if not rid or not mid:
            return {"error": "PinRun requires run_id and member_id"}
        member = self.registry.get(mid)
        if member is None or member.state != "live":
            return {"error": f"overloaded: member {mid} is not a live "
                             "federation member"}
        tt = header.get("target_turn")
        with self._plock:
            pl = self._placements.get(rid)
            prev = pl["member"] if pl else None
            self._placements[rid] = {
                "member": mid,
                "ckpt_every": int(header.get("ckpt_every", 0) or 0),
                "target_turn": int(tt) if tt is not None else None,
            }
        obs_log("fed.pinned", run_id=rid, member=mid, prev=prev)
        return {"ok": True, "run_id": rid, "member": mid, "prev": prev}

    # -- telemetry / audit queries (served locally) --------------------

    def _get_telemetry(self, header: dict) -> dict:
        """The fleet telemetry doc; an optional `series` key adds one
        tsdb series' merged buckets (`tier`, `since`, `labels`)."""
        doc = dict(self.telemetry.doc())
        name = header.get("series")
        if name:
            doc["series"] = {
                "name": str(name),
                "tier": str(header.get("tier", "raw")),
                "points": self.telemetry.query(
                    str(name),
                    labels=header.get("labels") or (),
                    tier=str(header.get("tier", "raw")),
                    since=float(header.get("since", 0.0) or 0.0)),
            }
        return {"ok": True, "telemetry": doc}

    def _get_audit(self, header: dict) -> dict:
        try:
            since_seq = int(header.get("since_seq", 0) or 0)
            limit = int(header.get("limit", 100) or 100)
        except (TypeError, ValueError):
            return {"error": "GetAudit: since_seq/limit must be ints"}
        return {"ok": True, "seq": self.audit_log.seq,
                "records": self.audit_log.tail(since_seq, limit)}

    def _record_placement(self, rid: str, header: dict,
                          member_id: str) -> None:
        tt = header.get("target_turn")
        with self._plock:
            self._placements[str(rid)] = {
                "member": member_id,
                "ckpt_every": int(header.get("ckpt_every", 0) or 0),
                "target_turn": int(tt) if tt is not None else None,
            }

    # -- member-side RPC (registry fan-out, adoption) ------------------

    def _member_call(self, member: Member, header: dict,
                     timeout: Optional[float] = None) -> tuple:
        host, _, port = member.address.rpartition(":")
        with socket.create_connection(
                (host or "127.0.0.1", int(port)),
                timeout=env_float(DIAL_TIMEOUT_ENV,
                                  DIAL_TIMEOUT_DEFAULT_S)) as sock:
            sock.settimeout(timeout if timeout is not None
                            else env_float(MEMBER_TIMEOUT_ENV,
                                           MEMBER_TIMEOUT_DEFAULT_S))
            wire.enable_nodelay(sock)
            wire.send_msg(sock, header)
            return wire.recv_msg(sock)

    # -- sweep / failover ---------------------------------------------

    def _sweep_loop(self) -> None:
        interval = min(1.0, max(
            0.05, registry_mod.heartbeat_interval_s() / 2.0))
        while not self._shutdown.wait(interval):
            try:
                self._sweep_once()
            except Exception as e:  # noqa: BLE001 — sweeper must live
                obs_log("fed.sweep_failed", level="error",
                        error=f"{type(e).__name__}: {e}")
        self._flush_overhead()

    def _sweep_once(self) -> None:
        for member in self.registry.sweep():
            obs_log("fed.member_dead", level="error",
                    member=member.member_id)
            self.audit_log.append("member_death",
                                  member=member.member_id,
                                  address=member.address)
            self._adopt_runs_of(member)
        # Rollups + alert evaluation ride the same sweep cadence the
        # death verdicts do — alert detection latency is bounded by
        # GOL_FED_DEAD_AFTER plus half a heartbeat, nothing more.
        self.telemetry.sweep(self.registry.members_doc())
        self._flush_overhead()

    def _flush_overhead(self) -> None:
        if not self._overhead.count:
            return
        p50, p95, p99 = self._overhead.percentiles((0.50, 0.95, 0.99))
        for q, v in zip(obs.SLO_QUANTILES, (p50, p95, p99)):
            if v is not None:
                obs.FED_ROUTER_OVERHEAD_MS.labels(q=q).set(
                    round(v * 1e3, 3))

    def _adopt_runs_of(self, member: Member) -> None:
        with self._plock:
            orphans = [(rid, dict(pl))
                       for rid, pl in self._placements.items()
                       if pl["member"] == member.member_id]
        for rid, pl in orphans:
            self._adopt_one(rid, pl)

    def _adopt_one(self, rid: str, pl: dict) -> None:
        """Re-home one orphaned run on the HRW-ranked survivors. On
        success the placement map re-points and proxied calls waiting
        under the reroute deadline proceed; on total failure the
        placement is dropped so lazy HRW discovery can still find the
        run if a member restores it by other means."""
        survivors = self.registry.live_ids()
        header = {"method": "AdoptRun", "run_id": rid,
                  "req_id": uuid.uuid4().hex,
                  "ckpt_every": pl.get("ckpt_every", 0)}
        if pl.get("target_turn") is not None:
            header["target_turn"] = pl["target_turn"]
        for mid in hrw.rank(rid, survivors):
            member = self.registry.get(mid)
            if member is None or member.state != "live":
                continue
            try:
                resp, _ = self._member_call(member, header)
            except (ConnectionError, OSError,
                    wire.WireProtocolError) as e:
                obs_log("fed.adopt_rpc_failed", level="warning",
                        run_id=rid, member=mid,
                        error=f"{type(e).__name__}: {e}")
                continue
            if "error" in resp:
                obs_log("fed.adopt_refused", level="warning",
                        run_id=rid, member=mid,
                        error=resp["error"])
                continue
            with self._plock:
                self._placements[rid]["member"] = mid
            obs_log("fed.adopted", run_id=rid, member=mid,
                    state=resp.get("run", {}).get("state"))
            self.audit_log.append("adopt", run_id=rid, member=mid)
            return
        obs.FED_ADOPTED_RUNS.labels(status="error").inc()
        obs_log("fed.adopt_failed", level="error", run_id=rid)
        with self._plock:
            self._placements.pop(rid, None)


class _MemberUnreachable(ConnectionError):
    """Dial/round-trip failed before any reply byte reached the
    client — the forward loop may retry another member."""


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description="gol_tpu_torch federation router (membership + HRW "
                    "placement + transparent proxy + failover)")
    ap.add_argument("--port", type=int, default=8799)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics + /healthz (0 = ephemeral)")
    ap.add_argument("--audit-dir", default=None,
                    help="directory for the durable gol-fleet-audit/1 "
                         "JSONL log (default $GOL_AUDIT_DIR, else "
                         "memory-only)")
    args = ap.parse_args(argv)

    router = FederationRouter(port=args.port, host=args.host,
                              audit_dir=args.audit_dir)
    if args.metrics_port is not None:
        from gol_tpu_torch.obs.http import start_metrics_server
        msrv = start_metrics_server(args.metrics_port)
        print(f"metrics on :{msrv.port}", flush=True)
    router.start_background()
    print(f"gol_tpu_torch federation router serving on :{router.port}",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        router.shutdown()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
