"""Federated telemetry export/ingest: snapshots on the heartbeat — the
counterpart of `gol_tpu/obs/export.py`. The member answers `GetTelemetry`
with `local_doc()`; the federation agent's heartbeat carries
`SnapshotExporter`'s snapshots, and the router runs `FleetTelemetry`
(`federation/`).

Member half — `SnapshotExporter`. Every `RegisterMember` beat may
carry a `"snap"` key: a compact, delta-encoded snapshot of selected
catalog families (resident/queue counts, staleness & quantum
quantiles, SLO breach totals, CUPS, device memory) plus any pending
member audit events (obs/audit.note). Collection therefore costs ZERO
extra connections — the ops-per-byte discipline applied to
observability: telemetry rides bytes we already pay for.

    {"v": 1, "full": 1,                # first beat / after resync
     "m": {"res": 4, "q": 0,           # family values (short keys)
           "st": {"p50": 12.0, ...},   # staleness quantiles, ms
           "qt": {"64x64x8|p99": 3.1}, # quantum quantiles, ms
           "slo": 0, "cups": 2.1e8,
           "dev": {"live": 0, "peak": 0}},
     "ev": [{...audit events...}]}

Delta encoding is commit-on-ack: the baseline advances only after the
router acknowledged the beat, so a lost beat naturally re-ships its
changes. A router that has no state for a delta (restart) replies
`"snap_resync": true` and the next beat is full. The encoded snapshot
must fit `GOL_FED_SNAPSHOT_MAX` bytes (default 4 KiB; <= 0 disables
export entirely): an over-budget snapshot degrades by dropping its
LOWEST-priority families (metered via
gol_fed_snapshot_dropped_total{family}), then halving events — it
never fails or fattens the heartbeat past budget.

Registry half — `FleetTelemetry`. Ingests snapshots into the bounded
tsdb (obs/tsdb.py), computes fleet rollups at every router sweep
(resident total, aggregate CUPS, staleness p99 across members,
resident imbalance ratio — the signals a fleet autoscaler would
consume), publishes them as `gol_fed_agg_*` families,
feeds the alert manager (obs/alerts.py), and reference-swaps a
`"telemetry"` document for /healthz and `GetTelemetry`.

Stdlib-only.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

from gol_tpu_torch.obs import audit as obs_audit
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import slo as obs_slo
from gol_tpu_torch.obs import usage as obs_usage
from gol_tpu_torch.obs.alerts import AlertManager
from gol_tpu_torch.obs.tsdb import TSDB
from gol_tpu_torch.utils.envcfg import env_float

__all__ = ["SnapshotExporter", "FleetTelemetry", "collect_families",
           "local_doc", "snapshot_budget", "set_active_telemetry",
           "active_telemetry_doc"]

SNAPSHOT_MAX_ENV = "GOL_FED_SNAPSHOT_MAX"
SNAPSHOT_MAX_DEFAULT = 4096
SNAPSHOT_VERSION = 1
EVENTS_PER_BEAT = 32

# Family keys in PRIORITY order (first = most important = dropped
# last when the encoding exceeds the byte budget). Short keys keep the
# wire encoding compact; the long names are the metric label values.
FAMILY_PRIORITY = ("res", "q", "st", "qt", "slo", "cups", "dev", "use")
FAMILY_LABELS = {"res": "resident", "q": "queue", "st": "staleness",
                 "qt": "quantum", "slo": "slo", "cups": "cups",
                 "dev": "dev_bytes", "use": "usage"}


def snapshot_budget() -> float:
    return env_float(SNAPSHOT_MAX_ENV, SNAPSHOT_MAX_DEFAULT)


def _encoded_len(snap: dict) -> int:
    return len(json.dumps(snap, separators=(",", ":"),
                          sort_keys=True, default=str))


def collect_families() -> dict:
    """Current values of the exported catalog families, compact keys.
    Registry reads only — never an engine lock or a device sync.
    Values are rounded so delta comparison is stable across beats."""
    out = {"res": int(obs.RUNS_RESIDENT.value),
           "q": int(obs.FLEET_QUEUE_DEPTH.value)}
    st = {k[0]: round(c.value, 1)
          for k, c in obs.FLEET_STALENESS_MS.children().items()
          if c.value}
    if st:
        out["st"] = st
    qt = {"|".join(k): round(c.value, 3)
          for k, c in obs.FLEET_QUANTUM_MS.children().items()
          if c.value}
    if qt:
        out["qt"] = qt
    slo = sum(c.value for c in obs.RPC_SLO_BREACHES.children().values())
    if slo:
        out["slo"] = int(slo)
    cups = obs.ENGINE_CUPS.value
    if cups:
        out["cups"] = round(float(cups), 1)
    live = sum(c.value for c in obs.DEV_LIVE_BYTES.children().values())
    peak = sum(c.value for c in obs.DEV_PEAK_BYTES.children().values())
    if live or peak:
        out["dev"] = {"live": int(live), "peak": int(peak)}
    # Usage & capacity summary: tracked-run count, projected
    # admissible runs (best bucket class), aggregate CUPS headroom and
    # a tiny top-talker list. Lowest snapshot priority — the first
    # family dropped when the beat exceeds GOL_FED_SNAPSHOT_MAX.
    use = obs_usage.METER.export_summary()
    if use:
        out["use"] = use
    return out


def local_doc() -> dict:
    """A member's own telemetry view (the member-side `GetTelemetry`
    answer): current family values plus export bookkeeping."""
    return {"families": collect_families(),
            "pending_events": len(obs_audit.peek_pending(10 ** 6)),
            "snapshot_max": snapshot_budget(),
            "ts": time.time()}


class SnapshotExporter:
    """Member-side snapshot builder with commit-on-ack deltas."""

    def __init__(self) -> None:
        self._base: Optional[dict] = None
        self._built = None  # (sent families dict, events sent)

    def build(self) -> Optional[dict]:
        """The `"snap"` value for the next beat, or None when export
        is disabled (budget <= 0) or nothing fits the budget."""
        budget = snapshot_budget()
        if budget <= 0:
            self._built = None
            return None
        cur = collect_families()
        full = self._base is None
        if full:
            body = cur
        else:
            base = self._base
            body = {k: v for k, v in cur.items() if v != base.get(k)}
        events = obs_audit.peek_pending(EVENTS_PER_BEAT)
        keys = [k for k in FAMILY_PRIORITY if k in body]
        dropped = []
        while True:
            snap = {"v": SNAPSHOT_VERSION,
                    "m": {k: body[k] for k in keys}}
            if full:
                snap["full"] = 1
            if events:
                snap["ev"] = events
            size = _encoded_len(snap)
            if size <= budget:
                break
            if keys:
                dropped.append(keys.pop())  # lowest priority present
            elif events:
                events = events[:len(events) // 2]
                if not events:
                    obs.FED_SNAPSHOT_DROPPED.labels(
                        family="events").inc()
            else:
                # Even the bare envelope misses the budget: beat plain.
                self._built = None
                return None
        for k in dropped:
            obs.FED_SNAPSHOT_DROPPED.labels(
                family=FAMILY_LABELS.get(k, "unknown")).inc()
        obs.FED_SNAPSHOT_BYTES.set(size)
        obs.FED_SNAPSHOT_TOTAL.labels(
            kind="full" if full else "delta").inc()
        self._built = ({k: cur[k] for k in keys}, len(events))
        return snap

    def commit(self, resp: dict) -> None:
        """Advance the delta baseline — call ONLY after the beat's ack
        arrived. Families dropped for budget stay uncommitted and
        re-ship on the next beat; a `snap_resync` ack voids the
        baseline so the next beat goes out full."""
        built, self._built = self._built, None
        if built is None:
            return
        sent, n_events = built
        obs_audit.commit_pending(n_events)
        if resp.get("snap_resync"):
            self._base = None
            return
        base = dict(self._base or {})
        base.update(sent)
        self._base = base


# ----------------------------------------------------- registry side

class FleetTelemetry:
    """Router-resident ingest + rollup + alerting + audit glue."""

    def __init__(self, tsdb: Optional[TSDB] = None,
                 audit_log: Optional[obs_audit.AuditLog] = None,
                 alerts: Optional[AlertManager] = None) -> None:
        self.tsdb = tsdb or TSDB()
        self.audit_log = audit_log
        self.alerts = alerts or AlertManager(
            on_transition=self._on_alert)
        self._lock = threading.Lock()
        self._members: Dict[str, dict] = {}  # mid -> {"fam", "stamp"}
        self._payload = obs_slo.LogBucketEstimator()
        self._doc: dict = {}

    # -------------------------------------------------------- alerts

    def _on_alert(self, rule, event: str, value: float,
                  now: float) -> None:
        if self.audit_log is not None:
            self.audit_log.append(
                f"alert_{event}", rule=rule.name, signal=rule.signal,
                value=value, threshold=rule.threshold, ts=now)

    # -------------------------------------------------------- ingest

    def ingest(self, member_id: str, snap, ack: dict) -> None:
        """Merge one heartbeat snapshot; mutates `ack` in place to
        request a resync when a delta arrives with no base state."""
        if not isinstance(snap, dict):
            return
        self._payload.observe(float(_encoded_len(snap)))
        obs.FED_SNAPSHOT_INGESTED.inc()
        with self._lock:
            st = self._members.get(member_id)
            if st is None:
                st = {"fam": {}, "stamp": 0.0}
                self._members[member_id] = st
                if not snap.get("full"):
                    ack["snap_resync"] = True
            st["fam"].update(snap.get("m") or {})
            st["stamp"] = time.time()
        if self.audit_log is not None:
            for ev in snap.get("ev") or []:
                if not isinstance(ev, dict):
                    continue
                fields = {k: v for k, v in ev.items()
                          if k not in ("schema", "seq", "ts", "kind")}
                self.audit_log.append(
                    str(ev.get("kind", "other")), member=member_id,
                    member_seq=ev.get("seq"), ts=ev.get("ts"),
                    **fields)

    # --------------------------------------------------------- sweep

    def sweep(self, members_doc: dict,
              now: Optional[float] = None) -> list:
        """One rollup pass (the router calls this from its sweep
        loop): aggregate the per-member states, publish gol_fed_agg_*,
        feed the tsdb, evaluate alerts. Returns alert transitions."""
        if now is None:
            now = time.time()
        live_ids = {d["member_id"]
                    for d in members_doc.get("members", [])
                    if d.get("state") == "live"}
        with self._lock:
            states = {mid: dict(st["fam"])
                      for mid, st in self._members.items()
                      if mid in live_ids}
        resident = sum(int(f.get("res", 0)) for f in states.values())
        queue_sum = sum(int(f.get("q", 0)) for f in states.values())
        queue_max = max((int(f.get("q", 0))
                         for f in states.values()), default=0)
        cups = sum(float(f.get("cups", 0.0)) for f in states.values())
        slo = sum(int(f.get("slo", 0)) for f in states.values())
        dev_live = sum(int((f.get("dev") or {}).get("live", 0))
                       for f in states.values())
        stale = {q: max((float((f.get("st") or {}).get(q, 0.0))
                         for f in states.values()), default=0.0)
                 for q in obs.SLO_QUANTILES}
        residents = [int(f.get("res", 0)) for f in states.values()]
        mean_res = (sum(residents) / len(residents)) if residents else 0
        imbalance = (max(residents) / mean_res
                     if residents and mean_res > 0 else 1.0)
        # Usage & capacity rollups: sum the heartbeat-borne
        # "use" summaries and merge the per-member top-talker lists
        # into one fleet-wide bounded table.
        use_tracked = sum(int((f.get("use") or {}).get("tracked", 0))
                          for f in states.values())
        use_adm = sum(int((f.get("use") or {}).get("adm", 0))
                      for f in states.values())
        use_hr = sum(float((f.get("use") or {}).get("hr", 0.0))
                     for f in states.values())
        usage_top: List[list] = []
        for mid, fam in states.items():
            for row in (fam.get("use") or {}).get("top", []):
                try:
                    usage_top.append(
                        [str(row[0]), float(row[1]), mid])
                except (TypeError, IndexError, ValueError):
                    continue
        usage_top.sort(key=lambda r: r[1], reverse=True)
        usage_top = usage_top[:8]

        obs.FED_AGG_USAGE_RUNS_TRACKED.set(use_tracked)
        obs.FED_AGG_USAGE_ADMISSIBLE_RUNS.set(use_adm)
        obs.FED_AGG_USAGE_CUPS_HEADROOM.set(round(use_hr, 1))
        obs.FED_AGG_RUNS_RESIDENT.set(resident)
        obs.FED_AGG_QUEUE_DEPTH.set(queue_sum)
        obs.FED_AGG_CUPS.set(cups)
        obs.FED_AGG_SLO_BREACHES.set(slo)
        obs.FED_AGG_DEV_LIVE_BYTES.set(dev_live)
        obs.FED_AGG_IMBALANCE.set(round(imbalance, 4))
        obs.FED_AGG_MEMBERS_REPORTING.set(len(states))
        for q, v in stale.items():
            obs.FED_AGG_STALENESS_MS.labels(q=q).set(round(v, 1))
        payload = {}
        if self._payload.count:
            for q, v in zip(obs.SLO_QUANTILES,
                            self._payload.percentiles(
                                (0.50, 0.95, 0.99))):
                if v is not None:
                    payload[q] = round(v, 1)
                    obs.FED_AGG_PAYLOAD_BYTES.labels(q=q).set(
                        round(v, 1))

        t = self.tsdb
        t.append("fleet.runs_resident", resident, ts=now)
        t.append("fleet.queue_depth", queue_sum, ts=now)
        t.append("fleet.cups", cups, ts=now)
        t.append("fleet.staleness_p99_ms", stale.get("p99", 0.0),
                 ts=now)
        t.append("fleet.imbalance_ratio", imbalance, ts=now)
        for mid, fam in states.items():
            t.append("member.runs_resident", int(fam.get("res", 0)),
                     labels={"member": mid}, ts=now)
            t.append("member.cups", float(fam.get("cups", 0.0)),
                     labels={"member": mid}, ts=now)
            t.append("member.staleness_p99_ms",
                     float((fam.get("st") or {}).get("p99", 0.0)),
                     labels={"member": mid}, ts=now)

        signals = {
            "members_dead": float(members_doc.get("dead", 0)),
            "members_live": float(members_doc.get("live", 0)),
            "members_reporting": float(len(states)),
            "members_multi": len(states) >= 2,
            "runs_resident": float(resident),
            "queue_depth": float(queue_max),
            "queue_depth_sum": float(queue_sum),
            "staleness_p99_ms": stale.get("p99", 0.0),
            "imbalance_ratio": imbalance,
            "cups": cups,
            "slo_breaches": float(slo),
        }
        transitions = self.alerts.evaluate(signals, now)

        member_rows = {}
        for mid, fam in sorted(states.items()):
            member_rows[mid] = {
                "resident": int(fam.get("res", 0)),
                "queue_depth": int(fam.get("q", 0)),
                "cups": float(fam.get("cups", 0.0)),
                "staleness_p99_ms": float(
                    (fam.get("st") or {}).get("p99", 0.0)),
                "slo_breaches": int(fam.get("slo", 0)),
                "dev_live_bytes": int(
                    (fam.get("dev") or {}).get("live", 0)),
            }
        doc = {
            "fleet": {
                "runs_resident": resident,
                "queue_depth": queue_sum,
                "cups": cups,
                "staleness_p99_ms": stale.get("p99", 0.0),
                "imbalance_ratio": round(imbalance, 4),
                "members_reporting": len(states),
                "members_live": members_doc.get("live", 0),
                "members_dead": members_doc.get("dead", 0),
                "slo_breaches": slo,
                "dev_live_bytes": dev_live,
                "usage": {
                    "runs_tracked": use_tracked,
                    "admissible_runs": use_adm,
                    "cups_headroom": round(use_hr, 1),
                },
            },
            "usage_top": [
                {"run_id": rid, "device_s": dev_s, "member": mid}
                for rid, dev_s, mid in usage_top],
            "members": member_rows,
            "alerts": self.alerts.doc(),
            "tsdb": self.tsdb.doc(),
            "payload_bytes": payload,
            "ts": now,
        }
        if self.audit_log is not None:
            doc["audit_seq"] = self.audit_log.seq
        self._doc = doc  # reference swap: /healthz reads lock-free
        return transitions

    # --------------------------------------------------------- reads

    def doc(self) -> dict:
        return self._doc

    def query(self, name: str, labels=(), tier: str = "raw",
              since: float = 0.0) -> list:
        return self.tsdb.query(name, labels=labels, tier=tier,
                               since=since)

    def audit_tail(self, since_seq: int = 0,
                   limit: int = 100) -> list:
        if self.audit_log is None:
            return []
        return self.audit_log.tail(since_seq, limit)


# -- /healthz hook: the process's active aggregator --------------------

_active: Optional[FleetTelemetry] = None


def set_active_telemetry(t: Optional[FleetTelemetry]) -> None:
    global _active
    _active = t


def active_telemetry_doc() -> Optional[dict]:
    """The active aggregator's telemetry doc, or None when this
    process runs no registry tier (members add no telemetry key)."""
    t = _active
    return None if t is None else t.doc()
