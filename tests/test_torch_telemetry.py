"""The port's telemetry surface, held against `gol_tpu`'s:

  * `obs/tsdb.py` and `obs/alerts.py` — counterparts of `tests/test_tsdb.py`
    and `tests/test_alerts.py`, plus one script run through both packages'
    stores and rule managers with equal answers;
  * `obs/export.py` and `obs/audit.py` — the export, ingest and audit-log
    cases of `tests/test_telemetry.py` (the router's wire face is held in
    `tests/test_torch_federation.py`);
  * the GetTelemetry, GetAudit and GetUsage RPCs: one fleet script (two
    runs, a chaos popcount poison that quarantines one, a destroy) through
    each package's server gives equal replies. Clock fields are excluded:
    `ts`; the usage meter's `attribution`, `device_s`, `dur_s`,
    `share_pct`, `cups_headroom` and `quantum_mean_ms`; the telemetry
    families' `cups`, quantum milliseconds and CUPS headroom; and
    `wire_out`, whose reply headers carry turns the loop's timing sets;
  * `obs/devstats.py`, `obs/prof.py` and `obs/http.py` — the devstats and
    profiler cases of `tests/test_prof.py` on `torch.profiler`: Profile
    arms, captures N turns of `Engine(device="cpu")`, writes a Chrome
    trace and keeps every published (alive, turn) pair exact;
  * the CLI's observability flags on `--device cpu`, and /metrics,
    /healthz and /profile over the server's `--metrics-port`.

Tolerance: none."""

from __future__ import annotations

import glob
import json
import os
import queue
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import gol_tpu
from gol_tpu import chaos as jchaos
from gol_tpu.client import RemoteEngine as JRemote
from gol_tpu.fleet import FleetEngine as JFleet
from gol_tpu.obs import alerts as jalerts
from gol_tpu.obs import tsdb as jtsdb
from gol_tpu.obs import usage as jusage
from gol_tpu.ops.reference import run_turns_np
from gol_tpu.server import EngineServer as JServer
import gol_tpu_torch
from gol_tpu_torch import chaos as tchaos
from gol_tpu_torch.client import RemoteEngine
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.fleet import FleetEngine
from gol_tpu_torch.obs import audit as obs_audit
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import devstats
from gol_tpu_torch.obs import export as obs_export
from gol_tpu_torch.obs import prof as obs_prof
from gol_tpu_torch.obs import usage as obs_usage
from gol_tpu_torch.obs.alerts import (
    AlertManager, AlertRule, builtin_rules, rules_from_env)
from gol_tpu_torch.obs.audit import AuditLog
from gol_tpu_torch.obs.export import (
    FleetTelemetry, SnapshotExporter, collect_families, snapshot_budget)
from gol_tpu_torch.obs.timeline import read_report, validate_record
from gol_tpu_torch.obs.tsdb import TSDB, tier_table
from gol_tpu_torch.params import Params
from gol_tpu_torch.server import EngineServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stop_server(srv) -> None:
    """Stop an engine server of either package and join its accept
    thread. `gol_tpu`'s shutdown closes the listening socket, which does
    not wake a thread blocked in accept(); one connection does, and the
    loop then sees the shutdown flag."""
    serve = [t for t in threading.enumerate()
             if getattr(t, "_target", None) == srv.serve_forever]
    srv.shutdown()
    try:
        socket.create_connection(("127.0.0.1", srv.port),
                                 timeout=1.0).close()
    except OSError:
        pass
    for t in serve:
        t.join(timeout=10)
        assert not t.is_alive(), "accept thread outlived its server"


# The threads alive when this file's first test starts: a worker runs
# several files in one process, and the leftover check below holds this
# file to the threads it started.
_THREADS_BEFORE: set = set()


@pytest.fixture(scope="module", autouse=True)
def _threads_before_this_file():
    _THREADS_BEFORE.update(threading.enumerate())
    yield


def _gol_tpu_threads() -> list:
    """Live threads running code of the JAX package that this file
    started."""
    out = []
    for t in threading.enumerate():
        if t in _THREADS_BEFORE:
            continue
        target = getattr(t, "_target", None)
        mod = (getattr(target, "__module__", None) if target is not None
               else type(t).__module__) or ""
        if mod.split(".")[0] == "gol_tpu":
            out.append(f"{t.name} ({mod})")
    return out


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Process-wide state this file touches: the member event queue and
    the profile controller."""
    obs_audit.commit_pending(10 ** 6)
    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")
    for k in ("GOL_PROFILE_DIR", "GOL_PROFILE_TURNS", "GOL_TRACE",
              "GOL_RUN_REPORT", "GOL_CHAOS", "GOL_CKPT", "GOL_FUSE_K"):
        monkeypatch.delenv(k, raising=False)
    yield
    obs_audit.commit_pending(10 ** 6)
    obs_prof.PROFILER.take()
    obs_prof.PROFILER.configure(None)
    obs.PROFILE_ARMED.set(0.0)


def _board(h, w):
    world = np.zeros((h, w), np.uint8)
    world[1, 1:4] = 255  # blinker
    return world


def _soup(h, w, seed, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < density).astype(np.uint8) * 255


# ================================================================ tsdb


def make(max_series=64):
    return TSDB(max_series=max_series)


def test_downsample_min_max_mean_last_exact_across_tiers():
    t = make()
    for i in range(120):
        t.append("m", float(i), ts=1000.0 + i)
    one_m = t.query("m", tier="1m")
    assert [p["t"] for p in one_m] == [960.0, 1020.0, 1080.0]
    full = one_m[1]
    assert full["count"] == 60
    assert full["min"] == 20.0 and full["max"] == 79.0
    assert full["mean"] == pytest.approx((20 + 79) / 2)
    assert full["last"] == 79.0
    ten_m = t.query("m", tier="10m")
    assert sum(p["count"] for p in ten_m) == 120
    assert ten_m[-1]["last"] == 119.0
    assert min(p["min"] for p in ten_m) == 0.0
    assert max(p["max"] for p in ten_m) == 119.0


def test_raw_tier_buckets_at_raw_resolution():
    t = make()
    for i in range(5):
        t.append("m", float(i), ts=100.0 + 10 * i)
    raw = t.query("m", tier="raw")
    assert [p["t"] for p in raw] == [100.0, 110.0, 120.0, 130.0, 140.0]
    assert all(p["count"] == 1 for p in raw)


def test_out_of_order_sample_merges_into_open_bucket():
    t = make()
    t.append("m", 1.0, ts=200.0)
    t.append("m", 9.0, ts=150.0)  # older than the open bucket
    raw = t.query("m", tier="raw")
    assert len(raw) == 1 and raw[0]["count"] == 2
    assert raw[0]["min"] == 1.0 and raw[0]["max"] == 9.0


def test_query_since_filters_buckets():
    t = make()
    for i in range(10):
        t.append("m", float(i), ts=100.0 + 10 * i)
    late = t.query("m", tier="raw", since=150.0)
    assert [p["t"] for p in late] == [150.0, 160.0, 170.0, 180.0, 190.0]


def test_ring_wraparound_keeps_newest_capacity_buckets():
    t = make()
    cap = next(row["cap"] for row in tier_table() if row["tier"] == "raw")
    res = next(row["res_s"] for row in tier_table()
               if row["tier"] == "raw")
    n = cap + 25
    for i in range(n):
        t.append("m", float(i), ts=1000.0 + res * i)
    raw = t.query("m", tier="raw")
    assert len(raw) == cap
    assert raw[0]["t"] == 1000.0 + res * 25 - (1000.0 % res)
    assert raw[-1]["last"] == float(n - 1)


def test_cardinality_cap_evicts_least_recently_appended():
    t = make(max_series=3)
    t.append("a", 1.0, ts=10.0)
    t.append("b", 1.0, ts=11.0)
    t.append("c", 1.0, ts=12.0)
    t.append("a", 2.0, ts=13.0)  # refresh a: b is now the LRU
    t.append("d", 1.0, ts=14.0)  # cap hit: evicts b
    assert {row["name"] for row in t.series_names()} == {"a", "c", "d"}
    assert t.query("b") == []
    doc = t.doc()
    assert doc["series"] == 3 and doc["evictions_total"] == 1
    assert obs.TSDB_EVICTIONS.value == 1


def test_labels_distinguish_series_and_are_order_insensitive():
    t = make()
    t.append("m", 1.0, labels={"x": "1", "y": "2"}, ts=10.0)
    t.append("m", 2.0, labels={"y": "2", "x": "1"}, ts=20.0)
    t.append("m", 9.0, labels={"x": "other"}, ts=10.0)
    pts = t.query("m", labels={"x": "1", "y": "2"}, tier="raw")
    assert sum(p["count"] for p in pts) == 2
    assert len(t.series_names()) == 2


def test_non_numeric_value_is_ignored():
    t = make()
    t.append("m", "not-a-number", ts=10.0)
    assert t.query("m") == []


def test_concurrent_ingest_loses_nothing_and_respects_cap():
    t = make(max_series=8)
    n_threads, per = 8, 500
    errs = []

    def pump(k):
        try:
            for i in range(per):
                t.append(f"s{k}", float(i), ts=1000.0 + i)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    threads = [threading.Thread(target=pump, args=(k,))
               for k in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert not errs
    doc = t.doc()
    assert doc["points_total"] == n_threads * per
    assert doc["series"] == 8
    for k in range(n_threads):
        pts = t.query(f"s{k}", tier="10m")
        assert sum(p["count"] for p in pts) == per


def test_doc_carries_retention_table():
    doc = make().doc()
    tiers = {row["tier"]: row for row in doc["tiers"]}
    assert set(tiers) == {"raw", "1m", "10m"}
    assert tiers["1m"]["res_s"] == 60.0
    for row in tiers.values():
        assert row["span_s"] == row["res_s"] * row["cap"]


def test_tsdb_answers_equal_gol_tpu():
    rng = np.random.default_rng(3)
    stores = (TSDB(max_series=5), jtsdb.TSDB(max_series=5))
    for i in range(2000):
        name = f"s{int(rng.integers(0, 7))}"
        labels = {"member": str(int(rng.integers(0, 2)))}
        value = float(rng.normal())
        ts = 1000.0 + i * 0.7 - float(rng.random()) * 5
        for st in stores:
            st.append(name, value, labels=labels, ts=ts)
    mine, ref = stores
    assert mine.series_names() == ref.series_names()
    assert mine.doc() == ref.doc()
    for row in ref.series_names():
        for tier in ("raw", "1m", "10m"):
            assert mine.query(row["name"], labels=row["labels"],
                              tier=tier, since=1500.0) == ref.query(
                row["name"], labels=row["labels"], tier=tier,
                since=1500.0)


# ============================================================== alerts


def manager(**rule_kw):
    rule = AlertRule("r", "sig", **rule_kw)
    events = []
    m = AlertManager(
        rules=[rule],
        on_transition=lambda r, ev, v, now: events.append((ev, v, now)))
    return m, events


def test_immediate_fire_when_for_s_zero():
    m, events = manager(op=">", threshold=0.0, for_s=0.0, clear_s=5.0)
    tr = m.evaluate({"sig": 1.0}, now=10.0)
    assert tr == [{"rule": "r", "event": "fired", "value": 1.0}]
    assert events == [("fired", 1.0, 10.0)]
    assert "r" in m.active()


def test_for_s_debounces_a_short_breach():
    m, events = manager(threshold=5.0, for_s=3.0, clear_s=5.0)
    assert m.evaluate({"sig": 9.0}, now=0.0) == []
    assert m.evaluate({"sig": 9.0}, now=2.0) == []
    assert m.evaluate({"sig": 1.0}, now=2.5) == []
    assert m.evaluate({"sig": 9.0}, now=4.0) == []
    tr = m.evaluate({"sig": 9.0}, now=7.0)
    assert [t["event"] for t in tr] == ["fired"]
    assert events[-1][2] == 7.0


def test_fired_metrics_move():
    fired0 = obs.ALERTS_FIRED.labels(rule="r-metrics").value
    rule = AlertRule("r-metrics", "sig", threshold=0.0, for_s=0.0,
                     clear_s=0.0)
    m = AlertManager(rules=[rule])
    m.evaluate({"sig": 2.0}, now=1.0)
    assert obs.ALERTS_ACTIVE.labels(rule="r-metrics").value == 1
    assert obs.ALERTS_FIRED.labels(rule="r-metrics").value == fired0 + 1
    m.evaluate({"sig": 0.0}, now=2.0)
    assert obs.ALERTS_ACTIVE.labels(rule="r-metrics").value == 0


def test_resolve_requires_clear_s_continuously_below():
    m, events = manager(threshold=0.0, for_s=0.0, clear_s=5.0)
    m.evaluate({"sig": 1.0}, now=0.0)
    assert m.evaluate({"sig": 0.0}, now=1.0) == []
    assert m.evaluate({"sig": 0.0}, now=4.0) == []
    tr = m.evaluate({"sig": 0.0}, now=6.5)
    assert [t["event"] for t in tr] == ["resolved"]
    assert m.active() == {}
    assert [e[0] for e in events] == ["fired", "resolved"]


def test_flap_suppression_restarts_the_clear_window():
    m, events = manager(threshold=0.0, for_s=0.0, clear_s=5.0)
    m.evaluate({"sig": 1.0}, now=0.0)
    m.evaluate({"sig": 0.0}, now=1.0)
    m.evaluate({"sig": 1.0}, now=4.0)    # flap: cancels the window
    m.evaluate({"sig": 0.0}, now=5.0)
    assert m.evaluate({"sig": 0.0}, now=8.0) == []
    tr = m.evaluate({"sig": 0.0}, now=10.5)
    assert [t["event"] for t in tr] == ["resolved"]
    assert [e[0] for e in events] == ["fired", "resolved"]


def test_missing_signal_holds_state():
    m, events = manager(threshold=0.0, for_s=0.0, clear_s=1.0)
    m.evaluate({"sig": 1.0}, now=0.0)
    assert m.evaluate({}, now=100.0) == []
    assert "r" in m.active()


def test_requires_gates_evaluation():
    rule = AlertRule("imb", "ratio", threshold=2.0, for_s=0.0,
                     clear_s=0.0, requires=("multi",))
    m = AlertManager(rules=[rule])
    assert m.evaluate({"ratio": 9.0, "multi": False}, now=0.0) == []
    tr = m.evaluate({"ratio": 9.0, "multi": True}, now=1.0)
    assert [t["event"] for t in tr] == ["fired"]


def test_builtin_rules_cover_the_catalog_set():
    assert {r.name for r in builtin_rules()} == set(
        obs.ALERT_BUILTIN_RULES)


def test_builtin_thresholds_from_env(monkeypatch):
    monkeypatch.setenv("GOL_ALERT_QUEUE_DEPTH", "7")
    monkeypatch.setenv("GOL_ALERT_STALENESS_MS", "1234")
    rules = {r.name: r for r in builtin_rules()}
    assert rules["queue-depth"].threshold == 7.0
    assert rules["staleness-ceiling"].threshold == 1234.0
    assert rules["member-death"].for_s == 0.0


def test_rules_from_env_json_grammar(monkeypatch):
    monkeypatch.setenv(
        "GOL_ALERT_RULES",
        '[{"name": "cups-floor", "signal": "cups", "op": "<", '
        '"threshold": 100.0, "for_s": 2, "clear_s": 3}]')
    rules = rules_from_env()
    assert len(rules) == 1
    r = rules[0]
    assert (r.name, r.signal, r.op, r.threshold, r.for_s, r.clear_s) \
        == ("cups-floor", "cups", "<", 100.0, 2.0, 3.0)


def test_rules_from_env_garbage_is_ignored(monkeypatch):
    monkeypatch.setenv("GOL_ALERT_RULES", "{not json")
    assert rules_from_env() == []


def test_bad_op_rejected():
    with pytest.raises(ValueError):
        AlertRule("x", "sig", op="!=")


def test_doc_shape():
    m, _ = manager(threshold=0.0, for_s=0.0)
    m.evaluate({"sig": 1.0}, now=0.0)
    doc = m.doc()
    assert doc["states"]["r"] == "firing"
    assert doc["rules"][0]["name"] == "r"
    assert "r" in doc["active"]


def test_alert_transitions_equal_gol_tpu():
    rng = np.random.default_rng(5)
    spec = dict(threshold=0.5, for_s=1.5, clear_s=2.5)
    mine = AlertManager(rules=[AlertRule("r", "sig", **spec),
                               AlertRule("q", "other", op="<", **spec)])
    ref = jalerts.AlertManager(rules=[
        jalerts.AlertRule("r", "sig", **spec),
        jalerts.AlertRule("q", "other", op="<", **spec)])
    for i in range(400):
        signals = {}
        if rng.random() < 0.9:
            signals["sig"] = float(rng.random())
        if rng.random() < 0.9:
            signals["other"] = float(rng.random())
        now = i * 0.37
        assert mine.evaluate(signals, now) == ref.evaluate(signals, now)
    assert mine.doc() == ref.doc()


# ====================================================== export and audit


def seed_gauges(res=4, q=2, cups=1.5e8, stale_p99=120.0):
    obs.RUNS_RESIDENT.set(res)
    obs.FLEET_QUEUE_DEPTH.set(q)
    obs.ENGINE_CUPS.set(cups)
    for qq in obs.SLO_QUANTILES:
        obs.FLEET_STALENESS_MS.labels(q=qq).set(
            stale_p99 if qq == "p99" else stale_p99 / 2)


def test_collect_families_reads_the_catalog():
    seed_gauges(res=7, q=3)
    fam = collect_families()
    assert fam["res"] == 7 and fam["q"] == 3
    assert fam["st"]["p99"] == 120.0
    assert fam["cups"] == pytest.approx(1.5e8)


def test_full_then_delta_then_commit_on_ack():
    seed_gauges(res=5, q=0)
    ex = SnapshotExporter()
    s1 = ex.build()
    assert s1["full"] == 1 and s1["m"]["res"] == 5
    assert ex.build().get("full") == 1  # unacked: still full
    ex.commit({"registered": True})
    s2 = ex.build()
    assert "full" not in s2 and s2["m"] == {}
    ex.commit({"registered": True})
    obs.RUNS_RESIDENT.set(6)
    s3 = ex.build()
    assert s3["m"].keys() == {"res"} and s3["m"]["res"] == 6


def test_resync_ack_voids_the_baseline():
    seed_gauges()
    ex = SnapshotExporter()
    ex.build()
    ex.commit({"registered": True, "snap_resync": True})
    assert ex.build().get("full") == 1


def test_snapshot_disabled_by_nonpositive_budget(monkeypatch):
    monkeypatch.setenv("GOL_FED_SNAPSHOT_MAX", "0")
    assert snapshot_budget() == 0
    assert SnapshotExporter().build() is None


def test_over_budget_drops_lowest_priority_families(monkeypatch):
    seed_gauges(res=9, q=1)
    buckets = ("64x64x8", "128x128x8", "256x256x16")
    for b in buckets:
        for qq in obs.SLO_QUANTILES:
            obs.FLEET_QUANTUM_MS.labels(bucket=b, q=qq).set(12.345)
    dropped0 = obs.FED_SNAPSHOT_DROPPED.labels(family="quantum").value
    monkeypatch.setenv("GOL_FED_SNAPSHOT_MAX", "60")
    try:
        snap = SnapshotExporter().build()
        assert snap is not None
        enc = json.dumps(snap, separators=(",", ":"), sort_keys=True)
        assert len(enc) <= 60
        assert snap["m"]["res"] == 9
        assert "qt" not in snap["m"]
        assert obs.FED_SNAPSHOT_DROPPED.labels(
            family="quantum").value > dropped0
    finally:
        for b in buckets:
            for qq in obs.SLO_QUANTILES:
                obs.FLEET_QUANTUM_MS.labels(bucket=b, q=qq).set(0.0)


def test_dropped_families_reship_on_the_next_beat(monkeypatch):
    seed_gauges(res=3, q=0, cups=1.25e8)
    ex = SnapshotExporter()
    monkeypatch.setenv("GOL_FED_SNAPSHOT_MAX", "40")
    s1 = ex.build()
    assert "cups" not in s1["m"]
    ex.commit({"registered": True})
    monkeypatch.setenv("GOL_FED_SNAPSHOT_MAX", "4096")
    s2 = ex.build()
    assert s2["m"]["cups"] == pytest.approx(1.25e8)


def test_events_ride_the_snapshot_with_commit_on_ack():
    seed_gauges()
    obs_audit.note("quarantine", run_id="r1", reason="step")
    obs_audit.note("migrate", run_id="r1", phase="quiesce")
    ex = SnapshotExporter()
    s1 = ex.build()
    assert [e["kind"] for e in s1["ev"]] == ["quarantine", "migrate"]
    assert len(ex.build()["ev"]) == 2  # beat lost: events re-ship
    ex.commit({"registered": True})
    assert obs_audit.peek_pending() == []
    assert len(obs_audit.recent()) >= 2


def make_telemetry(tmp_path=None):
    log = AuditLog(path=str(tmp_path) if tmp_path else None)
    return FleetTelemetry(tsdb=TSDB(max_series=64), audit_log=log)


def members_doc(live, dead=0):
    return {"members": [{"member_id": m, "state": "live"} for m in live]
            + [{"member_id": f"dead{i}", "state": "dead"}
               for i in range(dead)],
            "live": len(live), "dead": dead}


def test_rollups_are_exact_sums_and_max_staleness():
    t = make_telemetry()
    specs = {"m1": (2, 1, 1e6, 50.0), "m2": (3, 0, 2e6, 300.0),
             "m3": (5, 4, 3e6, 100.0)}
    for mid, (res, q, cups, p99) in specs.items():
        ack = {}
        t.ingest(mid, {"v": 1, "full": 1,
                       "m": {"res": res, "q": q, "cups": cups,
                             "st": {"p99": p99}}}, ack)
        assert "snap_resync" not in ack
    t.sweep(members_doc(["m1", "m2", "m3"]), now=1000.0)
    fleet = t.doc()["fleet"]
    assert fleet["runs_resident"] == 10
    assert fleet["queue_depth"] == 5
    assert fleet["cups"] == pytest.approx(6e6)
    assert fleet["staleness_p99_ms"] == 300.0
    assert fleet["members_reporting"] == 3
    assert fleet["imbalance_ratio"] == pytest.approx(5 / (10 / 3))
    assert obs.FED_AGG_RUNS_RESIDENT.value == 10
    assert obs.FED_AGG_STALENESS_MS.labels(q="p99").value == 300.0
    assert t.query("fleet.runs_resident")[-1]["last"] == 10.0
    assert t.query("member.runs_resident",
                   labels={"member": "m3"})[-1]["last"] == 5.0


def test_delta_without_base_requests_resync_and_merges():
    t = make_telemetry()
    ack = {}
    t.ingest("m1", {"v": 1, "m": {"res": 2}}, ack)
    assert ack.get("snap_resync") is True
    t.sweep(members_doc(["m1"]), now=0.0)
    assert t.doc()["fleet"]["runs_resident"] == 2


def test_dead_members_leave_the_rollup():
    t = make_telemetry()
    for mid, res in (("m1", 4), ("m2", 6)):
        t.ingest(mid, {"v": 1, "full": 1, "m": {"res": res}}, {})
    t.sweep(members_doc(["m1", "m2"]), now=0.0)
    assert t.doc()["fleet"]["runs_resident"] == 10
    t.sweep(members_doc(["m2"], dead=1), now=1.0)
    assert t.doc()["fleet"]["runs_resident"] == 6
    assert t.doc()["fleet"]["members_dead"] == 1


def test_member_death_signal_fires_alert_and_audits(tmp_path):
    t = make_telemetry(tmp_path)
    t.ingest("m1", {"v": 1, "full": 1, "m": {"res": 1}}, {})
    t.sweep(members_doc(["m1"]), now=0.0)
    assert "member-death" not in t.doc()["alerts"]["active"]
    tr = t.sweep(members_doc([], dead=1), now=1.0)
    assert {"rule": "member-death", "event": "fired", "value": 1.0} in tr
    assert "alert_fired" in [r["kind"] for r in t.audit_tail()]


def test_snapshot_events_land_in_the_durable_log(tmp_path):
    t = make_telemetry(tmp_path)
    t.ingest("m1", {"v": 1, "full": 1, "m": {},
                    "ev": [{"schema": obs_audit.SCHEMA, "seq": 1,
                            "ts": 123.0, "kind": "quarantine",
                            "run_id": "r9", "reason": "step"}]}, {})
    recs = t.audit_tail()
    assert len(recs) == 1
    rec = recs[0]
    assert rec["kind"] == "quarantine" and rec["member"] == "m1"
    assert rec["run_id"] == "r9" and rec["member_seq"] == 1


def test_audit_log_schema_seq_and_tail(tmp_path):
    log = AuditLog(path=str(tmp_path))
    for i in range(5):
        log.append("adopt", run_id=f"r{i}", member="m1")
    recs = log.tail()
    assert [r["seq"] for r in recs] == [1, 2, 3, 4, 5]
    assert all(r["schema"] == "gol-fleet-audit/1" for r in recs)
    assert log.tail(since_seq=3) == recs[3:]
    assert log.tail(limit=2) == recs[:2]
    with open(tmp_path / "audit.jsonl", encoding="utf-8") as f:
        assert [json.loads(line) for line in f] == recs
    log.close()


def test_audit_log_rotation_is_size_capped(tmp_path):
    log = AuditLog(path=str(tmp_path), max_bytes=4096, keep=2)
    for i in range(200):
        log.append("other", filler="x" * 64, i=i)
    files = sorted(os.listdir(tmp_path))
    assert "audit.jsonl" in files and "audit.jsonl.1" in files
    assert len(files) <= 3
    for f in files:
        assert os.path.getsize(tmp_path / f) <= 4096 + 256
    assert log.seq == 200
    assert log.tail(since_seq=195)[-1]["seq"] == 200
    log.close()


def test_audit_memory_only_mode_keeps_ring():
    log = AuditLog(path=None)
    log.append("member_join", member="m")
    assert log.tail()[0]["kind"] == "member_join"
    log.close()


# ====================================== GetTelemetry / GetAudit / GetUsage


_CLOCK_KEYS = frozenset({"ts", "attribution", "device_s", "dur_s",
                         "share_pct", "cups_headroom", "quantum_mean_ms",
                         "wire_out"})


def _unclocked(doc):
    if isinstance(doc, dict):
        return {k: _unclocked(v) for k, v in doc.items()
                if k not in _CLOCK_KEYS}
    if isinstance(doc, list):
        return [_unclocked(v) for v in doc]
    return doc


def _fleet_script(srv, client_cls, params_cls, chaos_mod, ckpt_dir,
                  monkeypatch):
    """Two seeded 64² runs; run b parks at turn 4, checkpoints, then a
    chaos popcount poison at turn 6 quarantines it (audited) and it is
    restored and driven to 14; b is destroyed. Returns the GetUsage
    reply for run a, GetTelemetry, and GetAudit since the script began."""
    monkeypatch.setenv("GOL_CKPT", ckpt_dir)
    srv.start_background()
    c = client_cls(f"127.0.0.1:{srv.port}", timeout=60.0)
    before = c.get_audit(0, 10 ** 6)
    s0 = before[-1]["seq"] if before else 0
    c.create_run(64, 64, board=_soup(64, 64, 1), run_id="a",
                 target_turn=8)
    c.create_run(64, 64, board=_soup(64, 64, 2), run_id="b",
                 target_turn=4)
    for rid, turn in (("a", 8), ("b", 4)):
        bound = c.for_run(rid)
        deadline = time.monotonic() + 60.0
        while bound.ping() < turn and time.monotonic() < deadline:
            time.sleep(0.02)
        assert bound.ping() == turn
    b = c.for_run("b")
    b.checkpoint_now()
    monkeypatch.setenv("GOL_CHAOS", "poison=b@6")
    assert chaos_mod.injector() is not None
    try:
        _, turn = b.server_distributor(params_cls(turns=10), None)
    finally:
        monkeypatch.delenv("GOL_CHAOS")
    assert turn == 14
    c.destroy_run("b")
    usage = c.for_run("a").get_usage()
    telemetry = c.get_telemetry()
    audit = c.get_audit(s0, 1000)
    for rec in audit:
        rec["seq"] -= s0
    return usage, telemetry, audit


def test_telemetry_rpcs_answer_as_gol_tpu_for_one_fleet_script(
        monkeypatch, tmp_path):
    monkeypatch.setenv("GOL_USAGE_FLUSH_S", "0")
    monkeypatch.setenv("GOL_QUARANTINE_BACKOFF", "0.05")
    obs_usage.METER.reset()
    jusage.METER.reset()
    answers = []
    for name, srv, client_cls, params_cls, chaos_mod in (
            ("jax", JServer(port=0, host="127.0.0.1",
                            engine=JFleet(bucket_sizes=(64,),
                                          chunk_turns=2, slot_base=8)),
             JRemote, gol_tpu.Params, jchaos),
            ("torch", EngineServer(
                port=0, host="127.0.0.1",
                engine=FleetEngine(bucket_sizes=(64,), chunk_turns=2,
                                   slot_base=8, device="cpu")),
             RemoteEngine, gol_tpu_torch.Params, tchaos)):
        try:
            answers.append(_fleet_script(
                srv, client_cls, params_cls, chaos_mod,
                str(tmp_path / name), monkeypatch))
        finally:
            srv.engine.kill_prog()
            _stop_server(srv)
    (ju, jt, ja), (tu, tt, ta) = answers
    # GetUsage: the meter's doc and run a's live record.
    assert _unclocked(tu) == _unclocked(ju)
    assert tu["run"]["turns"] == 8 and tu["retired_runs"] == 1
    # GetAudit: the quarantine record, field for field.
    assert _unclocked(ta) == _unclocked(ja)
    assert [r["kind"] for r in ta] == ["quarantine"]
    assert ta[0]["run_id"] == "b" and ta[0]["reason"] == "popcount"
    # GetTelemetry: the document's keys, and the script's families.
    assert set(tt) == set(jt)
    for k in ("res", "q"):
        assert tt["families"][k] == jt["families"][k]
    assert set(tt["families"]["use"]) == set(jt["families"]["use"])
    for k in ("adm", "tracked"):
        assert tt["families"]["use"][k] == jt["families"]["use"][k]
    assert {k for k in tt["families"]["qt"] if k.startswith("64x64|")} \
        == {k for k in jt["families"]["qt"] if k.startswith("64x64|")}
    assert tt["pending_events"] == jt["pending_events"]


def test_get_telemetry_is_the_local_doc(monkeypatch):
    srv = EngineServer(port=0, host="127.0.0.1",
                       engine=Engine(device="cpu"))
    srv.start_background()
    try:
        seed_gauges(res=2, q=1)
        doc = RemoteEngine(f"127.0.0.1:{srv.port}").get_telemetry()
        local = obs_export.local_doc()
        assert set(doc) == set(local) == {
            "families", "pending_events", "snapshot_max", "ts"}
        assert doc["families"]["res"] == 2 and doc["families"]["q"] == 1
        obs_audit.note("quarantine", run_id="r7", reason="test")
        recs = RemoteEngine(f"127.0.0.1:{srv.port}").get_audit(0, 10 ** 6)
        assert recs[-1]["run_id"] == "r7"
        assert RemoteEngine(
            f"127.0.0.1:{srv.port}").get_telemetry()["pending_events"] >= 1
    finally:
        seed_gauges(res=0, q=0, cups=0.0, stale_p99=0.0)
        srv.shutdown()


# ===================================================== devstats and prof


def test_memory_snapshot_graceful_none_on_cpu():
    summary = devstats.poll_device_memory()
    assert summary["supported"] is False
    assert summary["live_bytes"] is None and summary["peak_bytes"] is None
    assert summary["device_kind"] == "cpu" and summary["devices"] == 1
    assert obs.DEV_MEM_SUPPORTED.value == 0.0
    assert obs.DEV_DEVICES.value == 1.0


def test_healthz_fields_read_the_cache():
    devstats.poll_device_memory()
    fields = devstats.healthz_fields()
    assert set(fields) == {"device_kind", "live_bytes", "compile_count",
                           "mesh"}
    assert fields["device_kind"] == "cpu"
    assert fields["live_bytes"] is None
    assert fields["compile_count"] == 0
    assert fields["mesh"] == {}


def test_healthz_doc_carries_device_fields():
    from gol_tpu_torch.obs.http import healthz_doc

    devstats.poll_device_memory()
    doc = healthz_doc()
    for field in ("run_id", "turn", "uptime_s", "runs", "slo",
                  "device_kind", "live_bytes", "compile_count"):
        assert field in doc, field


def test_note_signature_once_per_key():
    before = obs.COMPILE_STEP_SIGNATURES.value
    key = ("test-repr", (int(time.time_ns()),), "uint32", (1,), "B3/S23")
    assert devstats.note_signature(key) is True
    assert devstats.note_signature(key) is False
    assert obs.COMPILE_STEP_SIGNATURES.value == before + 1


def test_engine_signature_once_per_configuration():
    """The single-run engine notes a step signature per new (repr,
    shape, dtype, rule, fuse) at submit, as the JAX engine does."""
    eng = Engine(device="cpu")
    before = obs.COMPILE_STEP_SIGNATURES.value
    # Sizes no other test runs: packed (72, 3) words, then u8 (72, 88).
    for w, want in ((96, 1), (96, 1), (88, 2), (88, 2)):
        eng.server_distributor(
            Params(threads=1, image_width=w, image_height=72, turns=2),
            _board(72, w))
        assert obs.COMPILE_STEP_SIGNATURES.value == before + want


def test_conv_run_turns_notes_its_signature():
    from gol_tpu_torch.models import parse_rule
    from gol_tpu_torch.ops import conv

    rule = parse_rule("R2,C0,M1,S3..5,B3..4,NM")
    cells = np.zeros((40, 44), np.uint8)
    before = obs.COMPILE_STEP_SIGNATURES.value
    conv.run_turns(cells, 1, rule, tier="conv")
    conv.run_turns(cells, 3, rule, tier="conv")
    assert obs.COMPILE_STEP_SIGNATURES.value == before + 1
    assert not devstats.note_signature(
        ("conv", "conv", (40, 44), "uint8", rule.rulestring))


def test_engine_fusion_telemetry(monkeypatch):
    monkeypatch.setenv("GOL_FUSE_K", "4")
    d0 = obs.FUSED_DISPATCHES.labels(tier="engine").value
    c0 = obs.ENGINE_CHUNKS_TOTAL.value
    Engine(device="cpu").server_distributor(
        Params(threads=1, image_width=64, image_height=64, turns=40),
        _board(64, 64))
    assert obs.FUSE_K.value == 4.0 and devstats.fuse_field() == 4
    chunks = obs.ENGINE_CHUNKS_TOTAL.value - c0
    assert chunks > 0
    assert obs.FUSED_DISPATCHES.labels(tier="engine").value - d0 == chunks


def test_profile_request_requires_directory():
    with pytest.raises(obs_prof.ProfileUnavailable):
        obs_prof.PROFILER.request(turns=8)


def test_profile_request_single_slot(tmp_path):
    obs_prof.PROFILER.configure(str(tmp_path))
    armed = obs_prof.PROFILER.request(turns=8, source="test")
    assert armed["armed"] is True and armed["turns"] == 8
    assert obs.PROFILE_ARMED.value == 1.0
    with pytest.raises(obs_prof.ProfileUnavailable):
        obs_prof.PROFILER.request(turns=8)
    assert obs_prof.PROFILER.take().turns == 8
    assert obs_prof.PROFILER.take() is None


def _pairs_exact(pairs, seed_board):
    """Every published (alive, turn) pair equals the numpy oracle's."""
    for alive, turn in pairs:
        want = run_turns_np((seed_board != 0).astype(np.uint8), turn)
        assert alive == int(want.sum()), (alive, turn)


@pytest.mark.parametrize("turns", [4, 24])
def test_profile_capture_through_engine_keeps_pairs_exact(tmp_path,
                                                          turns):
    """An armed request makes the next run capture N turns: a Chrome
    trace lands in the directory, the turns count as traced chunks, the
    controller records an ok capture, and every (alive, turn) pair the
    engine publishes around and inside the capture is exact."""
    prof_dir = str(tmp_path / "prof")
    obs_prof.PROFILER.configure(prof_dir)
    obs_prof.PROFILER.request(turns=turns, source="test")
    ok0 = obs.PROFILE_CAPTURES.labels(status="ok").value
    traced0 = obs.ENGINE_TRACED_CHUNKS_TOTAL.value
    world = _soup(64, 64, 9)
    eng = Engine(device="cpu")
    pairs = []
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            if eng.stats()["board"] is not None:  # submitted
                pairs.append(eng.alive_count())
            time.sleep(0.001)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        _, turn = eng.server_distributor(
            Params(threads=1, image_width=64, image_height=64, turns=40),
            world)
    finally:
        stop.set()
        poller.join(timeout=10)
    assert turn == 40
    pairs.append(eng.alive_count())
    _pairs_exact(set(pairs), world)
    assert obs.PROFILE_CAPTURES.labels(status="ok").value == ok0 + 1
    assert obs.ENGINE_TRACED_CHUNKS_TOTAL.value > traced0
    assert obs.PROFILE_ARMED.value == 0.0
    status = obs_prof.PROFILER.status()
    assert status["last"]["status"] == "ok"
    assert status["last"]["turns"] == turns
    traces = glob.glob(os.path.join(prof_dir, "*.trace.json"))
    assert traces and status["last"]["artifacts"] == sorted(traces)
    with open(traces[0], encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::")
               for e in events)


def test_profile_env_contract(tmp_path, monkeypatch):
    prof_dir = str(tmp_path / "envprof")
    monkeypatch.setenv(obs_prof.PROFILE_DIR_ENV, prof_dir)
    monkeypatch.setenv(obs_prof.PROFILE_TURNS_ENV, "4")
    ok0 = obs.PROFILE_CAPTURES.labels(status="ok").value
    Engine(device="cpu").server_distributor(
        Params(threads=1, image_width=64, image_height=64, turns=8),
        _board(64, 64))
    assert obs.PROFILE_CAPTURES.labels(status="ok").value == ok0 + 1
    assert glob.glob(os.path.join(prof_dir, "*.trace.json"))


def test_profile_http_endpoint(tmp_path):
    from gol_tpu_torch.obs.http import start_metrics_server

    srv = start_metrics_server(0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        req = urllib.request.Request(base + "/profile", data=b"",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 409
        obs_prof.PROFILER.configure(str(tmp_path))
        body = json.loads(urllib.request.urlopen(
            urllib.request.Request(base + "/profile?turns=16", data=b"",
                                   method="POST"), timeout=10).read())
        assert body["armed"] is True and body["turns"] == 16
        status = json.loads(urllib.request.urlopen(
            base + "/profile", timeout=10).read())
        assert status["armed"] is True and status["pending_turns"] == 16
    finally:
        srv.close()


def test_profile_wire_method_in_process(tmp_path):
    """Profile over the wire: status when idle, arm, a refused double
    arm, a run that captures, the trace in the server's directory."""
    prof_dir = str(tmp_path / "prof")
    obs_prof.PROFILER.configure(prof_dir)
    srv = EngineServer(port=0, host="127.0.0.1",
                       engine=Engine(device="cpu"))
    srv.start_background()
    try:
        cli = RemoteEngine(f"127.0.0.1:{srv.port}", timeout=60.0)
        status = cli.profile()
        assert status["status"]["dir"] == os.path.abspath(prof_dir)
        assert status["status"]["armed"] is False
        armed = cli.profile(4)
        assert (armed["armed"], armed["turns"], armed["dir"]) == (
            True, 4, os.path.abspath(prof_dir))
        with pytest.raises(RuntimeError, match="already armed"):
            cli.profile(4)
        _, turn = cli.server_distributor(
            Params(threads=1, image_width=64, image_height=64, turns=16),
            _board(64, 64))
        assert turn == 16
        last = cli.profile()["status"]["last"]
        assert last["status"] == "ok" and last["source"] == "wire"
        assert glob.glob(os.path.join(prof_dir, "*.trace.json"))
    finally:
        srv.shutdown()


def test_jax_client_profiles_the_port_server(tmp_path):
    obs_prof.PROFILER.configure(str(tmp_path))
    srv = EngineServer(port=0, host="127.0.0.1",
                       engine=Engine(device="cpu"))
    srv.start_background()
    try:
        cli = JRemote(f"127.0.0.1:{srv.port}", timeout=60.0)
        assert cli.profile(8)["armed"] is True
        assert cli.profile()["status"]["pending_turns"] == 8
        assert cli.get_usage()["k"] >= 1
        assert isinstance(cli.get_audit(), list)
        assert "families" in cli.get_telemetry()
    finally:
        srv.shutdown()


# ========================================================== CLI and HTTP


def test_cli_observability_flags(tmp_path, capsys, monkeypatch):
    from gol_tpu_torch.main import main
    from gol_tpu_torch.obs.http import last_server

    prof_dir = tmp_path / "prof"
    trace_dir = tmp_path / "trace"
    report = tmp_path / "run.jsonl"
    spans = tmp_path / "spans.json"
    monkeypatch.chdir(REPO)
    try:
        rc = main(["-w", "64", "-h", "64", "--turns", "100", "--headless",
                   "--device", "cpu", "--profile-dir", str(prof_dir),
                   "--profile-turns", "8", "--trace", str(trace_dir),
                   "--run-report", str(report), "--trace-spans",
                   str(spans), "--metrics-port", "0"])
    finally:
        for k in ("GOL_PROFILE_DIR", "GOL_PROFILE_TURNS", "GOL_TRACE",
                  "GOL_RUN_REPORT", "GOL_TRACE_SPANS"):
            os.environ.pop(k, None)
    msrv = last_server()
    assert json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{msrv.port}/healthz", timeout=10).read())[
            "turn"] == 100
    msrv.close()
    assert rc == 0
    assert "64x64x100.pgm output complete" in capsys.readouterr().out
    assert len(glob.glob(str(prof_dir / "*.trace.json"))) == 1
    assert obs_prof.PROFILER.status()["last"]["turns"] == 8
    recs = list(read_report(str(report)))
    for rec in recs:
        validate_record(rec)
    events = [r["event"] for r in recs]
    assert events[0] == "run_start" and events[-1] == "run_end"
    assert sum(r["turns"] for r in recs
               if r["event"] in ("chunk", "traced_chunk")) == 100
    assert recs[-1]["traced_chunks"] == events.count("traced_chunk")
    with open(spans, encoding="utf-8") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "engine.run" in names


def test_cli_trace_writes_one_chunk_trace(tmp_path, monkeypatch):
    from gol_tpu_torch.main import main

    monkeypatch.chdir(REPO)
    try:
        assert main(["-w", "64", "-h", "64", "--turns", "100",
                     "--headless", "--device", "cpu", "--trace",
                     str(tmp_path)]) == 0
    finally:
        os.environ.pop("GOL_TRACE", None)
    assert len(glob.glob(str(tmp_path / "*.trace.json"))) == 1


@pytest.mark.timeout(300)
def test_server_metrics_port_and_profile_dir(tmp_path):
    """`python -m gol_tpu_torch.server --metrics-port 0 --profile-dir`:
    /metrics serves the broadcast families, /healthz the device fields,
    /profile the controller; the Profile method writes its trace into
    the configured directory."""
    prof_dir = tmp_path / "prof"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["GOL_SERVER_EXIT_ON_KILL"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "gol_tpu_torch.server", "--port", "0",
         "--device", "cpu", "--metrics-port", "0", "--profile-dir",
         str(prof_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env, cwd=REPO)
    try:
        lines = queue.Queue()
        threading.Thread(target=lambda: [lines.put(ln)
                                         for ln in proc.stdout],
                         daemon=True).start()
        mport = port = None
        deadline = time.monotonic() + 120.0
        while port is None and time.monotonic() < deadline:
            line = lines.get(timeout=120)
            m = re.search(r"metrics on http://127.0.0.1:(\d+)/", line)
            if m:
                mport = int(m.group(1))
            m = re.search(r"serving on :(\d+)", line)
            if m:
                port = int(m.group(1))
        assert mport and port
        base = f"http://127.0.0.1:{mport}"
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        for fam in ("gol_bcast_frames_total", "gol_bcast_fanout_ms",
                    "gol_gateway_connections", "gol_profile_armed",
                    "gol_dev_mem_supported"):
            assert fam in text, fam
        health = json.loads(urllib.request.urlopen(
            base + "/healthz", timeout=10).read())
        assert health["compile_count"] == 0 and "runs" in health
        cli = RemoteEngine(f"127.0.0.1:{port}", timeout=60.0)
        assert cli.profile(4)["dir"] == str(prof_dir)
        status = json.loads(urllib.request.urlopen(
            base + "/profile", timeout=10).read())
        assert status["pending_turns"] == 4
        _, turn = cli.server_distributor(
            Params(threads=1, image_width=64, image_height=64, turns=8),
            _board(64, 64))
        assert turn == 8
        assert cli.profile()["status"]["last"]["status"] == "ok"
        assert glob.glob(str(prof_dir / "*.trace.json"))
        cli.kill_prog()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_telemetry_modules_stand_alone():
    code = (
        "import sys\n"
        "import gol_tpu_torch.broadcast, gol_tpu_torch.gateway\n"
        "import gol_tpu_torch.obs.prof, gol_tpu_torch.obs.http\n"
        "import gol_tpu_torch.obs.export\n"
        "print([m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'gol_tpu')])\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env,
                         cwd=tempfile.gettempdir())
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_gol_tpu_thread_outlives_this_file():
    """Every `gol_tpu` server, hub, gateway and engine thread this file
    started has ended: a leftover would move the JAX package's
    process-global counters under a JAX test that shares this worker."""
    deadline = time.monotonic() + 10.0
    while _gol_tpu_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _gol_tpu_threads() == []
