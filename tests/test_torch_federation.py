"""The port's federation tier (`gol_tpu_torch/federation/`: `hrw`,
`registry`, `agent`, `router`), its /healthz keys and the flight
recorder's crash trigger, held against `gol_tpu`'s:

  * counterparts of `tests/test_federation.py`: HRW properties, router
    placement and dedupe, dedupe across a failover and across a PinRun
    redirect, pin refusal, a "moved:" reply never pinned in the dedupe
    window, member listing (the router against stub members);
  * HRW identity: `rank` and `place` equal `gol_tpu.federation.hrw`'s
    for 1000 seeded run ids over member sets of 1-5;
  * the registry's sweep, census and rejoin; each package's agent
    against the other's router;
  * /healthz's `federation` and `telemetry` keys and GetTelemetry's
    `series` against `gol_tpu`'s router fed the same snapshots;
  * failover end to end: three port fleet servers with agents, one
    stops, the router adopts its runs onto the survivors from the
    shared checkpoint root, every board equal to the numpy oracle;
  * `python -m gol_tpu_torch.federation.router` and a server subprocess
    started with `--federate` / `--advertise`;
  * `flight.crash` and `validate_dump` on the port's dump, and
    `gol_tpu`'s `validate_dump` accepting it.

Tolerance: none."""

from __future__ import annotations

import collections
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from gol_tpu.federation import hrw as jhrw
from gol_tpu.federation.agent import FederationAgent as JAgent
from gol_tpu.federation.router import FederationRouter as JRouter
from gol_tpu.obs import audit as jaudit
from gol_tpu.obs import catalog as jobs
from gol_tpu.obs import flight as jflight
from gol_tpu.obs import http as jhttp
from gol_tpu.ops.reference import run_turns_np

from gol_tpu_torch import wire
from gol_tpu_torch.client import RemoteEngine
from gol_tpu_torch.federation import hrw
from gol_tpu_torch.federation.agent import FederationAgent
from gol_tpu_torch.federation.registry import MemberRegistry
from gol_tpu_torch.federation.router import FederationRouter
from gol_tpu_torch.fleet import FleetEngine
from gol_tpu_torch.obs import audit as taudit
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import flight
from gol_tpu_torch.obs import http as obs_http
from gol_tpu_torch.server import EngineServer

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
CORPUS = [f"run-{i:03d}" for i in range(200)]
MEMBERS3 = ["10.0.0.1:8799", "10.0.0.2:8799", "10.0.0.3:8799"]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("GOL_FLEET_BUCKETS", "GOL_FLEET_CHUNK", "GOL_FLEET_SLOT_BASE",
              "GOL_FUSE_K", "GOL_CKPT", "GOL_CHAOS", "GOL_JOURNAL",
              "GOL_FLIGHT", "GOL_AUDIT_DIR", "GOL_FED_SNAPSHOT_MAX"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")


@pytest.fixture(autouse=True)
def _audit_queues_as_found():
    """A migration notes audit events in its coordinator's process-wide
    queue (either package's), which only a federation agent drains: leave
    both queues as this test found them, for the files that share the
    worker."""
    saved = []
    for mod in (jaudit, taudit):
        with mod._events_lock:
            saved.append(list(mod._pending))
    yield
    for mod, pending in zip((jaudit, taudit), saved):
        with mod._events_lock:
            mod._pending.clear()
            mod._pending.extend(pending)


def _wait(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# --------------------------------------------------------------- HRW


def test_hrw_place_deterministic_and_order_free():
    for rid in CORPUS[:20]:
        owner = hrw.place(rid, MEMBERS3)
        assert owner in MEMBERS3
        assert hrw.place(rid, list(reversed(MEMBERS3))) == owner
        assert hrw.rank(rid, MEMBERS3)[0] == owner


def test_hrw_removal_moves_only_the_dead_members_runs():
    before = {rid: hrw.place(rid, MEMBERS3) for rid in CORPUS}
    dead = MEMBERS3[1]
    survivors = [m for m in MEMBERS3 if m != dead]
    after = {rid: hrw.place(rid, survivors) for rid in CORPUS}
    moved = {rid for rid in CORPUS if after[rid] != before[rid]}
    assert moved == {rid for rid in CORPUS if before[rid] == dead}
    assert len(set(before.values())) == 3


def test_hrw_addition_moves_only_about_one_in_n_plus_one():
    before = {rid: hrw.place(rid, MEMBERS3) for rid in CORPUS}
    grown = MEMBERS3 + ["10.0.0.4:8799"]
    after = {rid: hrw.place(rid, grown) for rid in CORPUS}
    moved = {rid for rid in CORPUS if after[rid] != before[rid]}
    assert all(after[rid] == "10.0.0.4:8799" for rid in moved)
    assert 0.10 <= len(moved) / len(CORPUS) <= 0.45


def test_hrw_empty_and_single_member():
    assert hrw.place("r", []) is None
    assert hrw.place("r", ["only:1"]) == "only:1"
    assert hrw.rank("r", []) == []


@pytest.mark.parametrize("n_members", [1, 2, 3, 4, 5])
def test_hrw_identity_with_gol_tpu(n_members):
    """Both packages' routers place every run on the same member: scores,
    ranks and placements equal `gol_tpu`'s for 1000 seeded run ids."""
    rng = np.random.default_rng(100 + n_members)
    members = [f"10.{rng.integers(256)}.{rng.integers(256)}.{i}:"
               f"{rng.integers(1024, 65536)}" for i in range(n_members)]
    for _ in range(1000):
        rid = "".join(rng.choice(list("abcdef0123456789-"), size=12))
        assert hrw.rank(rid, members) == jhrw.rank(rid, members)
        assert hrw.place(rid, members) == jhrw.place(rid, members)
        m = members[0]
        assert hrw.score(m, rid) == jhrw.score(m, rid)


# ---------------------------------------------------------- registry


def test_registry_sweep_declares_death_and_rejoin(monkeypatch):
    monkeypatch.setenv("GOL_FED_HEARTBEAT", "0.05")
    monkeypatch.setenv("GOL_FED_DEAD_AFTER", "0.2")
    reg = MemberRegistry()
    f0 = obs.FED_FAILOVERS.value
    ack = reg.register("a:1", "a:1", 1, capacity=1, mesh={"devices": 1})
    assert ack == {"registered": True, "accepted": True, "joined": True,
                   "rejoined": False, "live": 1}
    reg.register("b:2", "b:2", 1)
    # A sequence that does not advance is ignored.
    assert reg.register("a:1", "a:1", 1)["accepted"] is False
    t0 = time.monotonic()
    reg.register("a:1", "a:1", 2)
    dead = reg.sweep(now=t0 + 0.1)
    assert dead == []
    dead = reg.sweep(now=time.monotonic() + 1.0)
    assert {m.member_id for m in dead} == {"a:1", "b:2"}
    assert obs.FED_FAILOVERS.value == f0 + 2
    doc = reg.members_doc()
    assert (doc["live"], doc["dead"]) == (0, 2)
    assert obs.FED_MEMBERS.labels(state="dead").value == 2
    # A dead member that registers again is live with a fresh epoch.
    back = reg.register("a:1", "a:1", 1)
    assert back["rejoined"] and back["accepted"] and back["live"] == 1
    assert reg.get("a:1").capacity == 1
    assert reg.get("a:1").mesh == {"devices": 1}


# ------------------------------------------------- router stub fleet


class StubMember:
    """A wire-protocol TCP server that answers everything ok and counts
    method invocations — a member as the ROUTER sees one."""

    def __init__(self):
        self.calls = collections.Counter()
        self.moved_to = None
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(16)
        self.address = f"127.0.0.1:{self._sock.getsockname()[1]}"
        self._closed = False
        self._thread = threading.Thread(target=self._accept, daemon=True)
        self._thread.start()

    def _accept(self):
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            header, _ = wire.recv_msg(conn)
            method = str(header.get("method"))
            self.calls[method] += 1
            rid = header.get("run_id", "r")
            if self.moved_to and header.get("run_id"):
                wire.send_msg(conn, {
                    "error": f"moved: run {rid} migrated to "
                             f"{self.moved_to}"})
            elif method in ("CreateRun", "AdoptRun"):
                wire.send_msg(conn, {
                    "ok": True,
                    "run": {"run_id": rid, "state": "running",
                            "turn": 0, "served_by": self.address}})
            elif method == "ListRuns":
                wire.send_msg(conn, {"ok": True, "runs": []})
            else:
                wire.send_msg(conn, {"ok": True, "turn": 0})
        except (ConnectionError, OSError, wire.WireProtocolError):
            pass
        finally:
            conn.close()

    def close(self):
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._thread.join(timeout=2)


def _stop(srv) -> None:
    """Shut a router of either package down and wake its accept thread
    (`gol_tpu`'s shutdown closes the socket, which does not wake a
    thread blocked in accept(); one connection does)."""
    srv.shutdown()
    try:
        socket.create_connection(("127.0.0.1", srv.port),
                                 timeout=1.0).close()
    except OSError:
        pass


def _call(port, header):
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.settimeout(10)
        wire.send_msg(s, header)
        resp, _ = wire.recv_msg(s)
    return resp


@pytest.fixture()
def cluster(monkeypatch):
    """The port's router + two stub members with a test-driven beat."""
    monkeypatch.setenv("GOL_FED_HEARTBEAT", "0.1")
    # Ten beats of slack: a loaded host must not lapse a live stub.
    monkeypatch.setenv("GOL_FED_DEAD_AFTER", "1.0")
    monkeypatch.setenv("GOL_FED_REROUTE", "5")
    stubs = [StubMember(), StubMember()]
    router = FederationRouter(port=0).start_background()
    beating = {s.address: True for s in stubs}
    stop = threading.Event()

    def beat():
        seq = 0
        while not stop.is_set():
            seq += 1
            for s in stubs:
                if beating[s.address]:
                    router.registry.register(s.address, s.address, seq)
            stop.wait(0.1)

    t = threading.Thread(target=beat, daemon=True)
    t.start()
    _wait(lambda: router.registry.members_doc()["live"] == 2,
          what="both stubs live")
    try:
        yield router, stubs, beating
    finally:
        stop.set()
        t.join(timeout=2)
        router.shutdown()
        for s in stubs:
            s.close()


def test_router_places_on_hrw_owner_and_dedupes(cluster):
    router, stubs, _ = cluster
    by_addr = {s.address: s for s in stubs}
    owner = by_addr[hrw.place("dup1", [s.address for s in stubs])]
    header = {"method": "CreateRun", "run_id": "dup1", "h": 64,
              "w": 64, "ckpt_every": 4, "req_id": "req-dup1"}
    first = _call(router.port, dict(header))
    assert first["ok"] and first["run"]["served_by"] == owner.address
    assert owner.calls["CreateRun"] == 1
    second = _call(router.port, dict(header))
    assert second == first
    assert owner.calls["CreateRun"] == 1
    # A CreateRun without an id gets one from the router (HRW needs it).
    fresh = _call(router.port, {"method": "CreateRun", "h": 64, "w": 64})
    rid = fresh["run"]["run_id"]
    assert re.fullmatch(r"[0-9a-f]{32}", rid)
    assert fresh["run"]["served_by"] == hrw.place(rid, list(by_addr))


def test_router_dedupe_survives_member_failover(cluster):
    """A retried mutate whose first attempt committed on a member that
    DIED in between is answered from the router's recorded reply."""
    router, stubs, beating = cluster
    by_addr = {s.address: s for s in stubs}
    owner = by_addr[hrw.place("fo1", [s.address for s in stubs])]
    survivor = next(s for s in stubs if s is not owner)
    header = {"method": "CreateRun", "run_id": "fo1", "h": 64,
              "w": 64, "ckpt_every": 4, "req_id": "req-fo1"}
    first = _call(router.port, dict(header))
    assert first["run"]["served_by"] == owner.address
    _wait(lambda: "fo1" in router._placements, what="placement")
    f0 = obs.FED_FAILOVERS.value

    beating[owner.address] = False
    owner.close()
    _wait(lambda: survivor.calls["AdoptRun"] >= 1, timeout=10,
          what="adoption on the survivor")
    assert survivor.calls["AdoptRun"] == 1
    assert router.registry.get(owner.address).state == "dead"
    assert obs.FED_FAILOVERS.value == f0 + 1
    assert router._placements["fo1"]["member"] == survivor.address
    kinds = [r["kind"] for r in router.audit_log.tail(0, 100)]
    assert "member_death" in kinds and "adopt" in kinds

    retried = _call(router.port, dict(header))
    assert retried == first
    assert survivor.calls["CreateRun"] == 0
    fresh = _call(router.port, {"method": "CreateRun", "run_id": "fo2",
                                "h": 64, "w": 64, "ckpt_every": 0,
                                "req_id": "req-fo2"})
    assert fresh["run"]["served_by"] == survivor.address


def test_router_dedupe_survives_redirect(cluster):
    router, stubs, _ = cluster
    by_addr = {s.address: s for s in stubs}
    owner = by_addr[hrw.place("mig1", [s.address for s in stubs])]
    target = next(s for s in stubs if s is not owner)
    header = {"method": "CreateRun", "run_id": "mig1", "h": 64,
              "w": 64, "ckpt_every": 4, "req_id": "req-mig1"}
    first = _call(router.port, dict(header))
    assert first["ok"] and first["run"]["served_by"] == owner.address
    _wait(lambda: "mig1" in router._placements, what="placement")

    pin = _call(router.port, {"method": "PinRun", "run_id": "mig1",
                              "member_id": target.address,
                              "req_id": "req-mig1-pin"})
    assert pin["ok"] and pin["member"] == target.address
    assert pin["prev"] == owner.address

    retried = _call(router.port, dict(header))
    assert retried == first
    assert target.calls["CreateRun"] == 0
    fresh = _call(router.port, {"method": "Ping", "run_id": "mig1"})
    assert fresh["ok"]
    assert target.calls["Ping"] == 1 and owner.calls["Ping"] == 0


def test_router_pin_refuses_unknown_member(cluster):
    router, _, _ = cluster
    resp = _call(router.port, {"method": "PinRun", "run_id": "x1",
                               "member_id": "10.9.9.9:1"})
    assert "not a live" in resp.get("error", "")
    resp = _call(router.port, {"method": "PinRun", "run_id": "x1"})
    assert "requires run_id and member_id" in resp["error"]


def test_router_moved_reply_not_pinned_in_dedupe(cluster):
    router, stubs, _ = cluster
    by_addr = {s.address: s for s in stubs}
    owner = by_addr[hrw.place("mv1", [s.address for s in stubs])]
    target = next(s for s in stubs if s is not owner)
    pin_at = {"method": "PinRun", "run_id": "mv1"}
    assert _call(router.port, {**pin_at, "member_id": owner.address})["ok"]
    owner.moved_to = target.address
    header = {"method": "CFput", "run_id": "mv1", "flag": 2,
              "req_id": "req-mv1-cf"}
    first = _call(router.port, dict(header))
    assert str(first.get("error", "")).startswith("moved:")
    assert _call(router.port, {**pin_at,
                               "member_id": target.address})["ok"]
    retried = _call(router.port, dict(header))
    assert retried.get("ok")
    assert target.calls["CFput"] == 1


def test_router_lists_and_registers_members(cluster):
    router, stubs, _ = cluster
    resp = _call(router.port, {"method": "ListRuns"})
    assert resp["ok"] and resp["runs"] == []
    doc = router.registry.members_doc()
    assert doc["live"] == 2 and doc["dead"] == 0
    assert {m["member_id"] for m in doc["members"]} \
        == {s.address for s in stubs}


# ------------------------------------------------ agents across packages


@pytest.mark.parametrize("agent_pkg,router_pkg", [
    ("torch", "torch"), ("torch", "jax"), ("jax", "torch"),
    ("jax", "jax")])
def test_agent_registers_with_either_router(agent_pkg, router_pkg,
                                            monkeypatch):
    """Each package's heartbeat registers with each package's router: the
    member appears live with its capacity and geometry, and its snapshot
    reaches the router's aggregator."""
    monkeypatch.setenv("GOL_FED_HEARTBEAT", "0.05")
    router = (FederationRouter if router_pkg == "torch"
              else JRouter)(port=0).start_background()
    ingested = (obs if router_pkg == "torch"
                else jobs).FED_SNAPSHOT_INGESTED
    n0 = ingested.value
    agent = (FederationAgent if agent_pkg == "torch" else JAgent)(
        f"127.0.0.1:{router.port}", "127.0.0.1:45678", capacity=1,
        mesh={"devices": 1})
    try:
        resp = agent.beat_once()
        assert resp["registered"] and resp["joined"]
        assert resp["live"] == 1
        agent.start()
        _wait(lambda: router.registry.get("127.0.0.1:45678").hb_seq >= 3,
              what="beats accepted")
        m = router.registry.members_doc()["members"][0]
        assert (m["member_id"], m["capacity"], m["mesh"], m["state"]) == \
            ("127.0.0.1:45678", 1, {"devices": 1}, "live")
        assert ingested.value > n0
    finally:
        agent.stop()
        _stop(router)


def test_snapshot_failure_never_costs_the_beat(monkeypatch):
    router = FederationRouter(port=0).start_background()
    agent = FederationAgent(f"127.0.0.1:{router.port}", "127.0.0.1:45679")

    def boom():
        raise RuntimeError("snapshot exploded")

    monkeypatch.setattr(agent._exporter, "build", boom)
    try:
        resp = agent.beat_once()
        assert resp["registered"] and resp["accepted"]
        assert router.registry.get("127.0.0.1:45679") is not None
    finally:
        router.shutdown()
    # An unreachable router is a dropped beat, not an error.
    assert agent.beat_once() is None


# ------------------------------------- /healthz and GetTelemetry series


def _snap(res, q, cups, full):
    snap = {"v": 1, "m": {"res": res, "q": q, "cups": cups,
                          "st": {"p50": 1.0, "p95": 2.0, "p99": 3.0 + res},
                          "slo": 0}}
    if full:
        snap["full"] = 1
    return snap


def test_healthz_and_series_answer_as_gol_tpu_for_the_same_snapshots():
    """Both packages' routers ingest the same heartbeat snapshots over the
    wire and sweep at the same instants: /healthz's federation and
    telemetry keys and GetTelemetry (with and without `series`) agree."""
    routers = {"torch": FederationRouter(port=0), "jax": JRouter(port=0)}
    threads = []
    for r in routers.values():
        t = threading.Thread(target=r._accept_loop, daemon=True)
        t.start()
        threads.append(t)
    members = ["127.0.0.1:5001", "127.0.0.1:5002"]
    try:
        for step, now in enumerate((1000.0, 1010.0, 1020.0)):
            for i, mid in enumerate(members):
                hdr = {"method": "RegisterMember", "member_id": mid,
                       "address": mid, "capacity": 1, "seq": step + 1,
                       "mesh": {"devices": 1},
                       "snap": _snap(3 * i + step, i, 1e9 * (step + 1),
                                     full=step == 0)}
                acks = [_call(r.port, dict(hdr)) for r in routers.values()]
                assert acks[0] == acks[1]
            for r in routers.values():
                r.telemetry.sweep(r.registry.members_doc(), now=now)
        hz = {"torch": obs_http.healthz_doc(), "jax": jhttp.healthz_doc()}
        fed = {}
        for k, doc in hz.items():
            fed[k] = doc["federation"]
            for m in fed[k]["members"]:
                m.pop("hb_age_ms")
        assert fed["torch"] == fed["jax"]
        assert fed["torch"]["live"] == 2
        assert hz["torch"]["telemetry"] == hz["jax"]["telemetry"]
        assert hz["torch"]["telemetry"]["fleet"]["runs_resident"] == 2 + 5
        for req in ({"method": "GetTelemetry"},
                    {"method": "GetTelemetry",
                     "series": "fleet.runs_resident"},
                    {"method": "GetTelemetry", "series": "member.cups",
                     "labels": {"member": members[1]}, "since": 1005.0}):
            got = [_call(r.port, dict(req)) for r in routers.values()]
            assert got[0] == got[1]
        pts = _call(routers["torch"].port, {
            "method": "GetTelemetry",
            "series": "fleet.runs_resident"})["telemetry"]["series"]
        assert [p["last"] for p in pts["points"]][-3:] == [3.0, 5.0, 7.0]
    finally:
        for r in routers.values():
            _stop(r)
        for t in threads:
            t.join(timeout=2)
    # No router in the process: no federation or telemetry key.
    doc = obs_http.healthz_doc()
    assert "federation" not in doc and "telemetry" not in doc


# --------------------------------------------------- failover end to end


def _soup(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < 0.3).astype(np.uint8)


def test_failover_adopts_a_dead_members_runs(monkeypatch, tmp_path):
    """Three port fleet servers heartbeat to the port's router through
    their agents; six runs park at turn 24 with per-run checkpoints
    under one root; the owner of run 0 stops. The router declares it
    dead (one failover), adopts its runs onto the survivors, and every
    run reads back at turn 24 equal to the numpy oracle."""
    monkeypatch.setenv("GOL_FED_HEARTBEAT", "0.1")
    monkeypatch.setenv("GOL_FED_DEAD_AFTER", "1.5")
    monkeypatch.setenv("GOL_FED_REROUTE", "20")
    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "ck"))
    router = FederationRouter(port=0).start_background()
    members = []
    for _ in range(3):
        srv = EngineServer(port=0, host="127.0.0.1", engine=FleetEngine(
            device="cpu", bucket_sizes=(64,), chunk_turns=2, slot_base=2))
        srv.start_background()
        srv._fed_router = f"127.0.0.1:{router.port}"
        srv._self_addr = f"127.0.0.1:{srv.port}"
        agent = FederationAgent(srv._fed_router, srv._self_addr,
                                capacity=1, mesh={"devices": 1}).start()
        members.append((srv, agent))
    try:
        _wait(lambda: router.registry.members_doc()["live"] == 3,
              what="three members live")
        cli = RemoteEngine(f"127.0.0.1:{router.port}", timeout=30.0)
        seeds = {f"fo-{i}": _soup(64, 64, 60 + i) for i in range(6)}
        for rid, seed01 in seeds.items():
            cli.create_run(64, 64, board=seed01, run_id=rid,
                           ckpt_every=4, target_turn=24)
        for rid in seeds:
            _wait(lambda r=rid: cli.for_run(r).get_world()[1] == 24,
                  what=f"{rid} parked")
        owner = router._placements["fo-0"]["member"]
        victim = next(m for m in members if m[0]._self_addr == owner)
        orphans = {r for r, pl in router._placements.items()
                   if pl["member"] == owner}
        f0 = obs.FED_FAILOVERS.value
        victim[1].stop()
        victim[0].shutdown()
        victim[0].engine.kill_prog()
        _wait(lambda: all(router._placements[r]["member"] != owner
                          for r in orphans), timeout=30,
              what="orphans adopted")
        assert obs.FED_FAILOVERS.value == f0 + 1
        assert router.registry.members_doc()["dead"] == 1
        runs = cli.list_runs()[0]
        assert sorted(r["run_id"] for r in runs) == sorted(seeds)
        for rid, seed01 in seeds.items():
            _wait(lambda r=rid: cli.for_run(r).get_world()[1] == 24,
                  what=f"{rid} back at 24")
            board, t = cli.for_run(rid).get_world()
            np.testing.assert_array_equal(
                (board != 0).astype(np.uint8), run_turns_np(seed01, 24))
    finally:
        router.shutdown()
        for srv, agent in members:
            agent.stop()
            srv.shutdown()
            srv.engine.kill_prog()


# -------------------------------------------------------- entry points


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["GOL_FED_HEARTBEAT"] = "0.1"
    return env


def _banner_port(proc, pattern, timeout=120.0):
    found = {}

    def scan():
        for line in proc.stdout:
            m = re.search(pattern, line)
            if m:
                found["port"] = int(m.group(1))
                return

    t = threading.Thread(target=scan, daemon=True)
    t.start()
    t.join(timeout)
    return found.get("port")


def test_router_main_and_a_federated_server_subprocess(tmp_path):
    """`python -m gol_tpu_torch.federation.router` serves; a
    `gol_tpu_torch.server --fleet --federate ROUTER --advertise HOST`
    subprocess registers with it, and a run created through the router
    lands on that member."""
    router = subprocess.Popen(
        [sys.executable, "-m", "gol_tpu_torch.federation.router",
         "--port", "0"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_env(), cwd=str(tmp_path))
    member = None
    try:
        rport = _banner_port(router, r"router serving on :(\d+)")
        assert rport, "router never announced its port"
        member = subprocess.Popen(
            [sys.executable, "-m", "gol_tpu_torch.server", "--port", "0",
             "--fleet", "--device", "cpu", "--host", "127.0.0.1",
             "--federate", f"127.0.0.1:{rport}",
             "--advertise", "127.0.0.1"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(), cwd=str(tmp_path))
        mport = _banner_port(member, r"serving on :(\d+)")
        assert mport, "member never announced its port"
        cli = RemoteEngine(f"127.0.0.1:{rport}", timeout=30.0)
        deadline = time.monotonic() + 60
        while True:
            try:
                rec = cli.create_run(64, 64, run_id="sub1", target_turn=4)
                break
            except RuntimeError:
                # No live member yet: the router answers "overloaded:"
                # only after its reroute deadline; retry until the beat.
                assert time.monotonic() < deadline
                time.sleep(0.2)
        assert rec["run_id"] == "sub1"
        runs, _ = cli.list_runs()
        assert [(r["run_id"], r["member"]) for r in runs] == \
            [("sub1", f"127.0.0.1:{mport}")]
    finally:
        for p in (member, router):
            if p is not None:
                p.kill()
                p.wait(timeout=30)
                p.stdout.close()


# ------------------------------------------------------- flight recorder


def test_crash_dumps_a_valid_flight_document(monkeypatch, tmp_path):
    """`flight.crash` records the exception and dumps; the dump passes the
    port's `validate_dump` and `gol_tpu`'s."""
    monkeypatch.setenv("GOL_FLIGHT", str(tmp_path / "flight.json"))
    try:
        raise ValueError("kernel went sideways")
    except ValueError as e:
        path = flight.crash("engine.run_loop", e, turn=17)
    assert path is not None
    doc = json.loads(pathlib.Path(path).read_text())
    flight.validate_dump(doc)
    jflight.validate_dump(doc)
    ev = [r for r in doc["events"] if r.get("event") == "engine.run_loop"]
    assert ev and ev[-1]["turn"] == 17
    assert "kernel went sideways" in ev[-1]["error"]
    assert "Traceback" in ev[-1]["traceback"]
    # Without GOL_FLIGHT a crash records and writes nothing; never raises.
    monkeypatch.delenv("GOL_FLIGHT")
    assert flight.crash("x", RuntimeError("y")) is None


@pytest.mark.parametrize("breakage", [
    "not-a-dict", "schema", "reason", "pid", "spans", "metrics"])
def test_validate_dump_rejects_what_gol_tpu_rejects(breakage):
    doc = flight.FLIGHT.snapshot("manual")
    flight.validate_dump(doc)
    if breakage == "not-a-dict":
        doc = [doc]
    elif breakage == "schema":
        doc["schema"] = "gol-flight/0"
    elif breakage == "reason":
        doc["reason"] = ""
    elif breakage == "pid":
        doc["pid"] = "1"
    elif breakage == "spans":
        doc["spans"] = {}
    else:
        doc["metrics"] = []
    with pytest.raises(ValueError):
        flight.validate_dump(doc)
    with pytest.raises(ValueError):
        jflight.validate_dump(doc)
