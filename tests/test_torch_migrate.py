"""Live run migration in the port (`gol_tpu_torch/migrate.py`, the fleet
engine's `adopt_run`, `migrate_*`, `import_run`, `activate_imported`, and
the server's AdoptRun / Rescale / ReceiveRun / CommitRun), held against
`gol_tpu`'s:

  * a counterpart of each test of `tests/test_migrate.py` on the port's
    `FleetEngine(device="cpu")` and `EngineServer`s behind the port's
    `FederationRouter`: quiesce and rollback, commit with deferred flags,
    staged import and commit, the staged-parked variant, staged expiry,
    adopt promotes a staged import, Rescale end to end with redirect,
    Rescale of a resident run, bad targets, and `migrate_fail` at each of
    the five phases;
  * the quiesce readback of a resident run is the board at its turn, and
    a staged import holds no bucket slot before CommitRun;
  * adoption from a per-run checkpoint written by either package;
  * cross-package: a 64² run Rescaled from a port member to a `gol_tpu`
    member and back, behind each package's router, equals the numpy
    oracle and `gol_tpu`'s unmigrated run at its target turn.

Boards are compared with the numpy oracle (`gol_tpu.ops.reference`).
Tolerance: none."""

from __future__ import annotations

import socket
import threading
import time

import numpy as np
import pytest
import torch

from gol_tpu.federation.router import FederationRouter as JRouter
from gol_tpu.fleet import FleetEngine as JFleet
from gol_tpu.obs import audit as jaudit
from gol_tpu.ops.reference import run_turns_np
from gol_tpu.server import EngineServer as JServer

from gol_tpu_torch import migrate, wire
from gol_tpu_torch.client import RemoteEngine
from gol_tpu_torch.engine import FLAG_PAUSE
from gol_tpu_torch.federation import hrw
from gol_tpu_torch.federation.router import FederationRouter
from gol_tpu_torch.fleet import FleetEngine
from gol_tpu_torch.fleet.engine import EngineBusy
from gol_tpu_torch.obs import audit as taudit
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.server import EngineServer

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("GOL_FLEET_BUCKETS", "GOL_FLEET_CHUNK", "GOL_FLEET_SLOT_BASE",
              "GOL_FLEET_MEM_BUDGET", "GOL_FUSE_K", "GOL_CKPT",
              "GOL_CHAOS", "GOL_JOURNAL", "GOL_WIRE_CAPS",
              "GOL_MIGRATE_STALE", "GOL_MIGRATE_DEADLINE"):
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


def _soup(h, w, seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < density).astype(np.uint8)


def _replay(seed01, turns):
    return run_turns_np(seed01, turns).astype(np.uint8)


def _wait(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _rec(eng, rid):
    return next((r for r in eng.list_runs() if r["run_id"] == rid), None)


def _stop(srv) -> None:
    """Shut a server or router of either package down and wake its
    accept thread: `gol_tpu`'s shutdown closes the listening socket,
    which does not wake a thread blocked in accept(); one connection
    does."""
    srv.shutdown()
    try:
        socket.create_connection(("127.0.0.1", srv.port),
                                 timeout=1.0).close()
    except OSError:
        pass


def _port_fleet():
    return FleetEngine(device="cpu", bucket_sizes=(64,), chunk_turns=2,
                       slot_base=2)


# ------------------------------------------------- engine state machine


@pytest.fixture()
def fleet():
    eng = _port_fleet()
    try:
        yield eng
    finally:
        eng.kill_prog()


def test_quiesce_parks_defers_flags_and_rolls_back(fleet):
    seed01 = _soup(64, 64, seed=1)
    fleet.create_run(64, 64, board=seed01, run_id="q1", target_turn=6)
    _wait(lambda: (_rec(fleet, "q1") or {}).get("state") == "parked",
          what="q1 parked")
    q = fleet.migrate_quiesce("q1")
    assert q["state"] == "parked" and q["turn"] == 6
    np.testing.assert_array_equal(q["board"], _replay(seed01, 6))
    assert _rec(fleet, "q1").get("migrating") == "parked"

    # While migrating: destroy refused, second quiesce refused, flags
    # deferred (queued on the handle, not applied, not dropped).
    with pytest.raises(EngineBusy):
        fleet.destroy_run("q1")
    with pytest.raises(EngineBusy):
        fleet.migrate_quiesce("q1")
    fleet.resolve_run("q1").cf_put(FLAG_PAUSE)

    back = fleet.migrate_rollback("q1")
    assert back["restored"] and back["state"] == "parked"
    assert _rec(fleet, "q1").get("migrating") is None
    assert fleet.migrate_commit("q1") == []  # not migrating: no-op


def test_commit_retires_run_and_returns_deferred_flags(fleet):
    seed01 = _soup(64, 64, seed=2)
    fleet.create_run(64, 64, board=seed01, run_id="c1", target_turn=4)
    _wait(lambda: (_rec(fleet, "c1") or {}).get("state") == "parked",
          what="c1 parked")
    fleet.migrate_quiesce("c1")
    fleet.resolve_run("c1").cf_put(FLAG_PAUSE)
    assert fleet.migrate_commit("c1") == [FLAG_PAUSE]
    assert _rec(fleet, "c1") is None
    # Idempotent: both post-retire calls are safe no-ops.
    assert fleet.migrate_commit("c1") == []
    assert fleet.migrate_rollback("c1") == {"restored": False}


def test_import_stages_hidden_then_commit_activates(fleet):
    seed01 = _soup(64, 64, seed=3)
    board01 = _replay(seed01, 8)
    rec = fleet.import_run("i1", board01, 8, ckpt_every=0,
                           target_turn=20, activate=True)
    assert rec.get("migrating") == "staged" and rec["turn"] == 8
    # Hidden from list_runs, and in no bucket: the staged board waits on
    # the handle until CommitRun.
    assert _rec(fleet, "i1") is None
    h = fleet._runs["i1"]
    assert h.slot is None and h.state == "parked"
    assert all(h not in b.slots for b in fleet._buckets.values())
    time.sleep(0.2)
    assert h.slot is None and h.turn == 8
    with pytest.raises(RuntimeError, match="run_id"):
        fleet.import_run("i1", board01, 8)  # duplicate stage refused

    live = fleet.activate_imported("i1")
    assert live.get("migrating") is None
    _wait(lambda: (_rec(fleet, "i1") or {}).get("state") == "parked"
          and _rec(fleet, "i1")["turn"] == 20,
          what="activated import resumed to target_turn")
    board, t = fleet.resolve_run("i1").get_world()
    assert t == 20
    np.testing.assert_array_equal((board != 0).astype(np.uint8),
                                  _replay(seed01, 20))


def test_import_parked_variant_stays_parked(fleet):
    fleet.import_run("p1", _soup(64, 64, seed=4), 5, activate=False)
    rec = fleet.activate_imported("p1")
    assert rec["state"] == "parked" and rec.get("migrating") is None
    time.sleep(0.3)
    assert _rec(fleet, "p1")["turn"] == 5  # not advancing


def test_staged_import_destroyable_and_expires(fleet, monkeypatch):
    monkeypatch.setenv("GOL_MIGRATE_STALE", "0.3")
    board01 = _soup(64, 64, seed=5)
    fleet.import_run("d1", board01, 1)
    fleet.destroy_run("d1")  # rollback's path: allowed while staged
    assert fleet._runs.get("d1") is None  # gone outright, not hidden
    # An orphaned stage (source died before commit OR rollback) is
    # garbage-collected after GOL_MIGRATE_STALE seconds.
    fleet.import_run("d2", board01, 1)
    fleet.create_run(64, 64, board=board01, run_id="tick",
                     target_turn=2)  # keeps the service loop spinning
    _wait(lambda: fleet._runs.get("d2") is None, timeout=15,
          what="staged import expiry")


def test_adopt_promotes_staged_import(fleet):
    """kill_member@migrating recovery: the source dies after transfer,
    the router adopts the run onto the target, which already holds the
    staged board at the quiesce turn. Adoption promotes it in place."""
    ok0 = obs.FED_ADOPTED_RUNS.labels(status="ok").value
    board01 = _replay(_soup(64, 64, seed=6), 9)
    fleet.import_run("a1", board01, 9, activate=True)
    rec = fleet.adopt_run("a1")
    assert rec.get("migrating") is None
    assert _rec(fleet, "a1") is not None  # listed: authoritative
    assert obs.FED_ADOPTED_RUNS.labels(status="ok").value == ok0 + 1


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_quiesce_of_a_resident_run_reads_the_board_at_its_turn(fleet, seed):
    """A free-running run quiesced mid-flight: the transferred board is
    the one of the turn the handle records (no quantum in flight leaks
    into it), and rollback resumes it on the same trajectory."""
    seed01 = _soup(64, 64, seed=seed)
    fleet.create_run(64, 64, board=seed01, run_id="r1")
    _wait(lambda: (_rec(fleet, "r1") or {}).get("turn", 0) > 10,
          what="r1 advancing")
    q = fleet.migrate_quiesce("r1")
    assert q["state"] == "resident" and q["turn"] > 10
    np.testing.assert_array_equal(q["board"], _replay(seed01, q["turn"]))
    t_q = q["turn"]
    time.sleep(0.1)
    assert _rec(fleet, "r1")["turn"] == t_q  # parked while migrating
    fleet.migrate_rollback("r1")
    _wait(lambda: _rec(fleet, "r1")["turn"] > t_q, what="r1 resumed")
    board, t = fleet.resolve_run("r1").get_world()
    np.testing.assert_array_equal((board != 0).astype(np.uint8),
                                  _replay(seed01, t))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_adopt_run_restores_a_checkpoint_of_either_package(
        writer, monkeypatch, tmp_path):
    """AdoptRun from the shared root: the run registers quarantined, the
    restore path loads its newest manifest (written by either package's
    fleet) and requeues it at the manifest's turn and board."""
    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "ck"))
    seed01 = _soup(64, 64, seed=12)
    src = (_port_fleet() if writer == "torch"
           else JFleet(bucket_sizes=(64,), chunk_turns=2, slot_base=2))
    try:
        src.create_run(64, 64, board=seed01, run_id="ad1", target_turn=8)
        _wait(lambda: (_rec(src, "ad1") or {}).get("state") == "parked",
              what="source parked")
        src.resolve_run("ad1").checkpoint_now()
    finally:
        src.kill_prog()
    eng = _port_fleet()
    try:
        ok0 = obs.FED_ADOPTED_RUNS.labels(status="ok").value
        rec = eng.adopt_run("ad1", target_turn=8)
        assert rec["state"] == "quarantined" and rec["turn"] == 8
        _wait(lambda: (_rec(eng, "ad1") or {}).get("state") == "parked",
              what="adopted run restored")
        board, t = eng.resolve_run("ad1").get_world()
        assert t == 8
        np.testing.assert_array_equal((board != 0).astype(np.uint8),
                                      _replay(seed01, 8))
        assert obs.FED_ADOPTED_RUNS.labels(status="ok").value == ok0 + 1
        with pytest.raises(FileNotFoundError):
            eng.adopt_run("nothing-here")
    finally:
        eng.kill_prog()


# ------------------------------------------------ two-member federation


def _beat(router, addrs, stop):
    seq = 0
    while not stop.is_set():
        seq += 1
        for a in addrs:
            router.registry.register(a, a, seq)
        stop.wait(0.1)


@pytest.fixture()
def duo(monkeypatch, tmp_path):
    """The port's router + two port fleet servers heartbeating as
    members."""
    monkeypatch.setenv("GOL_FED_HEARTBEAT", "0.1")
    # No member dies here: generous slack keeps a loaded host's late beat
    # from declaring one dead.
    monkeypatch.setenv("GOL_FED_DEAD_AFTER", "5.0")
    monkeypatch.setenv("GOL_FED_REROUTE", "10")
    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "ck"))
    router = FederationRouter(port=0).start_background()
    servers = []
    for _ in range(2):
        srv = EngineServer(port=0, host="127.0.0.1", engine=_port_fleet())
        srv.start_background()
        srv._fed_router = f"127.0.0.1:{router.port}"
        srv._self_addr = f"127.0.0.1:{srv.port}"
        servers.append(srv)
    stop = threading.Event()
    t = threading.Thread(target=_beat, daemon=True,
                         args=(router, [s._self_addr for s in servers],
                               stop))
    t.start()
    _wait(lambda: router.registry.members_doc()["live"] == 2,
          what="both members live")
    try:
        yield router, servers
    finally:
        stop.set()
        t.join(timeout=2)
        router.shutdown()
        for srv in servers:
            srv.shutdown()
            srv.engine.kill_prog()


def _locate(router, servers, rid):
    """(source_server, target_server) per the router's placement."""
    pl = router._placements.get(rid)
    assert pl is not None, f"router never placed {rid}"
    src = next(s for s in servers if s._self_addr == pl["member"])
    dst = next(s for s in servers if s is not src)
    return src, dst


def test_rescale_end_to_end_parity_and_redirect(duo):
    router, servers = duo
    cli = RemoteEngine(f"127.0.0.1:{router.port}", timeout=30.0)
    seed01 = _soup(64, 64, seed=31)
    cli.create_run(64, 64, board=seed01, run_id="mig-e2e",
                   ckpt_every=4, target_turn=12)
    _wait(lambda: "mig-e2e" in router._placements,
          what="placement recorded")
    run_cli = cli.for_run("mig-e2e")
    _wait(lambda: run_cli.get_world()[1] == 12,
          what="run parked at turn 12")
    src, dst = _locate(router, servers, "mig-e2e")

    rec = cli.rescale("mig-e2e", dst._self_addr)
    assert rec["status"] == "ok" and rec["turn"] == 12
    assert rec["downtime_ms"] >= 0
    assert list(rec["phase_ms"]) == list(migrate.PHASES)
    assert rec["transfer_bytes"] > 0

    # Exactly one authoritative copy: gone from the source, listed on
    # the target, and the router pin points at the target.
    assert _rec(src.engine, "mig-e2e") is None
    assert _rec(dst.engine, "mig-e2e")["turn"] == 12
    assert router._placements["mig-e2e"]["member"] == dst._self_addr

    # Routed reads keep working and the board is bit-identical to the
    # replay: migration moved placement, not state.
    board, t = run_cli.get_world()
    assert t == 12
    np.testing.assert_array_equal((board != 0).astype(np.uint8),
                                  _replay(seed01, 12))

    # The source answers stragglers with the retryable "moved:" error.
    with socket.create_connection(("127.0.0.1", src.port),
                                  timeout=5) as s:
        wire.send_msg(s, {"method": "Ping", "run_id": "mig-e2e"})
        resp, _ = wire.recv_msg(s)
    assert str(resp.get("error", "")).startswith("moved:")
    assert dst._self_addr in resp["error"]
    dst.engine.resolve_run("mig-e2e")  # resolvable on its new home
    assert len(migrate._DOWNTIME_S) >= 1


def test_rescale_resident_run_keeps_advancing(duo):
    """A free-running (resident) run migrates mid-flight and keeps
    advancing on the target along the same trajectory."""
    router, servers = duo
    cli = RemoteEngine(f"127.0.0.1:{router.port}", timeout=30.0)
    seed01 = _soup(64, 64, seed=32)
    cli.create_run(64, 64, board=seed01, run_id="mig-live",
                   target_turn=400000)
    _wait(lambda: "mig-live" in router._placements,
          what="placement recorded")
    src, dst = _locate(router, servers, "mig-live")
    _wait(lambda: (_rec(src.engine, "mig-live") or {}).get("turn", 0) > 4,
          what="run advancing on source")

    rec = cli.rescale("mig-live", dst._self_addr)
    assert rec["status"] == "ok"
    t0 = rec["turn"]
    _wait(lambda: (_rec(dst.engine, "mig-live") or {}).get("turn", 0)
          > t0, what="run advancing on target")
    board, t = cli.for_run("mig-live").get_world()
    np.testing.assert_array_equal((board != 0).astype(np.uint8),
                                  _replay(seed01, t))


def test_rescale_rejects_bad_targets(duo):
    router, servers = duo
    cli = RemoteEngine(f"127.0.0.1:{router.port}", timeout=30.0)
    cli.create_run(64, 64, board=_soup(64, 64, seed=33),
                   run_id="mig-bad", target_turn=2)
    _wait(lambda: "mig-bad" in router._placements,
          what="placement recorded")
    src, _ = _locate(router, servers, "mig-bad")
    with pytest.raises(RuntimeError, match="already on"):
        cli.rescale("mig-bad", src._self_addr)
    with pytest.raises(RuntimeError, match="unknown run"):
        cli.rescale("nope", servers[1]._self_addr)
    with pytest.raises(RuntimeError, match="host:port"):
        cli.rescale("mig-bad", "nowhere")


@pytest.mark.parametrize("phase", migrate.PHASES)
def test_rescale_chaos_rollback_each_phase(duo, monkeypatch, phase):
    """GOL_CHAOS=migrate_fail=<phase>: every injected failure ends in a
    rollback — the source run is intact and on its trajectory, the
    target holds no copy, the router pin never flipped, and the caller
    gets the tagged "rolled back" error."""
    router, servers = duo
    cli = RemoteEngine(f"127.0.0.1:{router.port}", timeout=30.0)
    rid = f"mig-x-{phase}"
    seed01 = _soup(64, 64, seed=40 + len(phase))
    cli.create_run(64, 64, board=seed01, run_id=rid, target_turn=10)
    _wait(lambda: rid in router._placements, what="placement recorded")
    run_cli = cli.for_run(rid)
    _wait(lambda: run_cli.get_world()[1] == 10,
          what="run parked at turn 10")
    src, dst = _locate(router, servers, rid)
    rb0 = obs.MIGRATIONS.labels(status="rolled_back").value

    # The injector is memoized per raw spec string: a fresh value arms a
    # fresh one-shot for this phase.
    monkeypatch.setenv("GOL_CHAOS", f"migrate_fail={phase}")
    try:
        with pytest.raises(RuntimeError, match="rolled back"):
            cli.rescale(rid, dst._self_addr)
    finally:
        monkeypatch.delenv("GOL_CHAOS")
    assert obs.MIGRATIONS.labels(status="rolled_back").value == rb0 + 1

    # Exactly one live authoritative copy: the SOURCE one.
    rec = _rec(src.engine, rid)
    assert rec is not None and rec.get("migrating") is None
    assert _rec(dst.engine, rid) is None
    assert router._placements[rid]["member"] == src._self_addr
    # A leftover on the target (a redirect-phase failure destroys a
    # COMMITTED copy) is gone outright, not merely hidden.
    assert dst.engine._runs.get(rid) is None
    board, t = run_cli.get_world()
    assert t == 10
    np.testing.assert_array_equal((board != 0).astype(np.uint8),
                                  _replay(seed01, 10))
    # And the run migrates on the next try.
    assert cli.rescale(rid, dst._self_addr)["status"] == "ok"


# ------------------------------------------------------- across packages


def _id_on(member, members, prefix):
    """A run id whose rendezvous owner among `members` is `member`."""
    for i in range(1000):
        rid = f"{prefix}-{i}"
        if hrw.place(rid, members) == member:
            return rid
    raise AssertionError("no run id lands on the member")


@pytest.mark.parametrize("router_pkg", ["torch", "jax"])
def test_rescale_across_packages_and_back(router_pkg, monkeypatch,
                                          tmp_path):
    """A 64² run on a port member Rescales to a `gol_tpu` member
    mid-flight (the port's coordinator), then back (`gol_tpu`'s), behind
    either package's router; at its target turn the board equals the
    numpy oracle and `gol_tpu`'s unmigrated run, bit for bit."""
    monkeypatch.setenv("GOL_FED_HEARTBEAT", "0.1")
    monkeypatch.setenv("GOL_FED_DEAD_AFTER", "5.0")
    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "ck"))
    target = 3000
    router = (FederationRouter if router_pkg == "torch"
              else JRouter)(port=0).start_background()
    tsrv = EngineServer(port=0, host="127.0.0.1", engine=_port_fleet())
    jsrv = JServer(port=0, host="127.0.0.1",
                   engine=JFleet(bucket_sizes=(64,), chunk_turns=2,
                                 slot_base=2))
    control = JFleet(bucket_sizes=(64,), chunk_turns=2, slot_base=2)
    stop = threading.Event()
    for srv in (tsrv, jsrv):
        srv.start_background()
        srv._fed_router = f"127.0.0.1:{router.port}"
        srv._self_addr = f"127.0.0.1:{srv.port}"
    addrs = [tsrv._self_addr, jsrv._self_addr]
    beat = threading.Thread(target=_beat, args=(router, addrs, stop),
                            daemon=True)
    beat.start()
    try:
        _wait(lambda: router.registry.members_doc()["live"] == 2,
              what="both members live")
        rid = _id_on(tsrv._self_addr, addrs, f"x{router_pkg}")
        seed01 = _soup(64, 64, seed=50)
        cli = RemoteEngine(f"127.0.0.1:{router.port}", timeout=30.0)
        cli.create_run(64, 64, board=seed01, run_id=rid,
                       target_turn=target)
        control.create_run(64, 64, board=seed01, run_id=rid,
                           target_turn=target)
        _wait(lambda: rid in router._placements, what="placed")
        assert router._placements[rid]["member"] == tsrv._self_addr

        there = cli.rescale(rid, jsrv._self_addr)
        assert there["status"] == "ok" and there["turn"] <= target
        assert _rec(tsrv.engine, rid) is None
        assert router._placements[rid]["member"] == jsrv._self_addr
        back = cli.rescale(rid, tsrv._self_addr)
        assert back["status"] == "ok" and back["turn"] >= there["turn"]
        assert _rec(jsrv.engine, rid) is None
        assert router._placements[rid]["member"] == tsrv._self_addr

        run_cli = cli.for_run(rid)
        _wait(lambda: run_cli.get_world()[1] == target, timeout=120,
              what="migrated run at its target")
        _wait(lambda: (_rec(control, rid) or {}).get("state") == "parked",
              timeout=120, what="control run at its target")
        board, t = run_cli.get_world()
        want, tc = control.resolve_run(rid).get_world()
        assert t == tc == target
        got = (board != 0).astype(np.uint8)
        np.testing.assert_array_equal(got, _replay(seed01, target))
        np.testing.assert_array_equal(got, (want != 0).astype(np.uint8))
        rec = _rec(tsrv.engine, rid)
        assert rec["alive"] == int(got.sum())
    finally:
        stop.set()
        beat.join(timeout=2)
        _stop(router)
        for srv in (tsrv, jsrv):
            _stop(srv)
            srv.engine.kill_prog()
        control.kill_prog()
