"""The port's process split: `gol_tpu_torch.server.EngineServer` over
`Engine(device="cpu")` and `gol_tpu_torch.client.RemoteEngine`, driven by
the port's controller with `SER` set — the counterpart of
`tests/test_remote.py` and `tests/test_failure.py`. Boards are held
against the `check/` goldens and `gol_tpu.ops.reference.run_turns_np`
(tolerance 0). Three subprocess servers (`python -m gol_tpu_torch.server
--device cpu`) prove the split across real processes: one for a CONT=yes
reattach, two for a SIGKILL and a restart on the same port."""

import json
import os
import queue
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from gol_tpu.ops.reference import run_turns_np
from gol_tpu_torch import Params, events as ev, run
from gol_tpu_torch import wire
from gol_tpu_torch.client import RemoteEngine
from gol_tpu_torch.distributor import distributor
from gol_tpu_torch.engine import FLAG_PAUSE, FLAG_QUIT, Engine, EngineKilled
from gol_tpu_torch.io.pgm import read_pgm
from gol_tpu_torch.models.generations import BRIANS_BRAIN
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import trace
from gol_tpu_torch.server import NOT_YET_PORTED, EngineServer
from tests.server_harness import wait_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def server(monkeypatch):
    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")
    srv = EngineServer(port=0, host="127.0.0.1", engine=Engine(device="cpu"))
    srv.start_background()
    yield srv
    srv.shutdown()


def _ser(monkeypatch, srv):
    monkeypatch.setenv("SER", f"127.0.0.1:{srv.port}")


def _blinker():
    world = np.zeros((16, 16), dtype=np.uint8)
    world[4:7, 5] = 255
    return world


def _alive_board(final, shape):
    board = np.zeros(shape, dtype=np.uint8)
    for x, y in final.alive:
        board[y, x] = 1
    return board


def _spawn_server(tmp_path, port=0, extra_env=None):
    """`python -m gol_tpu_torch.server --device cpu` in a subprocess."""
    env = dict(os.environ)
    env.pop("SER", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra_env or {})
    return subprocess.Popen(
        [sys.executable, "-u", "-m", "gol_tpu_torch.server", "--port",
         str(port), "--host", "127.0.0.1", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path))


def _stop(proc):
    if proc is not None and proc.poll() is None:
        proc.terminate()
        proc.wait(10)


# ------------------------------------------------------- main path


@pytest.mark.parametrize("size,turns", [(16, 0), (16, 1), (16, 100),
                                        (64, 0), (64, 1), (64, 100)])
def test_golden_through_ser(size, turns, server, images_dir, check_dir,
                            out_dir, monkeypatch):
    _ser(monkeypatch, server)
    q = queue.Queue()
    t = run(Params(threads=8, image_width=size, image_height=size,
                   turns=turns), q, images_dir=images_dir, out_dir=out_dir)
    evs = ev.drain(q)
    t.join(30)
    assert t.exception is None
    final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    assert final.completed_turns == turns
    name = f"{size}x{size}x{turns}.pgm"
    with open(os.path.join(out_dir, name), "rb") as f:
        assert f.read() == (check_dir / "images" / name).read_bytes()
    want = read_pgm(str(check_dir / "images" / name)) != 0
    np.testing.assert_array_equal(_alive_board(final, want.shape), want)


def test_remote_rpc_surface(server):
    eng = RemoteEngine(f"127.0.0.1:{server.port}")
    world = (np.arange(64 * 32).reshape(32, 64) % 7 == 0).astype(
        np.uint8) * 255
    p = Params(threads=2, image_width=64, image_height=32, turns=10)
    out, turn = eng.server_distributor(p, world)
    assert turn == 10
    want = run_turns_np((world != 0).astype(np.uint8), 10)
    np.testing.assert_array_equal((out != 0).astype(np.uint8), want)

    alive, turn = eng.alive_count()
    assert turn == 10 and alive == int(want.sum())
    snap, turn = eng.get_world()
    np.testing.assert_array_equal(snap, out)

    # GetView: the full frame under the cap, a bounded downsampled frame
    # above it equal to the local engine's, then an xrle delta of 0 bytes.
    vfull, vt, vf = eng.get_view(64 * 32)
    assert vt == 10 and vf == (1, 1)
    np.testing.assert_array_equal(vfull, out)
    vsmall, _, (fy, fx) = eng.get_view(128)
    assert fy > 1 and vsmall.size <= 128
    lview, _, lf = server.engine.get_view(128)
    assert (fy, fx) == lf
    np.testing.assert_array_equal(vsmall, lview)
    xrle = obs.WIRE_FRAMES.labels(codec="xrle")
    frames = xrle.value
    again, _, _ = eng.get_view(128)
    np.testing.assert_array_equal(again, lview)
    # the server counts the frame just after its last byte went out
    deadline = time.monotonic() + 10
    while xrle.value == frames and time.monotonic() < deadline:
        time.sleep(0.01)
    assert xrle.value == frames + 1

    # resume path: remaining turns with explicit start_turn
    p2 = Params(threads=2, image_width=64, image_height=32, turns=5)
    out2, turn2 = eng.server_distributor(p2, snap, start_turn=turn)
    assert turn2 == 15
    np.testing.assert_array_equal((out2 != 0).astype(np.uint8),
                                  run_turns_np(want, 5))
    s = eng.stats()
    assert s["turn"] == 15 and s["board"] == [32, 64]
    assert s["rule"] == "B3/S23" and s["device"] == "cpu"
    assert eng.ping() == 15
    assert "gol_server_requests_total" in eng.get_metrics()


def test_remote_quit_flag(server):
    eng = RemoteEngine(f"127.0.0.1:{server.port}")
    p = Params(threads=1, image_width=16, image_height=16, turns=10**8)
    result = {}

    def blocking_run():
        result["out"], result["turn"] = eng.server_distributor(p, _blinker())

    t = threading.Thread(target=blocking_run, daemon=True)
    t.start()
    time.sleep(1.0)
    eng.cf_put(FLAG_QUIT)
    t.join(30)
    assert not t.is_alive()
    assert 0 < result["turn"] < 10**8
    assert (result["out"] != 0).sum() == 3  # blinker population invariant


def test_drain_flags_pause_only_e2e(server):
    """`DrainFlags(pause_only=True)` wipes a stranded pause and keeps a
    stranded quit, which then stops the next run; a full drain wipes
    both."""
    eng = RemoteEngine(f"127.0.0.1:{server.port}")
    eng.cf_put(FLAG_PAUSE)
    eng.cf_put(FLAG_QUIT)
    eng.drain_flags(pause_only=True)
    p = Params(threads=1, image_width=16, image_height=16, turns=10**8)
    t0 = time.monotonic()
    _, turn = eng.server_distributor(p, _blinker())
    assert time.monotonic() - t0 < 60
    assert 0 <= turn < 10**8
    eng.cf_put(FLAG_PAUSE)
    eng.cf_put(FLAG_QUIT)
    eng.drain_flags()
    _, turn2 = eng.server_distributor(
        Params(threads=1, image_width=16, image_height=16, turns=5),
        _blinker())
    assert turn2 == 5


def test_attach_drainflags_error_still_delivers_close(images_dir, out_dir,
                                                      monkeypatch):
    """A server answering the attach DrainFlags with ok:false does not
    stop the run: it completes and CLOSE arrives."""

    class BrokenDrainServer(EngineServer):
        def _dispatch(self, conn, header, world, t_acc=None):
            if header.get("method") == "DrainFlags":
                wire.send_msg(conn, {"ok": False, "error": "NameError: x"})
                return
            super()._dispatch(conn, header, world, t_acc)

    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")
    srv = BrokenDrainServer(port=0, host="127.0.0.1",
                            engine=Engine(device="cpu"))
    srv.start_background()
    try:
        _ser(monkeypatch, srv)
        q = queue.Queue()
        t = run(Params(threads=1, image_width=16, image_height=16, turns=3),
                q, images_dir=images_dir, out_dir=out_dir)
        evs = ev.drain(q)
        t.join(30)
        assert not t.is_alive()
        fin = [e for e in evs if isinstance(e, ev.FinalTurnComplete)]
        assert fin and fin[0].completed_turns == 3
    finally:
        srv.shutdown()


def test_remote_kill(server):
    eng = RemoteEngine(f"127.0.0.1:{server.port}")
    eng.kill_prog()
    with pytest.raises((EngineKilled, RuntimeError, ConnectionError,
                        OSError)):
        eng.alive_count()


def test_remote_bad_method_and_garbage(server):
    s = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    wire.send_msg(s, {"method": "NoSuchMethod"})
    resp, _ = wire.recv_msg(s)
    assert resp["ok"] is False and "unknown method" in resp["error"]
    s.close()
    s2 = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    s2.sendall(b"\x00\x00\x00\x05notjs")  # garbage must not take it down
    s2.close()
    assert RemoteEngine(f"127.0.0.1:{server.port}").alive_count()[0] >= 0


@pytest.mark.parametrize("method", sorted(NOT_YET_PORTED))
def test_not_yet_ported_method_names_its_roadmap_item(method, server):
    s = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    try:
        wire.send_msg(s, {"method": method, "caps": ["packed"]})
        resp, world = wire.recv_msg(s)
    finally:
        s.close()
    assert resp["ok"] is False and world is None
    assert f"ROADMAP {NOT_YET_PORTED[method]}" in resp["error"]
    assert method in resp["error"]
    assert resp["caps"] == wire.advertised_caps()
    # the server serves on
    assert RemoteEngine(f"127.0.0.1:{server.port}").ping() == 0


def test_hostile_world_dims_rejected(server):
    """A header claiming a huge board is refused before any allocation,
    and the server stays up."""
    s = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    hdr = json.dumps(
        {"method": "GetWorld", "world": {"h": 2**31, "w": 2**31}}).encode()
    s.sendall(struct.pack(">I", len(hdr)) + hdr)
    with pytest.raises((ConnectionError, OSError)):
        resp, _ = wire.recv_msg(s)
        assert resp["ok"] is False
        raise ConnectionError("rejected via error reply")
    s.close()
    assert RemoteEngine(f"127.0.0.1:{server.port}").alive_count()[1] >= 0
    assert 2**31 * 2**31 > wire.max_board_cells()
    assert 131072 * 131072 <= wire.max_board_cells()


def test_stalling_client_is_shed(monkeypatch):
    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")
    monkeypatch.setenv("GOL_HDR_TIMEOUT", "1.0")
    srv = EngineServer(port=0, host="127.0.0.1", engine=Engine(device="cpu"))
    srv.start_background()
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        s.settimeout(5.0)
        t0 = time.monotonic()
        assert s.recv(1) == b""  # closed after GOL_HDR_TIMEOUT
        assert time.monotonic() - t0 < 4.0
        s.close()
        assert RemoteEngine(f"127.0.0.1:{srv.port}").ping() == 0
        assert obs.RPC_ERRORS.labels(method="unknown",
                                     kind="timeout").value >= 1
    finally:
        srv.shutdown()


def test_connection_cap(monkeypatch):
    """Beyond GOL_MAX_CONNS concurrent connections the server refuses
    with 'overloaded:' and recovers once the hogs disconnect."""
    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")
    monkeypatch.setenv("GOL_MAX_CONNS", "2")
    monkeypatch.setenv("GOL_HDR_TIMEOUT", "30")
    srv = EngineServer(port=0, host="127.0.0.1", engine=Engine(device="cpu"))
    srv.start_background()
    try:
        hogs = [socket.create_connection(("127.0.0.1", srv.port), timeout=5)
                for _ in range(2)]
        time.sleep(0.3)
        s3 = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        s3.settimeout(5.0)
        resp, _ = wire.recv_msg(s3)
        assert resp["ok"] is False and "connection limit" in resp["error"]
        s3.close()
        with pytest.raises(ConnectionError, match="overloaded"):
            RemoteEngine(f"127.0.0.1:{srv.port}").ping()
        for h in hogs:
            h.close()
        deadline = time.monotonic() + 10
        while True:
            try:
                assert RemoteEngine(f"127.0.0.1:{srv.port}").ping() == 0
                break
            except (RuntimeError, ConnectionError, OSError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
    finally:
        srv.shutdown()


def test_abort_run_over_the_wire(server, monkeypatch):
    """Only the submitting RemoteEngine (same token) can abort its run."""
    monkeypatch.setenv("GOL_MAX_CHUNK", "4")
    owner = RemoteEngine(f"127.0.0.1:{server.port}")
    other = RemoteEngine(f"127.0.0.1:{server.port}")
    p = Params(threads=1, image_width=16, image_height=16, turns=10**8)
    result = {}

    def blocking_run():
        result["out"], result["turn"] = owner.server_distributor(
            p, _blinker())

    t = threading.Thread(target=blocking_run, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while owner.ping() == 0:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    assert other.abort_run() is False
    assert t.is_alive()
    assert owner.abort_run() is True
    t.join(30)
    assert not t.is_alive()
    assert 0 < result["turn"] < 10**8


def test_heartbeat_unblocks_hung_connection(monkeypatch):
    """A server that accepts the run call and goes silent: the watchdog
    closes the run socket after GOL_HB_MISSES failed pings."""
    monkeypatch.setenv("GOL_HB_INTERVAL", "0.2")
    monkeypatch.setenv("GOL_HB_MISSES", "2")
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(16)
    port = lsock.getsockname()[1]
    conns = []

    def silent_server():
        while True:
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            conns.append(conn)  # read nothing, reply nothing

    threading.Thread(target=silent_server, daemon=True).start()
    try:
        eng = RemoteEngine(f"127.0.0.1:{port}", timeout=0.3)
        p = Params(threads=1, image_width=16, image_height=16, turns=10**8)
        t0 = time.monotonic()
        with pytest.raises(ConnectionError, match="heartbeat lost"):
            eng.server_distributor(p, _blinker())
        assert time.monotonic() - t0 < 30
    finally:
        lsock.close()
        for c in conns:
            c.close()


def test_dedupe_replays_a_retried_mutation(server):
    """A CFput retried with the same req_id is answered from the dedupe
    window: one flag reaches the engine."""
    hits = obs.SERVER_DEDUP_HITS.labels(method="CFput").value
    replies = []
    for _ in range(2):
        s = socket.create_connection(("127.0.0.1", server.port), timeout=5)
        try:
            wire.send_msg(s, {"method": "CFput", "flag": FLAG_QUIT,
                              "req_id": "retry-1"})
            replies.append(wire.recv_msg(s)[0])
        finally:
            s.close()
    assert all(r["ok"] for r in replies)
    assert obs.SERVER_DEDUP_HITS.labels(method="CFput").value == hits + 1
    assert server.engine._flags.qsize() == 1


def test_handler_span_joins_the_callers_trace(server):
    trace.TRACER.reset()
    RemoteEngine(f"127.0.0.1:{server.port}").ping()
    # The handler span ends just after its reply is sent.
    deadline = time.monotonic() + 10
    while True:
        spans = {s["name"]: s for s in trace.TRACER.finished_spans()}
        if "serve.Ping" in spans or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    rpc, serve = spans["rpc.Ping"], spans["serve.Ping"]
    assert serve["trace"] == rpc["trace"]
    assert serve["parent"] == rpc["span"]


def test_generations_server_rule_sets_controller_levels(
        images_dir, out_dir, monkeypatch):
    """With SER set the server's engine decides the rule: the controller
    reads and writes the gray levels of the rule the server reports."""
    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")
    srv = EngineServer(port=0, host="127.0.0.1",
                       engine=Engine(device="cpu", rule=BRIANS_BRAIN))
    srv.start_background()
    try:
        _ser(monkeypatch, srv)
        p = Params(threads=1, image_width=64, image_height=64, turns=30)
        q = queue.Queue()
        t = run(p, q, images_dir=images_dir, out_dir=out_dir)
        evs = ev.drain(q)
        t.join(30)
        assert t.exception is None
        final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
        monkeypatch.delenv("SER")
        local_out = os.path.join(out_dir, "local")
        q2 = queue.Queue()
        t2 = run(p, q2, engine=Engine(device="cpu", rule=BRIANS_BRAIN),
                 images_dir=images_dir, out_dir=local_out)
        evs2 = ev.drain(q2)
        t2.join(30)
        final2 = [e for e in evs2
                  if isinstance(e, ev.FinalTurnComplete)][0]
        assert final.alive == final2.alive
        with open(os.path.join(out_dir, "64x64x30.pgm"), "rb") as f, \
                open(os.path.join(local_out, "64x64x30.pgm"), "rb") as g:
            assert f.read() == g.read()
    finally:
        srv.shutdown()


# ----------------------------------------------------- observability


def test_chaos_fault_sequence_matches_jax():
    from gol_tpu import chaos as jchaos
    from gol_tpu_torch import chaos as tchaos

    spec = "drop=0.2,truncate=0.1,corrupt=0.1,delay=0.1,stall=0.05,seed=7"
    ji, ti = jchaos.ChaosInjector(spec), tchaos.ChaosInjector(spec)
    send = (("drop", ji.drop), ("truncate", ji.truncate),
            ("corrupt", ji.corrupt), ("delay", ji.delay),
            ("stall", ji.stall))
    assert [ti._plan(send) for _ in range(200)] == \
        [ji._plan(send) for _ in range(200)]


def test_chaos_refused_dial_is_tagged(server, monkeypatch):
    monkeypatch.setenv("GOL_CHAOS", "refuse=1,seed=1")
    with pytest.raises(ConnectionError) as err:
        RemoteEngine(f"127.0.0.1:{server.port}").ping()
    assert err.value.rpc_error_kind == "refused"
    assert obs.CHAOS_INJECTED.labels(kind="refuse").value >= 1


def test_slo_estimator_matches_jax():
    from gol_tpu.obs import slo as jslo
    from gol_tpu_torch.obs import slo as tslo

    rng = np.random.default_rng(3)
    samples = rng.lognormal(-7, 1.5, 5000)
    je, te = jslo.LogBucketEstimator(), tslo.LogBucketEstimator()
    for v in samples:
        je.observe(v)
        te.observe(v)
    qs = (0.5, 0.9, 0.95, 0.99)
    assert te.percentiles(qs) == je.percentiles(qs)


def test_catalog_families_match_jax():
    from gol_tpu.obs.metrics import REGISTRY as JREG
    from gol_tpu_torch.obs.metrics import REGISTRY as TREG

    jfam = JREG.families()
    for name, fam in TREG.families().items():
        assert name in jfam, name
        assert (fam.kind, fam.label_names) == \
            (jfam[name].kind, jfam[name].label_names), name


# ------------------------------------------------- across processes


@pytest.mark.timeout(300)
def test_cross_process_detach_reattach(images_dir, out_dir, tmp_path,
                                       monkeypatch):
    """Controller 1 quits mid-run ('q'); the server process keeps (world,
    turn); controller 2 with CONT=yes reattaches and finishes; the final
    board is the oracle's evolution of the detached one."""
    proc = _spawn_server(tmp_path)
    try:
        port = wait_port(proc, timeout=120)
        assert port, "server subprocess never announced its port"
        monkeypatch.setenv("SER", f"127.0.0.1:{port}")
        q1, keys1 = queue.Queue(), queue.Queue()
        t1 = run(Params(threads=2, image_width=64, image_height=64,
                        turns=10**8), q1, keys1, images_dir=images_dir,
                 out_dir=out_dir)
        probe = RemoteEngine(f"127.0.0.1:{port}")
        deadline = time.monotonic() + 60
        while probe.ping() == 0:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        keys1.put("q")
        t1.join(60)
        assert not t1.is_alive(), "controller 1 did not detach"
        fin1 = [e for e in ev.drain(q1)
                if isinstance(e, ev.FinalTurnComplete)][0]
        t_detach = fin1.completed_turns
        board_detach = _alive_board(fin1, (64, 64))

        total = t_detach + 50
        monkeypatch.setenv("CONT", "yes")
        q2 = queue.Queue()
        t2 = run(Params(threads=2, image_width=64, image_height=64,
                        turns=total), q2, images_dir=images_dir,
                 out_dir=out_dir)
        evs2 = ev.drain(q2)
        t2.join(30)
        fin2 = [e for e in evs2 if isinstance(e, ev.FinalTurnComplete)][0]
        assert fin2.completed_turns == total
        np.testing.assert_array_equal(_alive_board(fin2, (64, 64)),
                                      run_turns_np(board_detach, 50))
    finally:
        _stop(proc)


@pytest.mark.timeout(300)
def test_sigkill_restart_recovers_the_run(images_dir, out_dir, tmp_path,
                                          monkeypatch):
    """The engine server is SIGKILLed mid-run and a new one starts on the
    same port: the controller emits EngineLost, then EngineReattached at
    turn 0 (the new server holds no board, so the controller resubmits
    its last-known board), and the final board is the oracle's."""
    server_env = {"GOL_MAX_CHUNK": "16"}  # a slow, replayable engine
    proc1 = _spawn_server(tmp_path, extra_env=server_env)
    proc2 = None
    collected = []
    closed = threading.Event()
    try:
        port = wait_port(proc1, timeout=120)
        assert port, "server 1 never announced its port"
        monkeypatch.setenv("SER", f"127.0.0.1:{port}")
        monkeypatch.setenv("GOL_RECONNECT", "120")
        monkeypatch.setenv("GOL_HB_INTERVAL", "0.3")
        monkeypatch.setenv("GOL_HB_MISSES", "2")
        q, keys = queue.Queue(), queue.Queue()

        def collect():
            while True:
                e = q.get()
                if e is ev.CLOSE:
                    closed.set()
                    return
                collected.append(e)

        threading.Thread(target=collect, daemon=True).start()
        ctrl = threading.Thread(
            target=distributor,
            args=(Params(threads=2, image_width=64, image_height=64,
                         turns=10**8), q, keys),
            kwargs=dict(images_dir=images_dir, out_dir=out_dir),
            daemon=True)
        ctrl.start()
        probe = RemoteEngine(f"127.0.0.1:{port}")
        deadline = time.monotonic() + 60
        while probe.ping() == 0:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        time.sleep(1.0)

        os.kill(proc1.pid, signal.SIGKILL)
        proc1.wait(10)
        deadline = time.monotonic() + 60
        while not any(isinstance(e, ev.EngineLost) for e in collected):
            assert time.monotonic() < deadline, "EngineLost never emitted"
            assert ctrl.is_alive(), "controller died instead of recovering"
            time.sleep(0.1)

        # The replacement binds the port the first one was given.
        proc2 = _spawn_server(tmp_path, port=port, extra_env=server_env)
        assert wait_port(proc2, timeout=120) == port
        deadline = time.monotonic() + 120
        while not any(isinstance(e, ev.EngineReattached)
                      for e in collected):
            assert time.monotonic() < deadline, "never reattached"
            assert ctrl.is_alive()
            time.sleep(0.1)
        keys.put("q")
        ctrl.join(60)
        assert not ctrl.is_alive(), "controller did not finish after 'q'"
        assert closed.wait(10)

        kinds = [type(e).__name__ for e in collected]
        assert kinds.count("EngineLost") == 1
        assert kinds.count("EngineReattached") == 1
        assert kinds.index("EngineLost") < kinds.index("EngineReattached")
        reatt = [e for e in collected
                 if isinstance(e, ev.EngineReattached)][0]
        assert reatt.completed_turns == 0  # the last-known board, resubmitted
        final = [e for e in collected
                 if isinstance(e, ev.FinalTurnComplete)][0]
        assert final.completed_turns > 0
        world0 = (read_pgm(os.path.join(images_dir, "64x64.pgm")) != 0
                  ).astype(np.uint8)
        np.testing.assert_array_equal(
            _alive_board(final, (64, 64)),
            run_turns_np(world0, final.completed_turns))
    finally:
        _stop(proc1)
        _stop(proc2)
