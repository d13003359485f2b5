"""The port's broadcast tier (`gol_tpu_torch.broadcast`, `.gateway`, the
server's Subscribe and the client's `ViewSubscription`), held against
`gol_tpu`'s:

  * a counterpart of each test of `tests/test_broadcast.py` — EpochStream
    and hub units over the same `FakeSurface`, and Subscribe end to end
    against an in-process port fleet server (`FleetEngine(device="cpu")`):
    encode-once, keyframe cadence, epoch bumps, slow-subscriber skips,
    DestroyRun's end sentinel and view-cache eviction, the caps refusal;
  * byte identity: one surface script gives frames whose frozen bytes are
    equal in both packages (keyframe 4, ring 6, forced epoch bumps, close);
  * cross-talk: each package's `ViewSubscription` against the other's
    server, frames equal to `GetView` at the same turn;
  * single-run views: a seeded 64² run on `Engine(device="cpu")` streams
    frames equal to `gol_tpu`'s `Engine.get_view` at the same turns, for
    the packed, u8, gen3, gen8 and f32 representations.

Tolerance: none; the f32 (Lenia) frames are compared after both packages'
/255 quantisation, exactly."""

from __future__ import annotations

import contextlib
import socket
import threading
import time

import numpy as np
import pytest

from gol_tpu import broadcast as jbroadcast
from gol_tpu.client import RemoteEngine as JRemote
from gol_tpu.engine import Engine as JEngine
from gol_tpu.models import parse_rule as jparse_rule
from gol_tpu.server import EngineServer as JServer
from gol_tpu_torch import wire
from gol_tpu_torch.broadcast import BcastFrame, BroadcastHub, EpochStream
from gol_tpu_torch.client import RemoteEngine
from gol_tpu_torch.engine import FLAG_PAUSE, FLAG_QUIT, Engine
from gol_tpu_torch.models import parse_rule
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.params import Params
from gol_tpu_torch.server import EngineServer

BOARD = 32
VIEW_CELLS = BOARD * BOARD


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


class FakeSurface:
    """Deterministic publish surface: each turn flips one cell."""

    binary_pixels = True
    frames_diffable = True

    def __init__(self, n: int = BOARD) -> None:
        self.n = n
        self.turn = 0
        self.pixels = np.zeros((n, n), dtype=np.uint8)
        self.fy = self.fx = 1

    def advance(self, turns: int = 1) -> None:
        for _ in range(turns):
            self.turn += 1
            i = self.turn % (self.n * self.n)
            self.pixels.flat[i] ^= 1

    def ping(self) -> int:
        return self.turn

    def get_view(self, max_cells: int):
        return self.pixels.copy(), self.turn, (self.fy, self.fx)


def _decode(raw: bytes, basis=None):
    """Decode one frozen wire message through a real socket pair."""
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        a.shutdown(socket.SHUT_WR)
        return wire.recv_msg(b, xrle_basis=basis)
    finally:
        a.close()
        b.close()


def _stream(monkeypatch, keyframe=4, ring=0, hz=1e6) -> EpochStream:
    monkeypatch.setenv("GOL_BCAST_KEYFRAME", str(keyframe))
    if ring:
        monkeypatch.setenv("GOL_BCAST_RING", str(ring))
    monkeypatch.setenv("GOL_BCAST_HZ", str(hz))
    return EpochStream("runA", FakeSurface(), VIEW_CELLS)


# ------------------------------------------------------ stream and hub


def test_keyframe_cadence(monkeypatch):
    st = _stream(monkeypatch, keyframe=4)
    surf = st._surface
    kinds = []
    for _ in range(10):
        surf.advance()
        bf = st.publish(force=True)
        assert isinstance(bf, BcastFrame)
        kinds.append(bf.key)
    # K D D D D K D D D D: a keyframe, keyframe_every deltas, repeat.
    assert kinds == [True, False, False, False, False,
                     True, False, False, False, False]


def test_frames_decode_along_the_basis_chain(monkeypatch):
    st = _stream(monkeypatch, keyframe=4)
    surf = st._surface
    basis = None
    for i in range(7):
        surf.advance()
        bf = st.publish(force=True)
        header, view = _decode(bf.raw, basis=basis)
        assert header["ok"] and header["push"] == "frame"
        assert header["seq"] == i and header["turn"] == surf.turn
        assert header["key"] == bf.key
        assert header["world"]
        assert np.array_equal(view != 0, surf.pixels != 0)
        basis = (surf.turn, view)


def test_repeated_turn_publishes_without_reencoding(monkeypatch):
    st = _stream(monkeypatch, keyframe=4)
    surf = st._surface
    surf.advance()
    first = st.publish(force=True)
    calls = obs.WIRE_ENCODE_CALLS.value
    again = st.publish(force=True)  # same turn: ring tail, no encode
    assert again is first
    assert obs.WIRE_ENCODE_CALLS.value == calls


def test_pacing_and_idle_probe(monkeypatch):
    st = _stream(monkeypatch, keyframe=4, hz=10.0)
    surf = st._surface
    surf.advance()
    assert st.publish(now=100.0) is not None
    surf.advance()
    assert st.publish(now=100.01) is None      # inside 1/hz: paced off
    assert st.publish(now=101.0) is not None   # due again
    assert st.publish(now=102.0) is None       # idle turn: ping() probe


def test_ring_eviction_resyncs_at_a_keyframe(monkeypatch):
    st = _stream(monkeypatch, keyframe=4, ring=6)
    surf = st._surface
    for _ in range(20):
        surf.advance()
        st.publish(force=True)
    frame, skipped = st.next_frame(0)
    assert frame.key
    assert frame is st._latest_key
    assert skipped == frame.seq
    assert st.attach() == frame.seq
    st.detach()
    assert st.next_frame(st._seq) is None


def test_epoch_bumps_on_basis_invalidation(monkeypatch):
    st = _stream(monkeypatch, keyframe=100)
    surf = st._surface
    surf.advance(3)
    st.publish(force=True)
    surf.advance()
    assert not st.publish(force=True).key  # mid-chain: a delta
    surf.turn = 1  # turn regression (reset/restore): basis is dead
    bf = st.publish(force=True)
    assert bf.key and st.epoch == 1
    surf.advance()
    surf.fy = 2  # geometry change: same story
    bf = st.publish(force=True)
    assert bf.key and st.epoch == 2


def test_close_rings_the_end_sentinel(monkeypatch):
    st = _stream(monkeypatch)
    surf = st._surface
    surf.advance()
    st.publish(force=True)
    st.close("killed: gone")
    frame, _ = st.next_frame(st._seq - 1)
    assert frame.end
    header, view = _decode(frame.raw)
    assert header == {"ok": False, "push": "end", "seq": 1,
                      "error": "killed: gone"}
    assert view is None
    surf.advance()
    assert st.publish(force=True) is None  # closed: refuses publishes


def test_hub_streams_are_shared_and_droppable(monkeypatch):
    monkeypatch.setenv("GOL_BCAST_KEYFRAME", "4")
    hub = BroadcastHub()
    surf = FakeSurface()
    a = hub.stream_for("runA", surf, VIEW_CELLS)
    assert hub.stream_for("runA", surf, VIEW_CELLS) is a
    assert hub.stream_for("runA", surf, 16) is not a  # other geometry
    hub.drop_run("runA", "killed: destroyed")
    assert a.closed
    b = hub.stream_for("runA", surf, VIEW_CELLS)
    assert b is not a  # closed streams are replaced, not resurrected


# ------------------------------------------------------ byte identity


def _script(stream, surf):
    """Publish a fixed script: deltas, keyframes, a turn regression, a
    geometry change, a repeated turn, and the end sentinel; returns the
    frozen bytes of every ring entry in order."""
    out = []
    for step in range(23):
        surf.advance(1 + step % 3)
        if step == 9:
            surf.turn = 2  # regression: epoch bump, forced keyframe
        if step == 15:
            surf.fy = 2  # geometry change: another epoch
        out.append(stream.publish(force=True).raw)
        if step == 5:
            out.append(stream.publish(force=True).raw)  # repeated turn
    stream.close("killed: script over")
    out.append(stream.next_frame(stream._seq - 1)[0].raw)
    return out


@pytest.mark.parametrize("run_id", ["", "runA"])
def test_stream_bytes_equal_gol_tpu(monkeypatch, run_id):
    monkeypatch.setenv("GOL_BCAST_KEYFRAME", "4")
    monkeypatch.setenv("GOL_BCAST_RING", "6")
    monkeypatch.setenv("GOL_BCAST_HZ", "1000000")
    ts, js = FakeSurface(), FakeSurface()
    mine = _script(EpochStream(run_id, ts, VIEW_CELLS), ts)
    ref = _script(jbroadcast.EpochStream(run_id, js, VIEW_CELLS), js)
    assert len(mine) == len(ref) == 25
    assert mine == ref


# --------------------------------------------------------- end to end


@pytest.fixture()
def bcast_server(monkeypatch):
    monkeypatch.setenv("GOL_BCAST_KEYFRAME", "4")
    monkeypatch.setenv("GOL_BCAST_RING", "8")
    monkeypatch.setenv("GOL_BCAST_HZ", "100")
    from gol_tpu_torch.fleet import FleetEngine

    eng = FleetEngine(bucket_sizes=(BOARD,), chunk_turns=2, slot_base=8,
                      device="cpu")
    srv = EngineServer(port=0, host="127.0.0.1", engine=eng)
    srv.start_background()
    try:
        yield srv, f"127.0.0.1:{srv.port}"
    finally:
        eng.kill_prog()
        srv.shutdown()


def _recv_until(sub, pred, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    last = None
    while time.monotonic() < deadline:
        last = sub.recv(timeout=30.0)
        if pred(last):
            return last
    raise AssertionError(f"condition never met; last frame {last!r}")


def _pinned_view(client, max_cells):
    """A paused run's view: poll until two reads agree on the turn."""
    ref, ref_turn, _ = client.get_view(max_cells)
    for _ in range(100):
        out, turn, _ = client.get_view(max_cells)
        if turn == ref_turn:
            return ref, ref_turn
        ref, ref_turn = out, turn
        time.sleep(0.02)
    raise AssertionError("the run never parked")


def _encodes_and_frames(hub, run_id):
    """(wire encode calls, published frames), read while every stream of
    `run_id` holds its publish lock: a publication encodes and counts its
    frame inside one hold of that lock (`EpochStream.publish`)."""
    with hub._lock:
        streams = [st for key, st in hub._streams.items()
                   if key.startswith(f"{run_id}|")]
    with contextlib.ExitStack() as held:
        for st in streams:
            held.enter_context(st._pub_lock)
        return (obs.WIRE_ENCODE_CALLS.value,
                sum(c.value for c in obs.BCAST_FRAMES.children().values()))


def test_subscribe_e2e_parity_encode_once_and_destroy(bcast_server):
    srv, address = bcast_server
    ctl = RemoteEngine(address, timeout=30.0)
    rid = ctl.create_run(BOARD, BOARD)["run_id"]
    bound = ctl.attach_run(rid)
    sub1 = bound.subscribe(VIEW_CELLS, timeout=30.0)
    sub2 = bound.subscribe(VIEW_CELLS, timeout=30.0)
    try:
        assert sub1.run_id == rid and sub1.keyframe_every == 4
        _recv_until(sub1, lambda f: f[3]["seq"] >= 2)
        _recv_until(sub2, lambda f: f[3]["seq"] >= 2)

        # Encode-once witness over a live window: wire encodes advance
        # exactly as much as published broadcast frames, with two
        # subscribers attached. Each pair is read with the run's streams'
        # publish locks held, so no publication falls between its reads.
        hub, gateway = srv._bcast
        e0, f0 = _encodes_and_frames(hub, rid)
        for _ in range(6):
            sub1.recv(timeout=30.0)
            sub2.recv(timeout=30.0)
        e1, f1 = _encodes_and_frames(hub, rid)
        assert f1 - f0 > 0
        assert e1 - e0 == f1 - f0

        # Adopted sockets carry TCP_NODELAY + SO_KEEPALIVE.
        gsubs = list(gateway._subs.values())
        assert len(gsubs) == 2
        for gs in gsubs:
            assert gs.sock.getsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY)
            assert gs.sock.getsockopt(socket.SOL_SOCKET,
                                      socket.SO_KEEPALIVE)
        assert obs.BCAST_SUBSCRIBERS.value >= 0
        assert obs.BCAST_FRAMES.label_names == ("kind",)

        # Pushed frames equal the per-viewer GetView at the same turn.
        bound.cf_put(FLAG_PAUSE)
        ref, ref_turn = _pinned_view(bound, VIEW_CELLS)
        hub.publish_now(force=True)
        view, turn, _geom, _header = _recv_until(
            sub1, lambda f: f[1] >= ref_turn, deadline_s=10.0)
        assert turn == ref_turn
        assert np.array_equal(view, ref)

        # DestroyRun: the end sentinel reaches the subscriber with the
        # reason, and the run's view-cache basis entries are gone.
        with srv._view_cache_lock:
            assert any(k.startswith(f"{rid}|") for k in srv._view_cache)
        ctl.destroy_run(rid)
        with pytest.raises(ConnectionError, match="destroyed"):
            for _ in range(200):
                sub1.recv(timeout=10.0)
        with srv._view_cache_lock:
            assert not any(k.startswith(f"{rid}|")
                           for k in srv._view_cache)
    finally:
        sub1.close()
        sub2.close()


def test_slow_subscriber_skips_without_stalling_others(bcast_server):
    srv, address = bcast_server
    ctl = RemoteEngine(address, timeout=30.0)
    rid = ctl.create_run(BOARD, BOARD)["run_id"]
    bound = ctl.attach_run(rid)
    live = bound.subscribe(VIEW_CELLS, timeout=30.0)
    stalled = None
    try:
        live.recv(timeout=30.0)
        _hub, gateway = srv._bcast
        before = set(gateway._subs)
        stalled = bound.subscribe(VIEW_CELLS, timeout=30.0)
        deadline = time.monotonic() + 30.0
        while set(gateway._subs) == before \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        new = set(gateway._subs) - before
        assert len(new) == 1
        gs = gateway._subs[next(iter(new))]
        # Shrink both buffer sides of the stalled path so the gateway
        # hits EWOULDBLOCK (and the ring overtakes it) fast.
        stalled._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                 4096)
        gs.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        d0 = obs.BCAST_FRAMES_DROPPED.value
        t0 = live.recv(timeout=30.0)[1]
        deadline = time.monotonic() + 120.0
        t1 = t0
        while time.monotonic() < deadline:
            t1 = live.recv(timeout=30.0)[1]
            if gs.stream._seq - gs.next_seq > 24:
                break
        assert gs.stream._seq - gs.next_seq > 24
        assert t1 > t0

        # Drained, the stalled subscriber lands on a keyframe with the
        # skipped sends metered.
        last_turn = -1
        resynced = False
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            _view, turn, _geom, header = stalled.recv(timeout=10.0)
            drops = obs.BCAST_FRAMES_DROPPED.value - d0
            if drops > 0 and header["key"] and turn > last_turn:
                resynced = True
                break
            last_turn = max(last_turn, turn)
        assert resynced
        assert obs.BCAST_FRAMES_DROPPED.value - d0 > 0
        assert live.recv(timeout=30.0)[1] >= t1
    finally:
        live.close()
        stalled.close()
        ctl.destroy_run(rid)


def test_subscribe_refused_without_shared_caps(bcast_server):
    _srv, address = bcast_server
    ctl = RemoteEngine(address, timeout=30.0)
    rid = ctl.create_run(BOARD, BOARD)["run_id"]
    host, port = address.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=10.0)
    try:
        wire.send_msg(sock, {"method": "Subscribe", "run_id": rid,
                             "max_cells": VIEW_CELLS, "caps": []})
        resp, _ = wire.recv_msg(sock)
        assert resp["ok"] is False
        assert "caps" in resp["error"]
    finally:
        sock.close()
        ctl.destroy_run(rid)


def test_destroy_run_evicts_every_view_cache_entry(bcast_server):
    srv, address = bcast_server
    c1 = RemoteEngine(address, timeout=30.0)
    c2 = RemoteEngine(address, timeout=30.0)
    rid = c1.create_run(BOARD, BOARD)["run_id"]
    b1 = c1.attach_run(rid)
    b2 = c2.attach_run(rid)
    b1.get_view(VIEW_CELLS)
    b2.get_view(VIEW_CELLS)
    with srv._view_cache_lock:
        primed = [k for k in srv._view_cache if k.startswith(f"{rid}|")]
    assert len(primed) == 2
    c1.destroy_run(rid)
    with srv._view_cache_lock:
        assert not any(k.startswith(f"{rid}|") for k in srv._view_cache)


def test_server_shutdown_ends_every_stream(bcast_server):
    srv, address = bcast_server
    bound = RemoteEngine(address, timeout=30.0).attach_run(
        RemoteEngine(address, timeout=30.0).create_run(
            BOARD, BOARD)["run_id"])
    sub = bound.subscribe(VIEW_CELLS, timeout=30.0)
    try:
        sub.recv(timeout=30.0)
        srv.shutdown()
        with pytest.raises(ConnectionError, match="shutting down"):
            for _ in range(200):
                sub.recv(timeout=10.0)
    finally:
        sub.close()


# ----------------------------------------------------------- cross-talk


def _seeded(h, w, seed, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < density).astype(np.uint8) * 255


@pytest.mark.parametrize("side", ["jax-client/torch-server",
                                  "torch-client/jax-server"])
def test_subscription_crosses_packages(side, monkeypatch):
    """Each package's ViewSubscription against the other's single-run
    server: pushed frames equal GetView at the same turn, bit for bit."""
    monkeypatch.setenv("GOL_BCAST_HZ", "100")
    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")
    if side.startswith("jax-client"):
        client_cls = JRemote
        srv = EngineServer(port=0, host="127.0.0.1",
                           engine=Engine(device="cpu"))
    else:
        client_cls = RemoteEngine
        srv = JServer(port=0, host="127.0.0.1", engine=JEngine())
    srv.start_background()
    eng = srv.engine
    runner = threading.Thread(
        target=eng.server_distributor,
        args=(Params(threads=1, image_width=64, image_height=64,
                     turns=10 ** 9), _seeded(64, 64, 7)),
        daemon=True)
    runner.start()
    sub = None
    try:
        deadline = time.monotonic() + 60.0
        while eng.ping() == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        cli = client_cls(f"127.0.0.1:{srv.port}", timeout=30.0)
        sub = cli.subscribe(1024, timeout=30.0)
        first = sub.recv(timeout=30.0)
        assert first[3]["key"] and first[2] == (2, 2)
        cli.cf_put(FLAG_PAUSE)
        # Parked once the loop has taken the flag (it then blocks in its
        # pause until the next flag).
        while eng._flags.queue and time.monotonic() < deadline + 60.0:
            time.sleep(0.02)
        ref, ref_turn = _pinned_view(cli, 1024)
        srv._bcast[0].publish_now(force=True)
        view, turn, _geom, _header = _recv_until(
            sub, lambda f: f[1] >= ref_turn, deadline_s=30.0)
        assert turn == ref_turn
        assert np.array_equal(view, ref)
    finally:
        if sub is not None:
            sub.close()
        eng.cf_put(FLAG_QUIT)
        runner.join(timeout=60)
        _stop_server(srv)
    assert not runner.is_alive()


# ------------------------------------------------ single-run engine views


REPR_RULES = {
    "packed": "B3/S23",
    "u8": "R5,C0,M1,S33..57,B34..45,NM",
    "gen3": "/2/3",
    "gen8": "345/2/4",
    "f32": "lenia:r=13,mu=0.15,sigma=0.015,dt=0.1",
}


@pytest.mark.parametrize("max_cells", [0, 256])
@pytest.mark.parametrize("repr_", sorted(REPR_RULES))
def test_single_run_frames_equal_gol_tpu_views(repr_, max_cells,
                                                monkeypatch):
    """A seeded 64² run on the port's single-run engine, subscribed
    through its server: the frames at turns 3 and 8 equal `gol_tpu`'s
    `Engine.get_view` of the same run at the same turns."""
    monkeypatch.setenv("GOL_BCAST_HZ", "100")
    rule = REPR_RULES[repr_]
    if repr_ == "f32":
        rng = np.random.default_rng(11)
        world = (rng.random((64, 64)) * 255).astype(np.uint8)
    else:
        world = _seeded(64, 64, 11)
    teng = Engine(device="cpu", rule=parse_rule(rule))
    jeng = JEngine(rule=jparse_rule(rule))
    srv = EngineServer(port=0, host="127.0.0.1", engine=teng)
    srv.start_background()
    sub = None
    try:
        for turns in (3, 8):
            p = Params(threads=1, image_width=64, image_height=64,
                       turns=turns)
            teng.server_distributor(p, world)
            jeng.server_distributor(p, world)
            assert teng._repr == repr_
            if sub is None:
                sub = RemoteEngine(f"127.0.0.1:{srv.port}",
                                   timeout=30.0).subscribe(max_cells)
            view, turn, geom, _header = _recv_until(
                sub, lambda f, t=turns: f[1] == t
                and teng.ping() == t, deadline_s=30.0)
            want, jturn, jgeom = jeng.get_view(max_cells)
            assert (turn, geom) == (jturn, jgeom)
            assert view.dtype == np.uint8
            assert np.array_equal(view, np.asarray(want))
    finally:
        if sub is not None:
            sub.close()
        srv.shutdown()


def test_no_gol_tpu_thread_outlives_this_file():
    """Every `gol_tpu` server, hub, gateway and engine thread this file
    started has ended: a leftover would move the JAX package's
    process-global counters under a JAX test that shares this worker."""
    deadline = time.monotonic() + 10.0
    while _gol_tpu_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _gol_tpu_threads() == []
