"""The fleet across packages: a `gol_tpu` client drives the port's --fleet
server (`EngineServer` over `FleetEngine(device="cpu")`), and the port's
client drives `gol_tpu`'s --fleet server. CreateRun, ListRuns,
AttachRun (with a run-scoped GetWorld), SetRule, DestroyRun, their
errors and a legacy no-caps peer get the same replies and the same
bytes from either server. A fleet run's per-run checkpoint written by
either package restores in the other's fleet. Tolerance: none."""

import json
import socket
import struct
import time

import numpy as np
import pytest
import torch

from gol_tpu.client import RemoteEngine as JRemote
from gol_tpu.fleet import FleetEngine as JFleet
from gol_tpu.ops.reference import run_turns_np
from gol_tpu.params import Params as JParams
from gol_tpu.server import EngineServer as JServer

from gol_tpu_torch import wire as twire
from gol_tpu_torch.client import RemoteEngine as TRemote
from gol_tpu_torch.fleet import FleetEngine as TFleet
from gol_tpu_torch.params import Params as TParams
from gol_tpu_torch.server import EngineServer as TServer

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("GOL_FLEET_BUCKETS", "GOL_FLEET_CHUNK", "GOL_FLEET_SLOT_BASE",
              "GOL_FLEET_MEM_BUDGET", "GOL_FUSE_K", "GOL_CKPT",
              "GOL_CHAOS", "GOL_JOURNAL", "GOL_WIRE_CAPS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")


def _soup(h, w, seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < density).astype(np.uint8)


def _wait(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _port_fleet():
    return TFleet(device="cpu", bucket_sizes=(64,), chunk_turns=2,
                  slot_base=2)


def _jax_fleet():
    return JFleet(bucket_sizes=(64,), chunk_turns=2, slot_base=2)


@pytest.fixture
def servers():
    """{"port": the port's --fleet server, "jax": gol_tpu's}."""
    started = {"port": TServer(port=0, host="127.0.0.1",
                               engine=_port_fleet()),
               "jax": JServer(port=0, host="127.0.0.1",
                              engine=_jax_fleet())}
    threads = {k: srv.start_background() for k, srv in started.items()}
    yield started
    for k, srv in started.items():
        srv.engine.kill_prog()
        srv.shutdown()
        try:  # wake an accept() that closing the socket left blocked
            socket.create_connection(("127.0.0.1", srv.port),
                                     timeout=1).close()
        except OSError:
            pass
    for t in threads.values():
        t.join(timeout=10)
        assert not t.is_alive()


CLIENTS = {"port": TRemote, "jax": JRemote}


def _scenario(cli) -> dict:
    """One fleet sequence through a client; every reply it returns, the
    run-scoped GetWorld pixels and the errors' texts."""
    out = {}
    seed = _soup(64, 64, seed=21) * np.uint8(255)
    out["create"] = cli.create_run(64, 64, board=seed, run_id="w1",
                                   target_turn=10)
    out["create_small"] = cli.create_run(
        32, 32, board=_soup(32, 32, seed=22) * np.uint8(255),
        run_id="w2", target_turn=5)
    rv = cli.attach_run("w1")
    _wait(lambda: rv.stats()["state"] == "parked", what="w1 to park")
    rv2 = cli.attach_run("w2")
    _wait(lambda: rv2.stats()["state"] == "parked", what="w2 to park")
    out["list"] = cli.list_runs()
    out["world"], out["turn"] = rv.get_world()
    out["alive"] = rv.alive_count()
    stats = rv.stats()
    out["stats"] = {k: stats[k] for k in ("turn", "running", "board",
                                          "alive", "alive_turn", "packed",
                                          "chunk", "rule", "devices",
                                          "run_id", "state")}
    out["set_rule"] = cli.set_rule("w2", "B36/S23")
    out["destroy"] = cli.destroy_run("w1")
    errors = {}
    for name, call in (("attach_unknown", lambda: cli.attach_run("nope")),
                       ("destroy_again", lambda: cli.destroy_run("w1")),
                       ("destroy_legacy", lambda: cli.destroy_run("run0")),
                       ("bad_shape", lambda: cli.create_run(48, 48)),
                       ("bad_rule", lambda: cli.create_run(
                           64, 64, rule="/2/3"))):
        with pytest.raises(RuntimeError) as info:
            call()
        errors[name] = str(info.value)
    out["errors"] = errors
    out["list_after"] = cli.list_runs()
    return out


# Fields of a CreateRun record that depend on how far the loop got before
# the record was taken (once the run is placed it may step, even park).
TIMING_FIELDS = ("state", "turn", "alive", "alive_turn")


def _comparable(out: dict) -> dict:
    """The replies, pixels as bytes, and the creation records without
    their timing fields."""
    out = dict(out)
    out["world"] = out["world"].tobytes()
    for key in ("create", "create_small"):
        out[key] = {k: v for k, v in out[key].items()
                    if k not in TIMING_FIELDS}
    return out


@pytest.mark.parametrize("client", ("port", "jax"))
def test_fleet_rpcs_answer_alike_from_either_server(servers, client):
    """The same sequence through one package's client gets the same
    replies from the port's server as from `gol_tpu`'s."""
    got = {}
    for name, srv in servers.items():
        got[name] = _comparable(
            _scenario(CLIENTS[client](f"127.0.0.1:{srv.port}")))
    assert got["port"] == got["jax"]
    assert got["port"]["turn"] == 10
    want = run_turns_np(_soup(64, 64, seed=21), 10) * np.uint8(255)
    assert got["port"]["world"] == want.tobytes()


def _raw_call(port: int, header: dict):
    """A capability-less peer's call: a bare header, a raw-u8 reply."""
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        hdr = json.dumps(header).encode()
        s.sendall(struct.pack(">I", len(hdr)) + hdr)
        return twire.recv_msg(s)
    finally:
        s.close()


def _parked_run0(describe) -> None:
    """Wait until the legacy run0 reads `parked` at its target turn.
    `describe()` returns its ListRuns/AttachRun record."""
    def parked():
        rec = describe()
        return (rec["state"] == "parked"
                and rec.get("turn") == rec.get("target_turn"))

    _wait(parked, what="run0 to park at its target turn")


def _attach_run0(port: int) -> dict:
    resp, _ = _raw_call(port, {"method": "AttachRun", "run_id": "run0"})
    assert resp["ok"] is True, resp
    return resp["run"]


def test_legacy_no_caps_peer_gets_the_same_bytes(servers, monkeypatch):
    """A pre-fleet, pre-codec client (no run_id, no caps) drives run0 on
    each server through the other package's client and reads the same
    raw-u8 world bytes back, equal to the torus oracle's.

    Each server's run0 is created by a first drive of the same shape (0
    turns), and the asserted drive starts once run0 reads `parked` at
    that target: `gol_tpu`'s loop may step a freshly queued run0 before
    its drive seeds it (ROADMAP C), never a parked one. The port's first
    drive is asserted too; `gol_tpu`'s is the one the race can spoil."""
    monkeypatch.setenv("GOL_WIRE_CAPS", "")
    world = _soup(24, 24, seed=3) * np.uint8(255)
    want = run_turns_np((world != 0).astype(np.uint8), 6) * np.uint8(255)
    drives = (("port", JRemote, JParams), ("jax", TRemote, TParams))
    for name, cls, params in drives:
        got, turn = cls(f"127.0.0.1:{servers[name].port}").server_distributor(
            params(threads=1, image_width=24, image_height=24, turns=0),
            world)
        if name == "port":
            assert turn == 0
            np.testing.assert_array_equal(got, world)
        _parked_run0(lambda: _attach_run0(servers[name].port))
    for name, cls, params in drives:
        got, turn = cls(f"127.0.0.1:{servers[name].port}"
                        ).server_distributor(
            params(threads=1, image_width=24, image_height=24, turns=6),
            world)
        assert turn == 6, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    replies = {name: _raw_call(srv.port, {"method": "GetWorld"})
               for name, srv in servers.items()}
    for name, (resp, raw) in replies.items():
        assert resp["ok"] is True and resp["turn"] == 6, name
        assert resp["world"].get("codec", "u8") == "u8", name
        np.testing.assert_array_equal(raw, want, err_msg=name)
    heads = {name: {k: v for k, v in resp.items() if k != "tc"}
             for name, (resp, _) in replies.items()}
    assert heads["port"] == heads["jax"]
    alive = {name: {k: v for k, v in _raw_call(
                 srv.port, {"method": "Alivecount"})[0].items() if k != "tc"}
             for name, srv in servers.items()}
    assert alive["port"] == alive["jax"]
    assert alive["port"]["alive"] == int((want != 0).sum())


PARAMS = {"port": TParams, "jax": JParams}
FLEETS = {"port": _port_fleet, "jax": _jax_fleet}


def _checkpoint(eng, package, seed, tmp_path):
    """Step a board to turn 8 and checkpoint it: a 64² board as the fleet
    run "ck" (into tmp_path/run-ck), a 24² one as the legacy run through
    its private bucket (into tmp_path). Returns (directory, manifest)."""
    h, w = seed.shape
    if (h, w) == (64, 64):
        eng.create_run(h, w, board=seed, run_id="ck", target_turn=8)
        rv = eng.resolve_run("ck")
        _wait(lambda: rv.stats()["state"] == "parked", what="ck to park")
        path, turn = rv.checkpoint_now(directory=str(tmp_path))
        directory = tmp_path / "run-ck"
    else:
        # The legacy run0 is created by a first drive of 0 turns and
        # parks at it before the stepping drive (see
        # test_legacy_no_caps_peer_gets_the_same_bytes).
        first, turn0 = eng.server_distributor(
            PARAMS[package](threads=1, image_width=w, image_height=h,
                            turns=0), seed * np.uint8(255))
        if package == "port":
            assert turn0 == 0
            np.testing.assert_array_equal(first, seed * np.uint8(255))
        _parked_run0(eng.describe_run)
        p = PARAMS[package](threads=1, image_width=w, image_height=h,
                            turns=8)
        eng.server_distributor(p, seed * np.uint8(255))
        path, turn = eng.checkpoint_now(directory=str(tmp_path))
        directory = tmp_path
    assert turn == 8
    with open(path) as f:
        return str(directory), json.load(f)


@pytest.mark.parametrize("shape", ((64, 64), (24, 24)))
@pytest.mark.parametrize("writer", ("port", "jax"))
def test_fleet_checkpoints_restore_across_packages(tmp_path, writer,
                                                   shape):
    """A fleet checkpoint (a 64² fleet run's packed words in run-<id>/,
    a 24² legacy run's pixels at the root) restores in the other
    package's fleet as its legacy run at the checkpoint's turn, which
    then steps on from that board: every later (board, turn) it shows is
    the torus oracle's."""
    reader = "jax" if writer == "port" else "port"
    src, dst = FLEETS[writer](), FLEETS[reader]()
    try:
        seed = _soup(*shape, seed=sum(shape))
        directory, _ = _checkpoint(src, writer, seed, tmp_path)
        assert dst.restore_run(directory) == 8
        for _ in range(2):
            got, turn = dst.get_world()
            assert turn >= 8
            np.testing.assert_array_equal(
                got, run_turns_np(seed, turn) * np.uint8(255))
    finally:
        src.kill_prog()
        dst.kill_prog()


@pytest.mark.parametrize("shape", ((64, 64), (24, 24)))
def test_fleet_manifests_agree_across_packages(tmp_path, shape):
    """The same run checkpointed by each package: the manifests agree on
    everything but who wrote them, when, and the payload file's own
    hash (its zip metadata): board digest, alive count, repr, payload
    dtype and shape, geometry."""
    seed = _soup(*shape, seed=3 * sum(shape))
    docs = {}
    for package in ("port", "jax"):
        eng = FLEETS[package]()
        try:
            _, docs[package] = _checkpoint(eng, package, seed,
                                           tmp_path / package)
        finally:
            eng.kill_prog()
    skip = {"writer", "created_unix", "device", "payload_sha256",
            "payload_bytes"}
    assert ({k: v for k, v in docs["port"].items() if k not in skip}
            == {k: v for k, v in docs["jax"].items() if k not in skip})


def test_single_run_servers_answer_fleet_rpcs_alike():
    """Without --fleet, both packages' servers answer the fleet RPCs the
    same way: CreateRun and DestroyRun name --fleet, SetRule finds no
    set_rule, ListRuns and AttachRun describe the one legacy run."""
    import jax

    from gol_tpu.engine import Engine as JEngine
    from gol_tpu_torch.engine import Engine as TEngine

    started = {"port": TServer(port=0, host="127.0.0.1",
                               engine=TEngine(device="cpu")),
               "jax": JServer(port=0, host="127.0.0.1",
                              engine=JEngine(devices=jax.devices()[:1]))}
    threads = [srv.start_background() for srv in started.values()]
    got = {}
    try:
        for name, srv in started.items():
            cli = TRemote(f"127.0.0.1:{srv.port}")
            out = {"list": cli.list_runs(),
                   "attach": cli.attach_run("run0").run_id}
            for rpc, call in (("create", lambda: cli.create_run(64, 64)),
                              ("destroy", lambda: cli.destroy_run("x")),
                              ("set_rule",
                               lambda: cli.set_rule("x", "B3/S23"))):
                with pytest.raises(RuntimeError) as info:
                    call()
                out[rpc] = str(info.value)
            got[name] = out
    finally:
        for srv in started.values():
            srv.shutdown()
            try:
                socket.create_connection(("127.0.0.1", srv.port),
                                         timeout=1).close()
            except OSError:
                pass
        for t in threads:
            t.join(timeout=10)
    assert got["port"] == got["jax"]
    assert "--fleet" in got["port"]["create"]
    assert "set_rule" in got["port"]["set_rule"]
