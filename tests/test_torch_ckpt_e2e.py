"""Checkpoints end to end in the port, on the CPU: a run quit mid-way and
resumed from its newest checkpoint checkpoints the turns and boards of
the run that never stopped (unfused and at GOL_FUSE_K=16); the
controller's 'c' key in process and through SER; Checkpoint, RestoreRun
and GetJournal across the two packages in both directions;
`python -m gol_tpu_torch --resume DIR` adopting the manifest's rule and
size; and `python -m gol_tpu_torch.server --checkpoint DIR` taking a
SIGTERM mid-run, a new server `--resume DIR` and the controller ending on
the PGM of the run that never stopped. Boards are held against
`gol_tpu.ops.reference.run_turns_np` and the JAX engine; tolerance 0."""

import os
import queue
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from gol_tpu import Params as JParams
from gol_tpu import journal as jjournal
from gol_tpu.ckpt import manifest as jmf
from gol_tpu.client import RemoteEngine as JRemote
from gol_tpu.engine import Engine as JEngine
from gol_tpu.obs import flight as jflight
from gol_tpu.ops.reference import run_turns_np
from gol_tpu.server import EngineServer as JServer
from gol_tpu_torch import Params, events as ev, journal, run
from gol_tpu_torch.ckpt import manifest as mf
from gol_tpu_torch.ckpt.writer import payload_arrays
from gol_tpu_torch.client import RemoteEngine
from gol_tpu_torch.distributor import distributor
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.io.pgm import read_pgm, write_pgm
from gol_tpu_torch.models import parse_rule
from gol_tpu_torch.models.generations import (
    from_pixels_gen, gray_levels, run_turns, to_pixels_gen)
from gol_tpu_torch.obs import flight
from gol_tpu_torch.ops.bitpack import pack_np
from gol_tpu_torch.server import EngineServer
from tests.server_harness import wait_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _journal_isolation():
    journal.reset()
    jjournal.reset()
    yield
    journal.reset()
    jjournal.reset()


def _seed_images(tmp_path, h, w, seed):
    """images/WxH.pgm of a seeded 30% soup; returns (dir, {0,1} board)."""
    board = (np.random.default_rng(seed).random((h, w)) < 0.3).astype(
        np.uint8)
    images = str(tmp_path / "images")
    write_pgm(os.path.join(images, f"{w}x{h}.pgm"), board * 255)
    return images, board


def _packed_sha(board01):
    return mf.board_sha256(payload_arrays(pack_np(board01), "packed"))


def _drive(p, images, out, engine=None, keys=None, quit_at=None):
    """`run` to CLOSE; with `quit_at`, 'q' once the engine passes that
    turn. Returns the events."""
    q = queue.Queue()
    t = run(p, q, keys, engine=engine, images_dir=images, out_dir=out)
    if quit_at is not None:
        deadline = time.monotonic() + 60
        while engine.ping() < quit_at:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        keys.put("q")
    evs = ev.drain(q)
    t.join(60)
    assert not t.is_alive() and t.exception is None
    return evs


def _final(evs):
    return [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]


# ------------------------------------------- interrupted == uninterrupted


@pytest.mark.parametrize("fuse,shape", [(1, (64, 64)), (16, (64, 4096))],
                         ids=["unfused-64", "fuse16-64x4096"])
def test_interrupted_run_checkpoints_as_the_uninterrupted_one(
        fuse, shape, tmp_path, monkeypatch):
    h, w = shape
    turns, every = 640, 64
    images, board = _seed_images(tmp_path, h, w, seed=h + w)
    monkeypatch.setenv("GOL_FUSE_K", str(fuse))
    monkeypatch.setenv("GOL_CKPT_EVERY_TURNS", str(every))
    monkeypatch.setenv("GOL_CKPT_KEEP", "100")
    monkeypatch.setenv("GOL_MAX_CHUNK", "16")
    p = Params(image_width=w, image_height=h, turns=turns)

    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "whole"))
    _drive(p, images, str(tmp_path / "out_whole"), Engine(device="cpu"))

    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "cut"))
    eng = Engine(device="cpu")
    fin = _final(_drive(p, images, str(tmp_path / "out_cut"), eng,
                        keys=queue.Queue(), quit_at=200))
    t_quit = fin.completed_turns
    assert 200 <= t_quit < turns
    latest = mf.latest_checkpoint(str(tmp_path / "cut"))
    assert latest[0] == t_quit and latest[2]["trigger"] == "final"
    resumed = Engine(device="cpu")
    assert resumed.restore_run(str(tmp_path / "cut")) == t_quit
    monkeypatch.setenv("CONT", "yes")
    fin = _final(_drive(p, images, str(tmp_path / "out_cut"), resumed))
    assert fin.completed_turns == turns

    whole = {t: m for t, _, m in mf.list_checkpoints(str(tmp_path / "whole"))}
    cut = {t: m for t, _, m in mf.list_checkpoints(str(tmp_path / "cut"))}
    assert turns in whole and turns in cut and t_quit in cut
    assert all(t % every == 0 for t in set(cut) - {t_quit, turns})
    for t in sorted(set(whole) & set(cut)):
        for key in ("board_sha256", "alive", "repr", "dtype", "shape",
                    "fuse"):
            assert cut[t].get(key) == whole[t].get(key), (t, key)
    assert cut[turns].get("fuse") == (fuse if fuse > 1 else None)
    # Every checkpoint of the interrupted run holds the oracle's board.
    b, at = board, 0
    for t in sorted(cut):
        b, at = run_turns_np(b, t - at), t
        assert cut[t]["board_sha256"] == _packed_sha(b), t
    name = f"{w}x{h}x{turns}.pgm"
    with open(tmp_path / "out_cut" / name, "rb") as f, \
            open(tmp_path / "out_whole" / name, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(
        read_pgm(str(tmp_path / "out_cut" / name)), b * 255)


# --------------------------------------------------------------- the c key


@pytest.mark.parametrize("where", ["in-process", "ser"])
def test_c_key_writes_a_manifest(where, tmp_path, monkeypatch):
    images, board = _seed_images(tmp_path, 64, 64, seed=3)
    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "ck"))
    monkeypatch.setenv("GOL_MAX_CHUNK", "16")
    eng = Engine(device="cpu")
    srv = None
    if where == "ser":
        srv = EngineServer(port=0, host="127.0.0.1", engine=eng)
        srv.start_background()
        monkeypatch.setenv("SER", f"127.0.0.1:{srv.port}")
    try:
        keys, q = queue.Queue(), queue.Queue()
        t = run(Params(image_width=64, image_height=64, turns=10**7), q,
                keys, engine=None if srv else eng, images_dir=images,
                out_dir=str(tmp_path / "out"))
        deadline = time.monotonic() + 60
        while eng.ping() == 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        keys.put("c")
        while mf.latest_checkpoint(str(tmp_path / "ck")) is None:
            assert time.monotonic() < deadline, "'c' wrote no manifest"
            time.sleep(0.01)
        keys.put("q")
        ev.drain(q)
        t.join(60)
        assert not t.is_alive() and t.exception is None
    finally:
        if srv is not None:
            srv.shutdown()
    turn, path, m = mf.latest_checkpoint(str(tmp_path / "ck"))
    assert m["trigger"] == ("remote" if srv else "manual")
    jmf.verify_manifest(path)
    assert m["board_sha256"] == _packed_sha(run_turns_np(board, turn))


# ------------------------------------------- cross-talk, both directions

CROSS = {"torch-client/jax-server": "jax", "jax-client/torch-server": "torch"}


@pytest.fixture
def crossed(tmp_path, monkeypatch):
    """A factory: (client, server, run id) for one CROSS direction, the
    server configured with GOL_CKPT and GOL_JOURNAL and holding a 64²
    board after 100 journaled turns."""
    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")
    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "ck"))
    monkeypatch.setenv("GOL_JOURNAL", str(tmp_path / "j"))
    monkeypatch.setenv("GOL_JOURNAL_DIGEST_EVERY", "32")
    servers = []

    def make(direction):
        if CROSS[direction] == "jax":
            srv = JServer(port=0, host="127.0.0.1",
                          engine=JEngine(devices=jax.devices()[:1]))
            run_id = jflight.RUN_ID
            client = RemoteEngine(f"127.0.0.1:{srv.port}")
        else:
            srv = EngineServer(port=0, host="127.0.0.1",
                               engine=Engine(device="cpu"))
            run_id = flight.RUN_ID
            client = JRemote(f"127.0.0.1:{srv.port}")
        servers.append(srv)
        srv.start_background()
        world = (np.random.default_rng(5).random((64, 64)) < 0.3).astype(
            np.uint8) * 255
        client.ping()
        cls = JParams if isinstance(client, JRemote) else Params
        out, turn = client.server_distributor(
            cls(image_width=64, image_height=64, turns=100), world)
        assert turn == 100
        return client, run_id, (world != 0).astype(np.uint8)

    yield make
    for srv in servers:
        srv.shutdown()


@pytest.mark.parametrize("direction", sorted(CROSS))
def test_checkpoint_across_packages(direction, crossed, tmp_path):
    client, _, board = crossed(direction)
    name, turn = client.checkpoint_now()
    assert turn == 100 and name.endswith(".json")
    path = str(tmp_path / "ck" / name)
    for reader in (mf, jmf):
        m = reader.verify_manifest(path)
        assert m["trigger"] == "remote"
        assert m["board_sha256"] == _packed_sha(run_turns_np(board, 100))


@pytest.mark.parametrize("direction", sorted(CROSS))
def test_restore_run_across_packages(direction, crossed, tmp_path):
    client, _, board = crossed(direction)
    name, _ = client.checkpoint_now()
    cls = JParams if isinstance(client, JRemote) else Params
    world, turn = client.get_world()
    client.server_distributor(cls(image_width=64, image_height=64,
                                  turns=50), world, start_turn=100)
    assert client.ping() == 150
    assert client.restore_run(name) == 100
    got, turn = client.get_world()
    assert turn == 100
    np.testing.assert_array_equal(got, run_turns_np(board, 100) * 255)
    assert client.alive_count() == (int(run_turns_np(board, 100).sum()),
                                    100)
    with pytest.raises(RuntimeError, match="escapes"):
        client.restore_run("../outside")


@pytest.mark.parametrize("direction", sorted(CROSS))
def test_get_journal_across_packages(direction, crossed):
    client, run_id, board = crossed(direction)
    if isinstance(client, RemoteEngine):
        kw = {"run_id": run_id}
    else:
        # The JAX client names a run by binding to it: GetJournal carries
        # the bound run_id, which run-scoped methods would route by.
        client, kw = client.for_run(run_id), {}
    doc = client.get_journal(**kw)
    recs = doc["records"]
    assert [r["kind"] for r in recs] == ["create", "digest", "digest",
                                         "digest", "end"]
    assert doc["seq"] == recs[-1]["seq"] and doc["head"] == recs[-1]["hash"]
    for j in (journal, jjournal):
        assert j.verify_chain(recs)["ok"]
        assert j.verify_file(doc["path"], expected_head=doc["head"])["ok"]
    b, at = board, 0
    for r in recs[1:4]:
        b, at = run_turns_np(b, r["turn"] - at), r["turn"]
        assert r["board_sha256"] == _packed_sha(b)
    tail = client.get_journal(since_seq=recs[2]["seq"], limit=1, **kw)
    assert [r["seq"] for r in tail["records"]] == [recs[3]["seq"]]


# ----------------------------------------------------------- processes


def _env():
    env = dict(os.environ)
    env.pop("SER", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.timeout(300)
def test_cli_resume_adopts_the_manifests_rule_and_size(tmp_path,
                                                       monkeypatch):
    """`python -m gol_tpu_torch --resume DIR` with no --rule, -w or -h: a
    Brian's Brain 96x64 manifest sets all three, and the run ends on the
    gen8 path's board at the target turn."""
    rule = parse_rule("/2/3")
    state = np.random.default_rng(8).integers(0, 3, (64, 96)).astype(
        np.uint8)
    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "ck"))
    monkeypatch.setenv("GOL_CKPT_EVERY_TURNS", "1000")
    eng = Engine(device="cpu", rule=rule)
    eng.server_distributor(Params(image_width=96, image_height=64,
                                  turns=100), to_pixels_gen(state, rule))
    assert eng._repr == "gen3"
    out = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", "--turns", "150",
         "--headless", "--device", "cpu", "--resume", str(tmp_path / "ck")],
        capture_output=True, text=True, timeout=240, cwd=str(tmp_path),
        env=_env())
    assert out.returncode == 0, out.stderr
    assert "resuming at turn 100" in out.stdout
    got = read_pgm(str(tmp_path / "out" / "96x64x150.pgm"),
                   levels=tuple(gray_levels(rule).tolist()))
    import torch

    want = run_turns(torch.from_numpy(state), 150, rule).numpy()
    np.testing.assert_array_equal(from_pixels_gen(got, rule), want)


@pytest.mark.timeout(300)
def test_sigterm_checkpoint_and_resume_server(tmp_path, images_dir,
                                              monkeypatch):
    """A port server with --checkpoint takes SIGTERM mid-run: it drains,
    writes a `sigterm` manifest and the legacy 64x64.npz, and exits 0. A
    new server `--resume DIR` on the same port restores that turn, the
    controller reattaches there and ends on the PGM of the run that
    never stopped."""
    turns = 20000
    ck = str(tmp_path / "ck")
    server_env = dict(_env(), GOL_DRAIN_DEADLINE="0.2")

    def spawn(port, *extra):
        return subprocess.Popen(
            [sys.executable, "-u", "-m", "gol_tpu_torch.server", "--port",
             str(port), "--host", "127.0.0.1", "--device", "cpu",
             "--checkpoint", ck, *extra], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=server_env,
            cwd=str(tmp_path))

    procs = [spawn(0)]
    collected = []
    try:
        port = wait_port(procs[0], timeout=120)
        assert port, "server 1 never announced its port"
        monkeypatch.setenv("SER", f"127.0.0.1:{port}")
        monkeypatch.setenv("GOL_RECONNECT", "120")
        monkeypatch.setenv("GOL_HB_INTERVAL", "0.3")
        q = queue.Queue()
        p = Params(image_width=64, image_height=64, turns=turns)

        def collect():
            while True:
                e = q.get()
                if e is ev.CLOSE:
                    return
                collected.append(e)

        threading.Thread(target=collect, daemon=True).start()
        ctrl = threading.Thread(target=distributor, args=(p, q),
                                kwargs=dict(images_dir=images_dir,
                                            out_dir=str(tmp_path / "out")),
                                daemon=True)
        ctrl.start()
        probe = RemoteEngine(f"127.0.0.1:{port}")
        deadline = time.monotonic() + 60
        while probe.ping() == 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        procs[0].send_signal(signal.SIGTERM)
        assert procs[0].wait(60) == 0
        t_sig, path, m = mf.latest_checkpoint(ck)
        assert m["trigger"] == "sigterm" and 0 < t_sig < turns
        with np.load(os.path.join(ck, "64x64.npz")) as z:
            assert int(z["turn"]) >= t_sig
        procs.append(spawn(port, "--resume", ck))
        assert wait_port(procs[1], timeout=120) == port
        ctrl.join(240)
        assert not ctrl.is_alive(), "controller did not finish"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
    kinds = [type(e).__name__ for e in collected]
    assert kinds.count("EngineLost") == 1, kinds
    reatt = [e for e in collected if isinstance(e, ev.EngineReattached)]
    assert len(reatt) == 1 and reatt[0].completed_turns == t_sig
    assert _final(collected).completed_turns == turns
    monkeypatch.delenv("SER")
    _drive(p, images_dir, str(tmp_path / "ref"), Engine(device="cpu"))
    name = f"64x64x{turns}.pgm"
    with open(tmp_path / "out" / name, "rb") as f, \
            open(tmp_path / "ref" / name, "rb") as g:
        assert f.read() == g.read()
