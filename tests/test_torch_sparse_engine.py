"""The port's sparse engine (`gol_tpu_torch.sparse_engine.SparseEngine` on
the CPU) behind the control protocol, mirroring `tests/test_sparse_engine.py`:
an R-pentomino on a 2^20 torus emits AliveCellsCount events, obeys
pause, snapshot and quit, survives a detach/reattach cycle, checkpoints,
and runs through the CLI and the engine server. Across packages: sparse
manifests and `sparse{N}x{N}.npz` files written by either restore in the
other and continue to the same cells, `GetWindow` frames are equal byte
for byte, and each package's controller drives the other's sparse
server. Tolerance: none."""

import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import gol_tpu
from gol_tpu import events as jev
from gol_tpu import wire as jw
from gol_tpu.ckpt import manifest as jmf
from gol_tpu.ops.reference import run_turns_np
from gol_tpu.client import RemoteEngine as JRemote
from gol_tpu.server import EngineServer as JServer
from gol_tpu.sparse_engine import SparseEngine as JSparse

import gol_tpu_torch
from gol_tpu_torch import Params, events as ev
from gol_tpu_torch import wire as tw
from gol_tpu_torch import sparse_engine as tse
from gol_tpu_torch.ckpt import manifest as mf
from gol_tpu_torch.client import RemoteEngine as TRemote
from gol_tpu_torch.engine import FLAG_PAUSE, FLAG_QUIT, EngineKilled
from gol_tpu_torch.io.pgm import read_pgm, write_pgm
from gol_tpu_torch.models.lifelike import HIGHLIFE
from gol_tpu_torch.models.sparse import R_PENTOMINO, SparseTorus
from gol_tpu_torch.server import EngineServer as TServer
from gol_tpu_torch.sparse_engine import SparseEngine

from tests.server_harness import wait_port

torch.set_num_threads(2)

SIZE = 2**20
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("SER", "CONT", "SUB", "GOL_RULE", "GOL_SPARSE_SHARDS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")


@pytest.fixture
def pinned(monkeypatch):
    """Chunks of exactly 64 turns in both packages' engines, so their
    episodes, and thus their window geometry, are the same."""
    monkeypatch.setenv("GOL_MAX_CHUNK", "64")
    monkeypatch.setenv("GOL_CHUNK_TARGET", "1000")


def _seed():
    board = np.zeros((3, 3), dtype=np.uint8)
    for x, y in R_PENTOMINO:
        board[y, x] = 255
    return board


def _seed_dir(tmp_path):
    """The R-pentomino staged as the sparse seed board."""
    d = tmp_path / "images"
    d.mkdir(exist_ok=True)
    write_pgm(str(d / "seed.pgm"), _seed())
    return str(d)


def _oracle(turns):
    """An independent replay: the R-pentomino seeded as the engine seeds
    it (the (3, 3) seed board stamped centred: offset (SIZE - 3) // 2)."""
    off = (SIZE - 3) // 2
    t = SparseTorus(SIZE, [(x + off, y + off) for x, y in R_PENTOMINO],
                    device="cpu")
    t.run(turns)
    return t


def _torus_cells(window):
    pix, (ox, oy), _ = window
    ys, xs = np.nonzero(pix)
    return {(int((x + ox) % SIZE), int((y + oy) % SIZE))
            for x, y in zip(xs, ys)}


def _params(turns, size=SIZE):
    return Params(threads=1, image_width=size, image_height=size,
                  turns=turns)


def _jparams(turns, size=SIZE):
    return gol_tpu.Params(threads=1, image_width=size, image_height=size,
                          turns=turns)


def _final(evs, kind=ev.FinalTurnComplete):
    return [e for e in evs if isinstance(e, kind)][0]


# ------------------------------------------------------- the engine


def test_sparse_engine_run_and_queries():
    eng = SparseEngine(SIZE, device="cpu")
    win, turn = eng.server_distributor(_params(200), _seed())
    assert turn == 200
    want = _oracle(200)
    assert eng.alive_count() == (want.alive_count(), 200)
    window = eng.get_window()
    assert window[2] == 200
    assert _torus_cells(window) == set(want.alive_cells())
    np.testing.assert_array_equal(win, window[0])
    st = eng.stats()
    assert st["sparse"] and st["board"] == [SIZE, SIZE]
    assert st["rule"] == "B3/S23" and st["window"] == list(win.shape)
    assert st["origin"] == list(window[1]) and st["devices"] == 1
    assert eng.geometry() == {"kind": "sparse", "devices": 1, "size": SIZE}


def test_engine_matches_jax_engine(pinned):
    """Equal chunks give equal episodes: the two engines publish the same
    (alive, turn), window pixels, origin and stats geometry."""
    seed = _seed()
    ours, theirs = SparseEngine(SIZE, device="cpu"), JSparse(SIZE)
    for turns, start in ((130, 0), (300, 130)):
        world = seed if start == 0 else None
        a = ours.server_distributor(_params(turns), world, start_turn=start)
        b = theirs.server_distributor(_jparams(turns), world,
                                      start_turn=start)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1] == start + turns
        assert ours.alive_count() == theirs.alive_count()
        wo, wt = ours.get_window(), theirs.get_window()
        np.testing.assert_array_equal(wo[0], wt[0])
        assert wo[1:] == wt[1:]
        so, st = ours.stats(), theirs.stats()
        for key in ("board", "window", "origin", "alive", "alive_turn",
                    "sparse", "packed", "chunk", "rule"):
            assert so[key] == st[key], key


# A glider beside a blinker: a seed whose cells at any turn are known in
# closed form (the glider moves (+1, +1) every 4 turns, the blinker has
# period 2), so an unbounded run needs no replay to be checked.
GLIDER = ((1, 0), (2, 1), (0, 2), (1, 2), (2, 2))
BLINKER = ((0, 1), (1, 1), (2, 1))
GLIDER_DX = 10


def _glider_blinker_seed():
    board = np.zeros((3, GLIDER_DX + 3), dtype=np.uint8)
    for x, y in BLINKER:
        board[y, x] = 255
    for x, y in GLIDER:
        board[y, x + GLIDER_DX] = 255
    return board


def _glider_blinker_cells(turn):
    """Torus cells of `_glider_blinker_seed` stamped centred, at `turn`."""
    seed = _glider_blinker_seed()
    offx, offy = (SIZE - seed.shape[1]) // 2, (SIZE - seed.shape[0]) // 2
    small = np.zeros((16, 16), dtype=np.uint8)
    for x, y in GLIDER:
        small[y + 4, x + 4] = 1
    ys, xs = np.nonzero(run_turns_np(small, turn % 4))
    d = turn // 4
    cells = {(int(x) - 4 + GLIDER_DX + d + offx, int(y) - 4 + d + offy)
             for x, y in zip(xs, ys)}
    blinker = BLINKER if turn % 2 == 0 else ((1, 0), (1, 1), (1, 2))
    return cells | {(x + offx, y + offy) for x, y in blinker}


@pytest.mark.timeout(300)
def test_sparse_full_stack_ticker_pause_snapshot_quit(
        tmp_path, out_dir, monkeypatch):
    # 16-turn chunks bound the flag latency far under the 1 s sampling
    # period below.
    monkeypatch.setenv("GOL_MAX_CHUNK", "16")
    images_dir = tmp_path / "images"
    images_dir.mkdir()
    write_pgm(str(images_dir / "seed.pgm"), _glider_blinker_seed())
    engine = SparseEngine(SIZE, device="cpu")
    events_q, keys = queue.Queue(), queue.Queue()
    gol_tpu_torch.run(_params(10**8), events_q, keys, engine=engine,
                      images_dir=str(images_dir), out_dir=out_dir,
                      sparse=True)

    tick = None
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and tick is None:
        try:
            e = events_q.get(timeout=0.5)
        except queue.Empty:
            continue
        if isinstance(e, ev.AliveCellsCount):
            tick = e
    assert tick is not None, "sparse run emitted no AliveCellsCount"
    assert tick.cells_count == 8

    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and engine.alive_count()[1] == 0:
        time.sleep(0.2)

    # Pause parks the turn: two equal reads a second apart, then a
    # further 1.5 s without progress.
    keys.put("p")
    deadline = time.monotonic() + 60
    _, t1 = engine.alive_count()
    while time.monotonic() < deadline:
        time.sleep(1.0)
        _, t = engine.alive_count()
        if t == t1:
            break
        t1 = t
    time.sleep(1.5)
    assert engine.alive_count()[1] == t1, "turn advanced while paused"
    window = engine.get_window()
    assert window[2] == t1
    assert _torus_cells(window) == _glider_blinker_cells(t1)
    keys.put("p")

    # The snapshot is the live window, named by the window's dims.
    keys.put("s")
    snap = None
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and snap is None:
        try:
            e = events_q.get(timeout=0.5)
        except queue.Empty:
            continue
        if isinstance(e, ev.ImageOutputComplete):
            snap = e
    assert snap is not None
    board = read_pgm(os.path.join(out_dir, snap.filename))
    assert board.shape[0] < SIZE
    assert snap.filename == (f"{board.shape[1]}x{board.shape[0]}x"
                             f"{snap.completed_turns}.pgm")
    assert int((board != 0).sum()) == 8

    keys.put("q")
    fin = _final(ev.drain(events_q))
    assert 0 < fin.completed_turns < 10**8
    assert set(fin.alive) == _glider_blinker_cells(fin.completed_turns)
    assert fin.alive_count == 8


def test_sparse_live_view_is_refused(tmp_path, out_dir):
    q = queue.Queue()
    with pytest.warns(UserWarning, match="live view is not supported"):
        t = gol_tpu_torch.run(
            _params(40), q, images_dir=_seed_dir(tmp_path),
            out_dir=out_dir, live_view=True, sparse=True,
            engine=SparseEngine(SIZE, device="cpu"))
        evs = ev.drain(q)
        t.join(30)
    assert not [e for e in evs if isinstance(e, ev.CellsFlipped)]
    assert set(_final(evs).alive) == set(_oracle(40).alive_cells())


def test_sparse_detach_resume_in_process(tmp_path, out_dir, monkeypatch):
    """'q' then CONT=yes on the module-held sparse engine: exact
    continuation in torus coordinates."""
    from gol_tpu_torch import distributor

    monkeypatch.setattr(distributor, "_default_sparse", {})
    monkeypatch.setenv("GOL_MAX_CHUNK", "64")
    images_dir = _seed_dir(tmp_path)
    q1, keys1 = queue.Queue(), queue.Queue()
    t1 = gol_tpu_torch.run(_params(10**8), q1, keys1, images_dir=images_dir,
                           out_dir=out_dir, device="cpu", sparse=True)
    deadline = time.monotonic() + 60
    while not distributor._default_sparse and time.monotonic() < deadline:
        time.sleep(0.05)
    eng = next(iter(distributor._default_sparse.values()))
    while eng.alive_count()[1] == 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    keys1.put("q")
    t1.join(60)
    assert not t1.is_alive()
    t_detach = _final(ev.drain(q1)).completed_turns
    assert 0 < t_detach < 10**8

    total = t_detach + 150
    monkeypatch.setenv("CONT", "yes")
    q2 = queue.Queue()
    t2 = gol_tpu_torch.run(_params(total), q2, None, images_dir=images_dir,
                           out_dir=out_dir, device="cpu", sparse=True)
    fin2 = _final(ev.drain(q2))
    t2.join(30)
    assert t2.exception is None
    assert fin2.completed_turns == total
    assert set(fin2.alive) == set(_oracle(total).alive_cells())


def test_sparse_checkpoint_round_trip(tmp_path):
    eng = SparseEngine(SIZE, device="cpu")
    eng.server_distributor(_params(120), _seed())
    path = str(tmp_path / "sparse.npz")
    eng.save_checkpoint(path)
    with np.load(path) as z:
        assert z["sparse_words"].dtype == np.uint32

    eng2 = SparseEngine(SIZE, device="cpu")
    assert eng2.load_checkpoint(path) == 120
    assert eng2.get_window()[1:] == eng.get_window()[1:]
    eng2.server_distributor(_params(80), None, start_turn=120)
    assert eng2.alive_count() == (_oracle(200).alive_count(), 200)

    with pytest.raises(ValueError, match="torus"):
        SparseEngine(2**10, device="cpu").load_checkpoint(path)
    with pytest.raises(ValueError, match="rule"):
        SparseEngine(SIZE, rule=HIGHLIFE, device="cpu").load_checkpoint(path)


def test_resume_without_state_is_refused():
    eng = SparseEngine(SIZE, device="cpu")
    with pytest.raises(RuntimeError, match="no sparse state"):
        eng.server_distributor(_params(10), None)
    with pytest.raises(RuntimeError, match="no board"):
        eng.get_window()
    with pytest.raises(ValueError, match="no live cells"):
        eng.server_distributor(_params(10), np.zeros((3, 3), np.uint8))
    assert eng.alive_count() == (0, 0)


def test_sparse_remote_server_e2e(tmp_path, out_dir, monkeypatch):
    """A port sparse server drives the controller contract over TCP,
    detach and reattach included."""
    monkeypatch.setenv("GOL_MAX_CHUNK", "64")
    images_dir = _seed_dir(tmp_path)
    srv = TServer(port=0, host="127.0.0.1",
                  engine=SparseEngine(SIZE, device="cpu"))
    srv.start_background()
    try:
        monkeypatch.setenv("SER", f"127.0.0.1:{srv.port}")
        q1, keys1 = queue.Queue(), queue.Queue()
        t1 = gol_tpu_torch.run(_params(10**8), q1, keys1,
                               images_dir=images_dir, out_dir=out_dir,
                               sparse=True)
        probe = TRemote(f"127.0.0.1:{srv.port}")
        deadline = time.monotonic() + 60
        while probe.ping() == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        keys1.put("q")
        t1.join(60)
        assert not t1.is_alive()
        t_detach = _final(ev.drain(q1)).completed_turns
        assert 0 < t_detach < 10**8

        total = t_detach + 100
        monkeypatch.setenv("CONT", "yes")
        q2 = queue.Queue()
        gol_tpu_torch.run(_params(total), q2, None, images_dir=images_dir,
                          out_dir=out_dir, sparse=True)
        monkeypatch.delenv("CONT")
        fin2 = _final(ev.drain(q2))
        assert fin2.completed_turns == total
        assert set(fin2.alive) == set(_oracle(total).alive_cells())

        st = probe.stats()
        assert st["sparse"] and st["board"] == [SIZE, SIZE]
        window = probe.get_window()
        assert window[2] == total
        assert _torus_cells(window) == set(fin2.alive)
    finally:
        srv.shutdown()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_sparse_remote_size_mismatch_fails_fast(tmp_path, out_dir,
                                                monkeypatch):
    """A controller whose -w/-h disagree with the server's --sparse SIZE
    fails at attach, still delivering CLOSE."""
    srv = TServer(port=0, host="127.0.0.1",
                  engine=SparseEngine(SIZE, device="cpu"))
    srv.start_background()
    try:
        monkeypatch.setenv("SER", f"127.0.0.1:{srv.port}")
        q = queue.Queue()
        t = gol_tpu_torch.run(_params(10, 2**15), q, None,
                              images_dir=_seed_dir(tmp_path),
                              out_dir=out_dir, sparse=True)
        evs = ev.drain(q)
        t.join(30)
        assert not t.is_alive()
        assert isinstance(t.exception, ValueError)
        assert not [e for e in evs if isinstance(e, ev.FinalTurnComplete)]
    finally:
        srv.shutdown()


def test_sparse_get_view_and_stats_alive():
    """The dense engine's GetView contract: the full window under the cap,
    a block-any-alive reduction above it."""
    seed = np.zeros((8, 8), dtype=np.uint8)
    for x, y in R_PENTOMINO:
        seed[y + 2, x + 2] = 255
    eng = SparseEngine(SIZE, device="cpu")
    eng.server_distributor(_params(64), seed)
    full, turn, f = eng.get_view(1 << 62)
    assert f == (1, 1) and turn == 64
    np.testing.assert_array_equal(full, eng.get_world()[0])
    small, _, (fy, fx) = eng.get_view(4096)
    assert fy == fx and fy > 1 and small.size <= 4096
    h, w = full.shape
    hp, wp = -(-h // fy) * fy, -(-w // fx) * fx
    padded = np.zeros((hp, wp), dtype=full.dtype)
    padded[:h, :w] = full
    want = padded.reshape(hp // fy, fy, wp // fx, fx).max(axis=(1, 3))
    np.testing.assert_array_equal(small, want)
    assert eng.stats()["alive"] == eng.alive_count()[0]


@pytest.mark.parametrize("rule", ["B03/S23", "B0/S", "/2/3",
                                  "R5,C0,M1,S33..57,B34..45,NM"])
def test_sparse_engine_refuses_rules(rule):
    """B0 rules and other families fail at construction, so a server
    with such a --rule dies at startup."""
    from gol_tpu_torch.models import parse_rule

    with pytest.raises(ValueError, match="births on 0|life-like"):
        SparseEngine(1024, rule=parse_rule(rule), device="cpu")


def test_sparse_engine_refuses_bad_size():
    with pytest.raises(ValueError, match="multiple of 32"):
        SparseEngine(1000, device="cpu")


def test_shards_clamp_to_devices_and_name_a5(monkeypatch):
    """GOL_SPARSE_SHARDS clamps to the devices of the engine's type (one
    CPU); past the clamp a sharded window is ROADMAP A5."""
    monkeypatch.setenv("GOL_SPARSE_SHARDS", "4")
    assert SparseEngine(SIZE, device="cpu").stats()["devices"] == 1
    assert SparseEngine(SIZE, shards=3, device="cpu").geometry()[
        "devices"] == 1
    monkeypatch.setattr(tse, "_device_count", lambda dev: 8)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        SparseEngine(SIZE, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        SparseEngine(SIZE, shards=3, device="cpu")


def test_sparse_checkpoint_geometry_validated(tmp_path):
    """A checkpoint whose window exceeds the torus or whose origin is not
    word-aligned is refused."""
    def write(path, words, ox=0, oy=0, size=1024):
        np.savez(path, sparse_words=words, ox=ox, oy=oy, size=size,
                 turn=3, rulestring="B3/S23")

    eng = SparseEngine(1024, device="cpu")
    good = np.zeros((256, 8), dtype=np.uint32)
    good[10, 2] = 7
    p = str(tmp_path / "ok.npz")
    write(p, good)
    assert eng.load_checkpoint(p) == 3
    assert eng.alive_count() == (3, 3)

    for name, words, kw, match in (
            ("wide", np.zeros((256, 64), np.uint32), {}, "exceeds torus"),
            ("tall", np.zeros((2048, 8), np.uint32), {}, "exceeds torus"),
            ("skew", good, {"ox": 17}, "not word-aligned"),
            ("int", good.view(np.int32), {}, "bad words")):
        path = str(tmp_path / f"{name}.npz")
        write(path, words, **kw)
        with pytest.raises(ValueError, match=match):
            eng.load_checkpoint(path)
    np.savez(str(tmp_path / "dense.npz"), words=good, width=256, turn=1,
             rulestring="B3/S23")
    with pytest.raises(ValueError, match="not a sparse checkpoint"):
        eng.load_checkpoint(str(tmp_path / "dense.npz"))


def test_sparse_flag_protocol_direct():
    """Stranded-flag semantics match the dense engine: drain wipes a
    parked engine's queue; pause_only keeps a quit; kill_prog kills."""
    eng = SparseEngine(SIZE, device="cpu")
    eng.cf_put(FLAG_PAUSE)
    eng.cf_put(FLAG_QUIT)
    eng.drain_flags(pause_only=True)
    t0 = time.monotonic()
    _, turn = eng.server_distributor(_params(10**8), _seed())
    assert time.monotonic() - t0 < 60
    assert 0 <= turn < 10**8
    eng.kill_prog()
    with pytest.raises(EngineKilled):
        eng.alive_count()


def test_sparse_cli(tmp_path, monkeypatch):
    """`--sparse --rle rpentomino` runs end to end headless; the window's
    PGM is the JAX CLI's, byte for byte."""
    from gol_tpu.main import main as jmain
    from gol_tpu_torch.main import main as tmain

    outs = {}
    for name, cli, extra in (("torch", tmain, ["--device", "cpu"]),
                             ("jax", jmain, [])):
        out_dir = str(tmp_path / name)
        monkeypatch.setenv("GOL_OUT", out_dir)
        rc = cli(["-w", str(SIZE), "-h", str(SIZE), "--turns", "150",
                  "--rle", "rpentomino", "--sparse", "--headless", *extra])
        assert rc == 0
        [f] = [f for f in os.listdir(out_dir) if f.endswith("x150.pgm")]
        with open(os.path.join(out_dir, f), "rb") as fh:
            outs[name] = (f, fh.read())
    assert outs["torch"] == outs["jax"]


@pytest.mark.parametrize("argv,match", [
    (["-w", "1024", "-h", "2048"], "square"),
    (["-w", "1000", "-h", "1000"], "multiple of 32"),
    ([], None)])
def test_sparse_cli_refusals(argv, match, capsys):
    from gol_tpu_torch.main import main as tmain

    args = ["--sparse", "--headless", "--device", "cpu", "--turns", "1"]
    if argv:
        args += argv + ["--rle", "glider"]
    assert tmain(args) == 2
    err = capsys.readouterr().err
    assert (match or "needs --rle") in err


def test_sparse_engine_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SparseEngine(SIZE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SparseTorus(SIZE, R_PENTOMINO)


def test_sparse_server_without_cuda_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch.server", "--port", "0",
         "--host", "127.0.0.1", "--sparse", str(SIZE)],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=str(tmp_path))
    assert out.returncode != 0
    assert "serving on" not in out.stdout
    assert "device='cpu'" in out.stderr


# ------------------------------------------------- across the packages


def _write_ckpt(pkg, ck_dir, monkeypatch, turns=200):
    """Run `pkg`'s sparse engine from the seed with manifests every 64
    turns and a final one into `ck_dir`, then save the legacy npz there;
    returns (engine, manifest path, npz path)."""
    monkeypatch.setenv("GOL_CKPT", ck_dir)
    monkeypatch.setenv("GOL_CKPT_EVERY_TURNS", "64")
    if pkg == "jax":
        eng = JSparse(SIZE)
        eng.server_distributor(_jparams(turns), _seed())
    else:
        eng = SparseEngine(SIZE, device="cpu")
        eng.server_distributor(_params(turns), _seed())
    monkeypatch.delenv("GOL_CKPT")
    monkeypatch.delenv("GOL_CKPT_EVERY_TURNS")
    npz = os.path.join(ck_dir, f"sparse{SIZE}x{SIZE}.npz")
    eng.save_checkpoint(npz)
    turn, path, _ = mf.latest_checkpoint(ck_dir)
    assert turn == turns
    return eng, path, npz


@pytest.mark.parametrize("form", ["manifest", "npz"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_restore_across_packages(writer, form, tmp_path,
                                             monkeypatch, pinned):
    """A sparse checkpoint of either package restores in the other to the
    same window, origin and turn, and both continue to the same cells."""
    src, path, npz = _write_ckpt(writer, str(tmp_path / "ck"), monkeypatch)
    if writer == "jax":
        dst, resume = SparseEngine(SIZE, device="cpu"), _params
    else:
        dst, resume = JSparse(SIZE), _jparams
    target = path if form == "manifest" else npz
    assert dst.restore_run(target) == 200
    ws, wd = src.get_window(), dst.get_window()
    np.testing.assert_array_equal(ws[0], wd[0])
    assert ws[1:] == wd[1:]
    assert dst.alive_count() == src.alive_count()
    dst.server_distributor(resume(100), None, start_turn=200)
    src.server_distributor((_jparams if writer == "jax" else _params)(100),
                           None, start_turn=200)
    ws, wd = src.get_window(), dst.get_window()
    np.testing.assert_array_equal(ws[0], wd[0])
    assert ws[1:] == wd[1:] and wd[2] == 300
    assert _torus_cells(wd) == set(_oracle(300).alive_cells())


def test_manifests_agree_with_jax(tmp_path, monkeypatch, pinned):
    """The same run writes manifests of the same turns, repr, board,
    sparse block, payload shape and dtype, alive count and board hash in
    both packages, and each package verifies the other's."""
    _, tpath, _ = _write_ckpt("torch", str(tmp_path / "t"), monkeypatch)
    _, jpath, _ = _write_ckpt("jax", str(tmp_path / "j"), monkeypatch)
    for d in ("t", "j"):
        turns = [t for t, _, _ in mf.list_checkpoints(str(tmp_path / d))]
        # Checkpoint turns are cadence multiples and the final turn (the
        # writer may drop a superseded one; retention keeps three).
        assert turns[-1] == 200 and set(turns) <= {64, 128, 192, 200}
    tm, jm = mf.verify_manifest(jpath), jmf.verify_manifest(tpath)
    jm_own, tm_own = jmf.read_manifest(jpath), mf.read_manifest(tpath)
    assert tm == jm_own and jm == tm_own
    for key in ("turn", "rule", "repr", "board", "sparse", "dtype",
                "shape", "alive", "board_sha256", "mesh"):
        assert tm_own[key] == jm_own[key], key
    assert tm_own["repr"] == "sparse"
    assert tm_own["sparse"]["size"] == SIZE


def test_sparse_manifest_refused_by_dense_and_other_torus(tmp_path,
                                                          monkeypatch):
    """Geometry: a sparse manifest onto the dense engine or another torus
    is refused unless resharded; a torus-sized dense board reshards onto
    a sparse engine."""
    from gol_tpu_torch import ckpt
    from gol_tpu_torch.engine import Engine

    _, path, _ = _write_ckpt("torch", str(tmp_path / "ck"), monkeypatch,
                             turns=64)
    with pytest.raises(ckpt.GeometryMismatch, match="repr sparse"):
        Engine(device="cpu").restore_run(path)
    with pytest.raises(ckpt.GeometryMismatch, match="sparse torus"):
        SparseEngine(2**19, device="cpu").restore_run(path)

    # A dense 256² checkpoint reshards onto a 256-torus sparse engine.
    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "dense"))
    dense = Engine(device="cpu")
    board = np.zeros((256, 256), np.uint8)
    for x, y in R_PENTOMINO:
        board[120 + y, 120 + x] = 255
    dense.server_distributor(_params(30, 256), board)
    dpath, _ = dense.checkpoint_now()
    sp = SparseEngine(256, device="cpu")
    with pytest.raises(ckpt.GeometryMismatch, match="sparse engine"):
        sp.restore_run(dpath)
    assert sp.restore_run(dpath, reshard=True) == 30
    pix, origin, _ = sp.get_window()
    assert origin == (0, 0) and pix.shape == (256, 256)
    np.testing.assert_array_equal(pix, dense.get_world()[0])
    sp.server_distributor(_params(40, 256), None, start_turn=30)
    dense.server_distributor(_params(40, 256), dense.get_world()[0],
                             start_turn=30)
    np.testing.assert_array_equal(sp.get_window()[0], dense.get_world()[0])


def _raw_get(port, method, caps):
    """(reply header without its trace context, payload bytes) of one
    `method` request advertising `caps`."""
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        jw.send_msg(s, {"method": method, "caps": caps})
        header, _ = tw.recv_head_raw(s)
        n = tw.payload_nbytes(header)
        buf = bytearray()
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            assert chunk
            buf.extend(chunk)
    finally:
        s.close()
    header.pop("tc", None)
    return header, bytes(buf)


@pytest.fixture
def sparse_servers(pinned):
    made = {"jax": JServer(port=0, host="127.0.0.1", engine=JSparse(SIZE)),
            "torch": TServer(port=0, host="127.0.0.1",
                             engine=SparseEngine(SIZE, device="cpu"))}
    for srv in made.values():
        srv.start_background()
    yield made
    for srv in made.values():
        srv.shutdown()


def test_get_window_frames_equal_byte_for_byte(sparse_servers):
    s = sparse_servers
    s["jax"].engine.server_distributor(_jparams(150), _seed())
    s["torch"].engine.server_distributor(_params(150), _seed())
    for caps in (["packed"], [], ["packed", "zlib"],
                 ["f32", "packed", "xrle", "zlib"]):
        hj, pj = _raw_get(s["jax"].port, "GetWindow", caps)
        ht, pt = _raw_get(s["torch"].port, "GetWindow", caps)
        assert ht == hj, caps
        assert pt == pj, caps
        assert hj["turn"] == 150 and "ox" in hj and "oy" in hj
        # GetWorld of a sparse engine is its window, too (packed words
        # straight from the device for a CAP_PACKED peer).
        assert _raw_get(s["torch"].port, "GetWorld", caps) == _raw_get(
            s["jax"].port, "GetWorld", caps), caps


@pytest.mark.parametrize("side", ["torch-controller/jax-server",
                                  "jax-controller/torch-server"])
def test_controller_drives_the_other_sparse_server(side, sparse_servers,
                                                   tmp_path, out_dir,
                                                   monkeypatch):
    srv = sparse_servers["jax" if side.endswith("jax-server") else "torch"]
    monkeypatch.setenv("SER", f"127.0.0.1:{srv.port}")
    images_dir = _seed_dir(tmp_path)
    q = queue.Queue()
    if side.startswith("torch"):
        t = gol_tpu_torch.run(_params(200), q, images_dir=images_dir,
                              out_dir=out_dir, sparse=True)
        evs, final_t = ev.drain(q), ev.FinalTurnComplete
    else:
        t = gol_tpu.run(_jparams(200), q, None, images_dir=images_dir,
                        out_dir=out_dir, sparse=True)
        evs, final_t = jev.drain(q), jev.FinalTurnComplete
    t.join(60)
    assert not t.is_alive()
    final = _final(evs, final_t)
    assert final.completed_turns == 200
    assert set(final.alive) == set(_oracle(200).alive_cells())
    # The other package's client reads the same window as the in-process
    # engine holds.
    client = (TRemote if side.startswith("torch") else JRemote)(
        f"127.0.0.1:{srv.port}")
    got = client.get_window()
    want = srv.engine.get_window()
    np.testing.assert_array_equal(got[0], want[0])
    assert tuple(got[1]) == tuple(want[1]) and got[2] == want[2] == 200


@pytest.mark.timeout(300)
def test_sparse_sigkill_restart_resume_e2e(tmp_path, out_dir, monkeypatch):
    """`python -m gol_tpu_torch.server --sparse` SIGKILLed mid-run; a
    replacement restores the periodic sparse autosave (--resume); the
    controller reattaches to the engine-held window and finishes on the
    oracle's cells."""
    from gol_tpu_torch.distributor import distributor

    ckpt_dir = str(tmp_path / "ckpt")
    ckpt_path = os.path.join(ckpt_dir, f"sparse{SIZE}x{SIZE}.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update({"GOL_CKPT": ckpt_dir, "GOL_CKPT_EVERY": "0.3",
                "GOL_MAX_CHUNK": "64"})

    def spawn(port, *extra):
        return subprocess.Popen(
            [sys.executable, "-u", "-m", "gol_tpu_torch.server", "--port",
             str(port), "--host", "127.0.0.1", "--device", "cpu",
             "--sparse", str(SIZE), *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(tmp_path))

    images_dir = _seed_dir(tmp_path)
    proc1, proc2 = spawn(0), None
    collected = []
    closed = threading.Event()
    try:
        port = wait_port(proc1)
        assert port, "sparse server never announced its port"
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
            target=distributor, args=(_params(10**8), q, keys),
            kwargs=dict(images_dir=images_dir, out_dir=out_dir,
                        sparse=True), daemon=True)
        ctrl.start()
        deadline = time.monotonic() + 90
        while not os.path.exists(ckpt_path):
            assert time.monotonic() < deadline, "no sparse autosave"
            time.sleep(0.2)
        time.sleep(1.0)
        os.kill(proc1.pid, signal.SIGKILL)
        proc1.wait(10)
        deadline = time.monotonic() + 60
        while not any(isinstance(e, ev.EngineLost) for e in collected):
            assert time.monotonic() < deadline, "EngineLost never emitted"
            assert ctrl.is_alive()
            time.sleep(0.1)

        proc2 = spawn(port, "--resume", ckpt_path)
        assert wait_port(proc2) == port
        deadline = time.monotonic() + 120
        while not any(isinstance(e, ev.EngineReattached)
                      for e in collected):
            assert time.monotonic() < deadline, "never reattached"
            assert ctrl.is_alive()
            time.sleep(0.2)
        reatt = [e for e in collected
                 if isinstance(e, ev.EngineReattached)][0]
        assert reatt.completed_turns > 0  # the held window, not the seed
        keys.put("q")
        ctrl.join(60)
        assert not ctrl.is_alive()
        assert closed.wait(10)
        final = _final(collected)
        assert final.completed_turns > 0
        assert set(final.alive) == set(
            _oracle(final.completed_turns).alive_cells())
    finally:
        for proc in (proc1, proc2):
            if proc is not None and proc.poll() is None:
                proc.terminate()
                proc.wait(10)
