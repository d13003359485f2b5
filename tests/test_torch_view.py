"""The port's live view (`run(..., live_view=True)`, `Engine.get_view`,
`sdl.Window`) and the CLI's `--live`, held against `gol_tpu`'s: the
counterparts of `tests/test_view.py` on `Engine(device="cpu")`.

  * the live feed: replaying every CellsFlipped onto an empty window
    gives, at each TurnComplete(t), the numpy oracle's board at turn t;
  * get_view's downsampled frames for every repr equal `gol_tpu`'s
    `Engine.get_view` on the same board;
  * above GOL_LIVE_MAX_CELLS the live loop never moves a full board;
  * the window's pixel ops equal `gol_tpu`'s;
  * `python -m gol_tpu_torch --headless --live --device cpu` writes
    `gol_tpu`'s PGM bytes.

Tolerance: none."""

import os
import pathlib
import queue
import shutil
import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

import gol_tpu
from gol_tpu import events as jev
from gol_tpu.engine import Engine as JaxEngine
from gol_tpu.models.generations import GenerationsRule as JGenerationsRule
from gol_tpu.ops.reference import run_turns_np
from gol_tpu.sdl.window import Window as JWindow

import gol_tpu_torch
from gol_tpu_torch import Params, events as ev
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.io.pgm import read_pgm
from gol_tpu_torch.models.generations import GenerationsRule, to_pixels_gen
from gol_tpu_torch.sdl import loop
from gol_tpu_torch.sdl.window import Window

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent


class _Watch(queue.Queue):
    """An events queue that signals the first TurnComplete past turn 0,
    so a test quits a run once the live feed has drawn a stepped board,
    whatever the host's load."""

    def __init__(self):
        super().__init__()
        self.moved = threading.Event()

    def put(self, item, block=True, timeout=None):
        super().put(item, block, timeout)
        if isinstance(item, ev.TurnComplete) and item.completed_turns > 0:
            self.moved.set()


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("SER", "CONT", "SUB", "GOL_LIVE_MAX_CELLS", "GOL_FUSE_K",
              "GOL_MESH"):
        monkeypatch.delenv(k, raising=False)


def test_live_view_events(images_dir, out_dir):
    """16², unbounded, 'q' once a frame past turn 0 arrived: at every
    TurnComplete(t) the window the CellsFlipped diffs drew equals the
    oracle's board at t."""
    p = Params(threads=1, image_width=16, image_height=16, turns=10**8)
    events_q, keys = _Watch(), queue.Queue()
    gol_tpu_torch.run(p, events_q, keys, engine=Engine(device="cpu"),
                      images_dir=images_dir, out_dir=out_dir,
                      live_view=True)
    assert events_q.moved.wait(60), "no live frame past turn 0"
    keys.put("q")
    evs = ev.drain(events_q)
    win = Window(16, 16)
    board = (read_pgm(os.path.join(images_dir, "16x16.pgm")) != 0)
    board, at, frames = board.astype(np.uint8), 0, 0
    for e in evs:
        if isinstance(e, ev.CellsFlipped):
            for cell in e.cells:
                win.flip_pixel(*cell)
        elif isinstance(e, ev.TurnComplete):
            t = e.completed_turns
            assert t > at or (t == at == 0)
            board, at = run_turns_np(board, t - at), t
            np.testing.assert_array_equal(win._pixels, board != 0,
                                          err_msg=f"turn {t}")
            frames += 1
    assert frames >= 1 and at > 0
    final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    assert at <= final.completed_turns


def _block_brightest_np(px, f):
    """Independent numpy oracle: brightest pixel of each f x f block."""
    h, w = px.shape
    hp, wp = -(-h // f) * f, -(-w // f) * f
    p = np.zeros((hp, wp), dtype=px.dtype)
    p[:h, :w] = px
    return p.reshape(hp // f, f, wp // f, f).max(axis=(1, 3))


def test_get_view_downsamples_all_reprs():
    """Full board under the cap (factors (1, 1)); above it, the same
    block-brightest frame and factors as gol_tpu's engine, and the numpy
    oracle: packed (with gol_tpu's 3-shard pad path), u8, gen8, gen3."""
    rng = np.random.default_rng(77)

    def check(eng, jeng, world, h, w, threads=1):
        eng.server_distributor(Params(threads=threads, image_width=w,
                                      image_height=h, turns=3), world)
        jeng.server_distributor(gol_tpu.Params(
            threads=threads, image_width=w, image_height=h, turns=3), world)
        full, turn, f = eng.get_view(h * w)
        assert f == (1, 1) and turn == 3
        np.testing.assert_array_equal(full, eng.get_world()[0])
        np.testing.assert_array_equal(full, np.asarray(jeng.get_world()[0]))
        for cap in ((h * w) // 16, (h * w) // 5):
            view, turn, (fy, fx) = eng.get_view(cap)
            jview, jturn, jf = jeng.get_view(cap)
            assert (turn, (fy, fx)) == (jturn, tuple(jf)) and fy == fx > 1
            assert view.shape == (-(-h // fy), -(-w // fx))
            assert view.size <= cap
            np.testing.assert_array_equal(view, np.asarray(jview))
            np.testing.assert_array_equal(
                view, _block_brightest_np(full, fy))

    w0 = (rng.random((64, 64)) < 0.3).astype(np.uint8) * 255
    check(Engine(device="cpu"), JaxEngine(), w0, 64, 64)
    w1 = (rng.random((17, 64)) < 0.3).astype(np.uint8) * 255
    check(Engine(device="cpu"), JaxEngine(), w1, 17, 64, threads=3)
    w2 = (rng.random((40, 36)) < 0.3).astype(np.uint8) * 255
    check(Engine(device="cpu"), JaxEngine(), w2, 40, 36)
    for rs, shape in (("345/2/4", (48, 36)), ("/2/3", (48, 64))):
        rule = GenerationsRule(rs)
        s = rng.integers(0, rule.states, size=shape).astype(np.uint8)
        check(Engine(rule=rule, device="cpu"),
              JaxEngine(rule=JGenerationsRule(rs)),
              to_pixels_gen(s, rule), *shape)


def test_live_view_guard_never_moves_full_board(
        images_dir, out_dir, monkeypatch, tmp_path):
    """Above GOL_LIVE_MAX_CELLS the live loop polls get_view (frames
    within the cap, one warning) and never get_world."""
    calls = {"world": 0, "view": 0, "max_frame": 0}

    class SpyEngine(Engine):
        def get_world(self):
            calls["world"] += 1
            return super().get_world()

        def get_view(self, max_cells):
            calls["view"] += 1
            out = super().get_view(max_cells)
            calls["max_frame"] = max(calls["max_frame"], out[0].size)
            return out

    imgs = tmp_path / "images"
    imgs.mkdir()
    shutil.copy(os.path.join(images_dir, "64x64.pgm"), imgs / "64x64.pgm")
    monkeypatch.setenv("GOL_LIVE_MAX_CELLS", "256")
    p = Params(threads=1, image_width=64, image_height=64, turns=10**8)
    events_q, keys = _Watch(), queue.Queue()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        gol_tpu_torch.run(p, events_q, keys, engine=SpyEngine(device="cpu"),
                          images_dir=str(imgs), out_dir=out_dir,
                          live_view=True)
        assert events_q.moved.wait(60), "no live frame past turn 0"
        keys.put("q")
        evs = ev.drain(events_q)
    live_warns = [w for w in rec if "downsampled" in str(w.message)]
    assert len(live_warns) == 1, "exactly one downsample warning"
    assert calls["view"] > 0, "guarded live view never polled get_view"
    assert calls["world"] == 0, "live view moved the full board"
    assert calls["max_frame"] <= 256, "frame exceeded the cap"
    flips = [e for e in evs if isinstance(e, ev.CellsFlipped)]
    assert flips
    for e in flips:
        for x, y in e.cells:
            assert 0 <= x < 16 and 0 <= y < 16  # view-space coords


def test_loop_start_draws_the_downsampled_feed(
        images_dir, out_dir, monkeypatch, tmp_path):
    """Above GOL_LIVE_MAX_CELLS `sdl.loop.start` opens a window of the
    view's size, and at every TurnComplete(t) the CellsFlipped diffs it
    drew equal the block-brightest view of the oracle's board at t; the
    window's 'q' ends the run."""
    frames, quit_sent = [], []

    class Recorder(Window):
        def render_frame(self, status: str = "") -> None:
            frames.append((int(status.split()[-1]), self._pixels.copy()))
            super().render_frame(status)

        def poll_event(self):
            if not quit_sent and sum(t > 0 for t, _ in frames) >= 3:
                quit_sent.append(True)
                return "q"
            return None

    imgs = tmp_path / "images"
    imgs.mkdir()
    shutil.copy(os.path.join(images_dir, "64x64.pgm"), imgs / "64x64.pgm")
    monkeypatch.setenv("GOL_LIVE_MAX_CELLS", "256")
    monkeypatch.setenv("GOL_HEADLESS", "1")
    monkeypatch.setattr(loop, "Window", Recorder)
    p = Params(threads=1, image_width=64, image_height=64, turns=10**8)
    events_q, keys = queue.Queue(), queue.Queue()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = gol_tpu_torch.run(p, events_q, keys, engine=Engine(device="cpu"),
                              images_dir=str(imgs), out_dir=out_dir,
                              live_view=True)
        loop.start(p, events_q, keys)
    t.join(60)
    assert not t.is_alive() and t.exception is None
    assert quit_sent, "the run closed before three frames past turn 0"
    board = (read_pgm(str(imgs / "64x64.pgm")) != 0).astype(np.uint8)
    at = 0
    for turn, px in frames:
        assert px.shape == (16, 16)
        assert turn > at or (turn == at == 0)
        board, at = run_turns_np(board, turn - at), turn
        np.testing.assert_array_equal(
            px, _block_brightest_np(board, 4) != 0, err_msg=f"turn {turn}")


def test_window_pixel_ops():
    ops = [("flip", 3, 2), ("flip", 3, 2), ("set", 9, 9, True),
           ("flip", 0, 7), ("set", -1, -1, True), ("set", 0, 7, False),
           ("flip", 12, 4)]
    windows = []
    for W in (Window, JWindow):
        win = W(8, 8)
        for op, *args in ops:
            (win.flip_pixel if op == "flip" else win.set_pixel)(*args)
        windows.append(win)
    np.testing.assert_array_equal(windows[0]._pixels, windows[1]._pixels)
    win = windows[0]
    assert not win._pixels[2, 3]  # flipped twice
    assert win._pixels[1, 1]  # (9, 9) wraps
    assert win._pixels[7, 7]  # (-1, -1) wraps
    assert not win._pixels[7, 0] and win._pixels[4, 4]
    board = np.zeros((8, 8), dtype=np.uint8)
    board[5, 6] = 255
    win.set_board(board)
    assert win._pixels[5, 6] and win._pixels.sum() == 1
    with pytest.raises(ValueError):
        win.set_board(np.zeros((4, 8), dtype=np.uint8))


def test_cli_headless_live(images_dir, tmp_path):
    """`python -m gol_tpu_torch -w 64 -h 64 --turns 100 --headless --live
    --device cpu` exits 0 and writes gol_tpu's PGM bytes."""
    out = tmp_path / "out"
    env = {"GOL_IMAGES": images_dir, "GOL_OUT": str(out),
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(tmp_path), "PYTHONPATH": str(REPO)}
    res = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", "-w", "64", "-h", "64",
         "--turns", "100", "--headless", "--live", "--device", "cpu"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Completed Turns 100" in res.stdout
    jout = tmp_path / "jout"
    events_q = queue.Queue()
    t = gol_tpu.run(gol_tpu.Params(threads=1, image_width=64,
                                   image_height=64, turns=100),
                    events_q, None, engine=JaxEngine(),
                    images_dir=images_dir, out_dir=str(jout))
    while events_q.get(timeout=120) is not jev.CLOSE:
        pass
    t.join(60)
    assert not t.is_alive() and t.exception is None
    got = (out / "64x64x100.pgm").read_bytes()
    assert got == (jout / "64x64x100.pgm").read_bytes()
    assert got == (REPO / "check" / "images" / "64x64x100.pgm").read_bytes()
