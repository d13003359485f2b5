"""Interactive control through the torch port's controller, as
`tests/test_control.py` holds the JAX package to it: snapshot ('s'),
pause/resume ('p'), detach ('q') + reattach (`CONT=yes`), kill ('k')."""

import os
import queue
import time

import numpy as np
import pytest
import torch

import gol_tpu_torch
from gol_tpu_torch import Params, distributor, events as ev
from gol_tpu_torch import engine as engine_mod
from gol_tpu_torch.engine import Engine, EngineKilled
from gol_tpu_torch.io.pgm import read_pgm
from gol_tpu_torch.ops.reference import run_turns_np

torch.set_num_threads(2)


def _wait_for(events_q, kind, timeout=30):
    end = time.monotonic() + timeout
    seen = []
    while time.monotonic() < end:
        try:
            e = events_q.get(timeout=0.5)
        except queue.Empty:
            continue
        seen.append(e)
        if isinstance(e, kind):
            return e, seen
    raise AssertionError(f"no {kind.__name__} within {timeout}s: {seen}")


def _drain_to_close(events_q, timeout=30):
    end = time.monotonic() + timeout
    out = []
    while time.monotonic() < end:
        try:
            e = events_q.get(timeout=0.5)
        except queue.Empty:
            continue
        if e is ev.CLOSE:
            return out
        out.append(e)
    raise AssertionError("events never closed")


def _start(p, images_dir, out_dir, engine, keys=None):
    events_q = queue.Queue()
    t = gol_tpu_torch.run(p, events_q, keys, engine=engine,
                          images_dir=images_dir, out_dir=out_dir)
    return t, events_q


def _oracle(images_dir, size, turns):
    b = read_pgm(os.path.join(images_dir, f"{size}x{size}.pgm")) != 0
    return run_turns_np(b.astype(np.uint8), turns)


def test_snapshot_keypress(images_dir, out_dir, monkeypatch):
    monkeypatch.setenv("GOL_MAX_CHUNK", "8")
    p = Params(threads=1, image_width=64, image_height=64, turns=10**8)
    keys = queue.Queue()
    _, events_q = _start(p, images_dir, out_dir, Engine(device="cpu"), keys)
    time.sleep(1.0)
    keys.put("s")
    e, _ = _wait_for(events_q, ev.ImageOutputComplete)
    assert e.filename == f"64x64x{e.completed_turns}.pgm"
    snap = read_pgm(os.path.join(out_dir, e.filename))
    np.testing.assert_array_equal((snap != 0).astype(np.uint8),
                                  _oracle(images_dir, 64, e.completed_turns))
    keys.put("q")
    _drain_to_close(events_q)


def test_pause_resume(images_dir, out_dir):
    p = Params(threads=1, image_width=64, image_height=64, turns=10**8)
    keys = queue.Queue()
    _, events_q = _start(p, images_dir, out_dir, Engine(device="cpu"), keys)
    time.sleep(0.5)
    keys.put("p")
    e, _ = _wait_for(events_q, ev.StateChange)
    while e.new_state != ev.State.PAUSED:
        e, _ = _wait_for(events_q, ev.StateChange)
    time.sleep(1.0)
    keys.put("p")
    e, _ = _wait_for(events_q, ev.StateChange)
    while e.new_state != ev.State.EXECUTING:
        e, _ = _wait_for(events_q, ev.StateChange)
    keys.put("q")
    evs = _drain_to_close(events_q)
    assert any(isinstance(x, ev.FinalTurnComplete) for x in evs)


def test_pause_actually_stops_turns(images_dir, out_dir, monkeypatch):
    monkeypatch.setenv("GOL_MAX_CHUNK", "8")
    engine = Engine(device="cpu")
    p = Params(threads=1, image_width=64, image_height=64, turns=10**8)
    keys = queue.Queue()
    _, events_q = _start(p, images_dir, out_dir, engine, keys)
    time.sleep(1.0)
    keys.put("p")
    deadline = time.monotonic() + 60
    t1, stable_since = None, None
    while time.monotonic() < deadline:
        _, t = engine.alive_count()
        if t == t1:
            if stable_since is None:
                stable_since = time.monotonic()
            elif time.monotonic() - stable_since >= 2.5:
                break
        else:
            t1, stable_since = t, None
        time.sleep(0.5)
    else:
        raise AssertionError("engine never quiesced after pause")
    time.sleep(1.5)
    _, t2 = engine.alive_count()
    assert t1 == t2, f"turn advanced while paused: {t1} -> {t2}"
    keys.put("p")
    time.sleep(1.5)
    _, t3 = engine.alive_count()
    assert t3 > t2, "turn did not advance after resume"
    keys.put("q")
    _drain_to_close(events_q)


def test_quit_latency_bound(images_dir, out_dir, monkeypatch):
    """A quit lands within about (pipeline depth + 1) x chunk wall: with
    a 0.05 s target the chunk adapter keeps chunks short; asserted at 5 s
    to absorb a loaded host."""
    monkeypatch.setenv("GOL_CHUNK_TARGET", "0.05")
    monkeypatch.setenv("GOL_MAX_CHUNK", "4096")
    engine = Engine(device="cpu")
    p = Params(threads=1, image_width=64, image_height=64, turns=10**9)
    keys = queue.Queue()
    t, events_q = _start(p, images_dir, out_dir, engine, keys)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if engine.alive_count()[1] > 1000:
            break
        time.sleep(0.2)
    t0 = time.monotonic()
    keys.put("q")
    t.join(30)
    latency = time.monotonic() - t0
    assert not t.is_alive(), "quit never completed"
    assert latency < 5.0, f"quit took {latency:.1f}s"
    evs = _drain_to_close(events_q)
    assert any(isinstance(x, ev.FinalTurnComplete) for x in evs)


def test_final_event_cell_list_capped(images_dir, out_dir, monkeypatch):
    monkeypatch.setenv("GOL_MAX_EVENT_CELLS", "1000")
    p = Params(threads=1, image_width=64, image_height=64, turns=3)
    _, events_q = _start(p, images_dir, out_dir, Engine(device="cpu"))
    evs = _drain_to_close(events_q)
    fin = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    assert fin.alive == ()
    assert fin.alive_count == int(_oracle(images_dir, 64, 3).sum())
    assert fin.count() == fin.alive_count


def test_detach_and_resume_matches_uninterrupted(images_dir, out_dir,
                                                 monkeypatch):
    monkeypatch.setattr(engine_mod, "MAX_CHUNK", 8)
    engine = Engine(device="cpu")
    p = Params(threads=1, image_width=64, image_height=64, turns=10**8)
    keys = queue.Queue()
    _, events_q = _start(p, images_dir, out_dir, engine, keys)
    time.sleep(0.75)
    keys.put("q")
    evs = _drain_to_close(events_q)
    t_detach = [e for e in evs
                if isinstance(e, ev.FinalTurnComplete)][0].completed_turns
    assert t_detach < 10**8

    target = t_detach + 50
    monkeypatch.setenv("CONT", "yes")
    p2 = Params(threads=1, image_width=64, image_height=64, turns=target)
    _, events_q2 = _start(p2, images_dir, out_dir, engine)
    evs2 = _drain_to_close(events_q2)
    final2 = [e for e in evs2 if isinstance(e, ev.FinalTurnComplete)][0]
    assert final2.completed_turns == target
    got = np.zeros((64, 64), dtype=np.uint8)
    for x, y in final2.alive:
        got[y, x] = 1
    np.testing.assert_array_equal(got, _oracle(images_dir, 64, target))


def test_kill(images_dir, out_dir):
    engine = Engine(device="cpu")
    p = Params(threads=1, image_width=16, image_height=16, turns=10**8)
    keys = queue.Queue()
    _, events_q = _start(p, images_dir, out_dir, engine, keys)
    time.sleep(0.5)
    keys.put("k")
    evs = _drain_to_close(events_q)
    assert any(isinstance(x, ev.FinalTurnComplete) for x in evs)
    with pytest.raises(EngineKilled):
        engine.alive_count()


def test_resume_arithmetic_zero_remaining(images_dir, out_dir,
                                          monkeypatch):
    """CONT=yes with the turns already reached runs no further turn."""
    engine = Engine(device="cpu")
    p = Params(threads=1, image_width=16, image_height=16, turns=20)
    _drain_to_close(_start(p, images_dir, out_dir, engine)[1])
    monkeypatch.setenv("CONT", "yes")
    p2 = Params(threads=1, image_width=16, image_height=16, turns=10)
    evs = _drain_to_close(_start(p2, images_dir, out_dir, engine)[1])
    final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    assert final.completed_turns == 20


def test_default_engine_detach_and_reattach(images_dir, out_dir,
                                            monkeypatch):
    """Without an injected engine, `run(..., device="cpu")` keeps one
    process-local engine between runs, which is what CONT=yes reattaches
    to."""
    monkeypatch.setattr(distributor, "_default_engine", None)
    p = Params(threads=1, image_width=64, image_height=64, turns=30)
    q1 = queue.Queue()
    gol_tpu_torch.run(p, q1, None, images_dir=images_dir, out_dir=out_dir,
                      device="cpu")
    _drain_to_close(q1)
    first = distributor._default_engine
    assert first is not None and first.device.type == "cpu"
    monkeypatch.setenv("CONT", "yes")
    q2 = queue.Queue()
    gol_tpu_torch.run(Params(threads=1, image_width=64, image_height=64,
                             turns=40), q2, None, images_dir=images_dir,
                      out_dir=out_dir, device="cpu")
    evs = _drain_to_close(q2)
    assert distributor._default_engine is first
    final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    assert final.completed_turns == 40
    assert final.count() == int(_oracle(images_dir, 64, 40).sum())


def test_engine_stats_and_flags():
    engine = Engine(device="cpu")
    assert engine.ping() == 0
    with pytest.raises(ValueError):
        engine.cf_put(4)
    engine.cf_put(engine_mod.FLAG_PAUSE)
    engine.cf_put(engine_mod.FLAG_QUIT)
    engine.drain_flags(pause_only=True)
    assert list(engine._flags.queue) == [engine_mod.FLAG_QUIT]
    assert engine.abort_run("nobody") is False
    world = np.zeros((8, 64), dtype=np.uint8)
    world[3, 10:13] = 255  # a blinker
    px, turn = engine.server_distributor(
        Params(threads=1, image_width=64, image_height=8, turns=5), world)
    assert turn == 1  # the kept quit flag stops the run at its first chunk
    px, turn = engine.server_distributor(
        Params(threads=1, image_width=64, image_height=8, turns=5), world,
        start_turn=1)
    assert turn == 6 and np.count_nonzero(px) == 3
    stats = engine.stats()
    assert stats["board"] == [8, 64] and stats["packed"]
    assert stats["alive"] == 3 and stats["alive_turn"] == 6
    engine.kill_prog()
    with pytest.raises(EngineKilled):
        engine.ping()
