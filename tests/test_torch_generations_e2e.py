"""The Generations slice of the torch port end to end — `gol_tpu_torch.run`
on a CPU engine with Brian's Brain, Star Wars and a uint8-only rule —
against the JAX package's own output: final firing sets and counts,
gray-encoded PGM bytes, ticker counts, pause and snapshot, detach and
resume, the live view, and state carried from a JAX engine into a port
engine. Integer boards: bit-exact."""

import os
import queue
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gol_tpu
from gol_tpu import events as jev
from gol_tpu.engine import Engine as JaxEngine
from gol_tpu.io.pgm import write_pgm as jwrite_pgm
from gol_tpu.models import generations as jg

import gol_tpu_torch
from gol_tpu_torch import Params, distributor, events as ev
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.io.pgm import read_pgm
from gol_tpu_torch.models import generations as tg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("CONT", "GOL_RULE", "GOL_MAX_CHUNK"):
        monkeypatch.delenv(k, raising=False)


def _state(h, w, states, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, states, size=(h, w)).astype(np.uint8)


def _seed_images(tmp_path, rule, w, h, seed=5):
    """A gray input PGM staged as images/WxH.pgm, written by the JAX
    package; returns (images dir, state board)."""
    st = _state(h, w, rule.states, seed)
    d = tmp_path / "images"
    d.mkdir(exist_ok=True)
    jrule = jg.GenerationsRule(rule.rulestring)
    jwrite_pgm(str(d / f"{w}x{h}.pgm"), jg.to_pixels_gen(st, jrule),
               levels=tuple(jg.gray_levels(jrule).tolist()))
    return str(d), st


def _replay(st, turns, rule):
    """The JAX package's uint8 state board after `turns` turns."""
    return np.asarray(jg.run_turns(jnp.asarray(st), turns,
                                   jg.GenerationsRule(rule.rulestring)))


def _firing(board):
    ys, xs = np.nonzero(board == 1)
    return set(zip(xs.tolist(), ys.tolist()))


def _levels(rule):
    return tuple(tg.gray_levels(rule).tolist())


def _wait_for(events_q, kind, timeout=30):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        try:
            e = events_q.get(timeout=0.5)
        except queue.Empty:
            continue
        if isinstance(e, kind):
            return e
    raise AssertionError(f"no {kind.__name__} within {timeout}s")


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


@pytest.mark.parametrize("s,w", [("/2/3", 64), ("/2/3", 48),
                                 ("345/2/4", 64), ("23/36/8", 64)])
def test_final_pgm_and_firing_set_match_jax(s, w, tmp_path):
    """gen3 (/2/3 at 64), gen8 (the rest): the final PGM bytes equal what
    `gol_tpu.run` writes for the same gray input, and the final event
    holds the JAX package's firing set."""
    rule = tg.GenerationsRule(s)
    images, st = _seed_images(tmp_path, rule, w, 32)
    turns = 30
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    eng = Engine(device="cpu", rule=rule)
    t = gol_tpu_torch.run(Params(threads=1, image_width=w, image_height=32,
                                 turns=turns), pq := queue.Queue(),
                          engine=eng, images_dir=images, out_dir=port_out,
                          rule=rule)
    evs = ev.drain(pq)
    t.join(30)
    assert t.exception is None
    assert eng._repr == ("gen3" if (rule.states, w) == (3, 64) else "gen8")
    jrule = jg.GenerationsRule(s)
    jq = queue.Queue()
    gol_tpu.run(gol_tpu.Params(threads=1, image_width=w, image_height=32,
                               turns=turns), jq, None,
                engine=JaxEngine(rule=jrule), images_dir=images,
                out_dir=jax_out, rule=jrule)
    jevs = jev.drain(jq)
    name = f"{w}x32x{turns}.pgm"
    with open(os.path.join(port_out, name), "rb") as f, \
            open(os.path.join(jax_out, name), "rb") as g:
        assert f.read() == g.read()
    final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    jfinal = [e for e in jevs if isinstance(e, jev.FinalTurnComplete)][0]
    assert final.completed_turns == jfinal.completed_turns == turns
    assert set(final.alive) == {tuple(c) for c in jfinal.alive}
    assert set(final.alive) == _firing(_replay(st, turns, rule))
    assert eng.alive_count() == (len(final.alive), turns)


def test_ticker_pause_snapshot(tmp_path, monkeypatch):
    """Every AliveCellsCount equals the firing count of its turn, 'p'
    parks the turn, 's' writes the gray board of its turn, 'q' ends."""
    monkeypatch.setenv("GOL_MAX_CHUNK", "8")
    rule = tg.BRIANS_BRAIN
    images, st = _seed_images(tmp_path, rule, 64, 64)
    out = str(tmp_path / "out")
    eng = Engine(device="cpu", rule=rule)
    keys, events_q = queue.Queue(), queue.Queue()
    t = gol_tpu_torch.run(Params(threads=1, image_width=64, image_height=64,
                                 turns=10**8), events_q, keys, engine=eng,
                          images_dir=images, out_dir=out, rule=rule)
    ticks = []
    while len(ticks) < 2:
        tick = _wait_for(events_q, ev.AliveCellsCount)
        if tick.completed_turns > 0:
            ticks.append(tick)
    for tick in ticks:
        want = _replay(st, tick.completed_turns, rule)
        assert tick.cells_count == int((want == 1).sum())

    keys.put("p")
    _wait_for(events_q, ev.StateChange)
    t1 = eng.ping()
    time.sleep(0.5)
    t2 = eng.ping()
    time.sleep(0.5)
    assert eng.ping() == t2 and t2 >= t1
    keys.put("s")
    snap = _wait_for(events_q, ev.ImageOutputComplete)
    board = read_pgm(os.path.join(out, snap.filename), levels=_levels(rule))
    np.testing.assert_array_equal(
        tg.from_pixels_gen(board, rule),
        _replay(st, snap.completed_turns, rule))
    keys.put("p")
    keys.put("q")
    evs = _drain_to_close(events_q)
    t.join(30)
    assert t.exception is None
    final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    assert set(final.alive) == _firing(
        _replay(st, final.completed_turns, rule))


def test_detach_resume(tmp_path, monkeypatch):
    """'q' detaches; CONT=yes reattaches to the same engine's board."""
    monkeypatch.setenv("GOL_MAX_CHUNK", "16")
    rule = tg.BRIANS_BRAIN
    images, st = _seed_images(tmp_path, rule, 64, 64)
    out = str(tmp_path / "out")
    eng = Engine(device="cpu", rule=rule)
    keys, q1 = queue.Queue(), queue.Queue()
    t1 = gol_tpu_torch.run(Params(threads=1, image_width=64,
                                  image_height=64, turns=10**8), q1, keys,
                           engine=eng, images_dir=images, out_dir=out,
                           rule=rule)
    time.sleep(1.0)
    keys.put("q")
    fin1 = [e for e in _drain_to_close(q1)
            if isinstance(e, ev.FinalTurnComplete)][0]
    t1.join(30)
    t_detach = fin1.completed_turns
    assert 0 < t_detach < 10**8
    total = t_detach + 20
    monkeypatch.setenv("CONT", "yes")
    q2 = queue.Queue()
    gol_tpu_torch.run(Params(threads=1, image_width=64, image_height=64,
                             turns=total), q2, engine=eng,
                      images_dir=images, out_dir=out, rule=rule)
    fin2 = [e for e in _drain_to_close(q2)
            if isinstance(e, ev.FinalTurnComplete)][0]
    assert fin2.completed_turns == total
    want = _replay(st, total, rule)
    assert set(fin2.alive) == _firing(want)
    board = read_pgm(os.path.join(out, f"64x64x{total}.pgm"),
                     levels=_levels(rule))
    np.testing.assert_array_equal(tg.from_pixels_gen(board, rule), want)


@pytest.mark.parametrize("s,h,w", [("/2/3", 64, 96), ("/2/3", 40, 20),
                                   ("345/2/4", 33, 64),
                                   ("23/36/8", 40, 64)])
def test_get_view_and_stats_match_jax(s, h, w):
    """get_view: the full gray board under the cap, the brightest state
    per block above it; stats' board is in cells for gen3 and gen8."""
    rule, jrule = tg.GenerationsRule(s), jg.GenerationsRule(s)
    world = tg.to_pixels_gen(_state(h, w, rule.states, h * w), rule)
    eng, jeng = Engine(device="cpu", rule=rule), JaxEngine(rule=jrule)
    eng.server_distributor(Params(threads=1, image_width=w, image_height=h,
                                  turns=3), world)
    jeng.server_distributor(gol_tpu.Params(threads=1, image_width=w,
                                           image_height=h, turns=3), world)
    for cap in (h * w, (h * w) // 16, 7, 0):
        got, turn, f = eng.get_view(cap)
        jgot, jturn, jf = jeng.get_view(cap)
        assert (turn, f) == (jturn, tuple(jf)) == (3, tuple(jf))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.asarray(jgot))
    assert eng.stats()["board"] == jeng.stats()["board"] == [h, w]
    assert eng.stats()["rule"] == s and eng.stats()["packed"] is False
    np.testing.assert_array_equal(eng.get_world()[0],
                                  np.asarray(jeng.get_world()[0]))


def test_state_carried_from_jax_engine():
    """A JAX Brian's Brain engine runs 64² for 13 turns; a port engine
    resumes from its gray get_world() for 17 more and lands on the JAX
    package's 30-turn board."""
    rule, jrule = tg.BRIANS_BRAIN, jg.BRIANS_BRAIN
    st = _state(64, 64, 3, seed=13)
    world = jg.to_pixels_gen(st, jrule)
    jeng = JaxEngine(rule=jrule)
    jeng.server_distributor(gol_tpu.Params(threads=1, image_width=64,
                                           image_height=64, turns=13),
                            world)
    mid, turn = jeng.get_world()
    assert turn == 13
    eng = Engine(device="cpu", rule=rule)
    final, final_turn = eng.server_distributor(
        Params(threads=1, image_width=64, image_height=64, turns=17),
        np.asarray(mid), start_turn=turn)
    assert final_turn == 30 and eng._repr == "gen3"
    jeng.server_distributor(gol_tpu.Params(threads=1, image_width=64,
                                           image_height=64, turns=17),
                            np.asarray(mid), start_turn=13)
    want, _ = jeng.get_world()
    np.testing.assert_array_equal(final, np.asarray(want))
    np.testing.assert_array_equal(tg.from_pixels_gen(final, rule),
                                  _replay(st, 30, rule))
    assert eng.alive_count() == (int((final == 255).sum()), 30)


def test_gol_rule_env_selects_the_family(tmp_path, monkeypatch):
    """GOL_RULE=345/2/4 on the default engine (CPU here) runs Star Wars
    through the uint8 path and writes Star Wars grays."""
    monkeypatch.setattr(distributor, "_default_engine", None)
    monkeypatch.setenv("GOL_RULE", "345/2/4")
    rule = tg.STAR_WARS
    images, st = _seed_images(tmp_path, rule, 32, 32, seed=2)
    out = str(tmp_path / "out")
    events_q = queue.Queue()
    t = gol_tpu_torch.run(Params(threads=1, image_width=32, image_height=32,
                                 turns=9), events_q, images_dir=images,
                          out_dir=out, device="cpu")
    evs = _drain_to_close(events_q)
    t.join(30)
    assert t.exception is None
    assert distributor._default_engine._rule == rule
    board = read_pgm(os.path.join(out, "32x32x9.pgm"), levels=_levels(rule))
    np.testing.assert_array_equal(tg.from_pixels_gen(board, rule),
                                  _replay(st, 9, rule))
    final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    assert final.count() == int((_replay(st, 9, rule) == 1).sum())


def test_cli_generations_rule(images_dir, tmp_path):
    """`python -m gol_tpu_torch ... --rule /2/3 --device cpu` writes the
    JAX package's Brian's Brain board for the same {0,255} seed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["GOL_IMAGES"] = images_dir
    env["GOL_OUT"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", "-w", "64", "-h", "64",
         "--turns", "50", "--headless", "--rule", "/2/3", "--device",
         "cpu"], capture_output=True, text=True, timeout=120, env=env,
        cwd=str(tmp_path), stdin=subprocess.DEVNULL)
    assert proc.returncode == 0, proc.stderr
    assert "File 64x64x50.pgm output complete" in proc.stdout
    jq = queue.Queue()
    gol_tpu.run(gol_tpu.Params(threads=1, image_width=64, image_height=64,
                               turns=50), jq, None,
                engine=JaxEngine(rule=jg.BRIANS_BRAIN),
                images_dir=images_dir, out_dir=str(tmp_path / "jax"),
                rule=jg.BRIANS_BRAIN)
    jev.drain(jq)
    assert (tmp_path / "64x64x50.pgm").read_bytes() == \
        (tmp_path / "jax" / "64x64x50.pgm").read_bytes()
