"""The torch port's main path end to end (`gol_tpu_torch.run` on a CPU
engine) against the goldens and the JAX package: final boards, PGM bytes,
alive-count telemetry, event order, and state carried from a JAX engine
into a port engine."""

import csv
import queue
import time

import numpy as np
import pytest
import torch

import gol_tpu
from gol_tpu import events as jev
from gol_tpu.engine import Engine as JaxEngine

import gol_tpu_torch
from gol_tpu_torch import Params, events as ev
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.fixtures import ash_512_alive
from gol_tpu_torch.io.pgm import read_pgm
from gol_tpu_torch.ops import bitpack
from gol_tpu_torch.ops.reference import run_turns_np
from gol_tpu_torch.utils.cell import read_alive_cells
from gol_tpu_torch.utils.visualise import board_diff

torch.set_num_threads(2)

SIZES_TURNS = [
    (16, 0), (16, 1), (16, 100),
    (64, 0), (64, 1), (64, 100),
    (512, 0), (512, 1), (512, 100),
]


def run_port(p, images_dir, out_dir, keys=None, engine=None):
    events_q = queue.Queue()
    t = gol_tpu_torch.run(p, events_q, keys,
                          engine=engine or Engine(device="cpu"),
                          images_dir=images_dir, out_dir=out_dir)
    return t, events_q


@pytest.mark.parametrize("size,turns", SIZES_TURNS)
def test_gol_matches_golden_and_jax_pgm(size, turns, images_dir, check_dir,
                                        tmp_path):
    p = Params(threads=1, image_width=size, image_height=size, turns=turns)
    _, events_q = run_port(p, images_dir, str(tmp_path / "port"))
    evs = ev.drain(events_q)
    finals = [e for e in evs if isinstance(e, ev.FinalTurnComplete)]
    assert len(finals) == 1 and finals[0].completed_turns == turns
    want = {(c.x, c.y) for c in read_alive_cells(
        str(check_dir / "images" / f"{size}x{size}x{turns}.pgm"),
        size, size)}
    got = set(finals[0].alive)
    if got != want and size == 16:
        print(board_diff(sorted(got), sorted(want), size, size))
    assert got == want
    assert finals[0].count() == len(want)

    jq = queue.Queue()
    gol_tpu.run(gol_tpu.Params(threads=1, image_width=size,
                               image_height=size, turns=turns),
                jq, None, engine=JaxEngine(), images_dir=images_dir,
                out_dir=str(tmp_path / "jax"))
    jev.drain(jq)
    name = f"{size}x{size}x{turns}.pgm"
    assert (tmp_path / "port" / name).read_bytes() == \
        (tmp_path / "jax" / name).read_bytes()


def test_event_ordering(images_dir, out_dir):
    """StateChange Executing first; FinalTurnComplete, then
    ImageOutputComplete, then StateChange Quitting last."""
    p = Params(threads=1, image_width=16, image_height=16, turns=3)
    _, events_q = run_port(p, images_dir, out_dir)
    evs = ev.drain(events_q)
    filtered = [e for e in evs if not isinstance(e, ev.AliveCellsCount)]
    kinds = [type(e).__name__ for e in filtered]
    assert kinds[0] == "StateChange"
    assert filtered[0].new_state == ev.State.EXECUTING
    order = [k for k in kinds if k in
             ("FinalTurnComplete", "ImageOutputComplete", "StateChange")]
    assert order[-3:] == [
        "FinalTurnComplete", "ImageOutputComplete", "StateChange"]
    last_sc = [e for e in evs if isinstance(e, ev.StateChange)][-1]
    assert last_sc.new_state == ev.State.QUITTING


def test_alive_telemetry(images_dir, check_dir, out_dir):
    """The 2 s ticker: first count within 5 s, every (turn, count) exact
    — against the CSV up to turn 10000, the settled ash beyond it."""
    with open(check_dir / "alive" / "512x512.csv") as f:
        golden = {int(r["completed_turns"]): int(r["alive_cells"])
                  for r in csv.DictReader(f)}
    p = Params(threads=1, image_width=512, image_height=512, turns=10**8)
    keys = queue.Queue()
    start = time.monotonic()
    _, events_q = run_port(p, images_dir, out_dir, keys)
    counts, first_at = [], None
    deadline = start + 60
    while len(counts) < 5 and time.monotonic() < deadline:
        try:
            e = events_q.get(timeout=1.0)
        except queue.Empty:
            continue
        if e is ev.CLOSE:
            break
        if isinstance(e, ev.AliveCellsCount):
            if first_at is None:
                first_at = time.monotonic() - start
            if e.completed_turns == 0 and e.cells_count == 0:
                continue  # a tick before the board loaded
            counts.append(e)
    assert first_at is not None and first_at <= 5.0, first_at
    assert len(counts) >= 5
    for e in counts:
        want = (golden[e.completed_turns] if e.completed_turns <= 10_000
                else ash_512_alive(e.completed_turns))
        assert e.cells_count == want, (e.completed_turns, e.cells_count)
    keys.put("q")
    while events_q.get(timeout=30) is not ev.CLOSE:
        pass


@pytest.mark.parametrize("size", [16, 64])
def test_live_view_events(size, images_dir, out_dir):
    """The live feed (u8 at 16², packed at 64²): replaying every
    CellsFlipped onto an empty board gives the board of the last
    TurnComplete, and the final board when that was the final turn."""
    p = Params(threads=1, image_width=size, image_height=size, turns=10**8)
    events_q, keys = queue.Queue(), queue.Queue()
    gol_tpu_torch.run(p, events_q, keys, engine=Engine(device="cpu"),
                      images_dir=images_dir, out_dir=out_dir,
                      live_view=True)
    time.sleep(1.5)
    keys.put("q")
    evs = ev.drain(events_q)
    flips = [e for e in evs if isinstance(e, ev.CellsFlipped)]
    turns = [e.completed_turns for e in evs if isinstance(e, ev.TurnComplete)]
    assert flips and turns and turns == sorted(set(turns))
    shown = np.zeros((size, size), dtype=bool)
    for e in flips:
        for x, y in e.cells:
            shown[y, x] = not shown[y, x]
    final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    assert turns[-1] <= final.completed_turns
    start = read_pgm(f"{images_dir}/{size}x{size}.pgm") != 0
    want = run_turns_np(start.astype(np.uint8), turns[-1]) != 0
    assert np.array_equal(shown, want)


@pytest.mark.parametrize("h,w", [(64, 96), (40, 20), (33, 64)])
def test_get_view_matches_jax(h, w):
    """Engine.get_view against the JAX engine's: the full board under the
    cap, the same downsampled frame and factors above it."""
    rng = np.random.default_rng(h * w)
    world = np.where(rng.random((h, w)) < 0.1, 255, 0).astype(np.uint8)
    eng, jeng = Engine(device="cpu"), JaxEngine()
    eng.server_distributor(Params(threads=1, image_width=w,
                                  image_height=h, turns=3), world)
    jeng.server_distributor(gol_tpu.Params(threads=1, image_width=w,
                                           image_height=h, turns=3), world)
    for cap in (h * w, (h * w) // 16, 7, 0):
        got, turn, f = eng.get_view(cap)
        jgot, jturn, jf = jeng.get_view(cap)
        assert (turn, f) == (jturn, tuple(jf)) == (3, tuple(jf))
        assert got.dtype == np.uint8
        assert np.array_equal(got, np.asarray(jgot))


def test_state_carried_from_jax_engine(images_dir, check_dir):
    """A JAX engine runs 512² for 37 turns; a port engine resumes from its
    get_world() for 63 more and lands on the 100-turn golden."""
    world = read_pgm(f"{images_dir}/512x512.pgm")
    jeng = JaxEngine()
    jeng.server_distributor(
        gol_tpu.Params(threads=1, image_width=512, image_height=512,
                       turns=37), world)
    mid, turn = jeng.get_world()
    assert turn == 37
    from gol_tpu.ops.bitpack import pack

    jwords = np.asarray(pack((mid != 0).astype(np.uint8)))
    assert np.array_equal(bitpack.pack_np(mid), jwords)
    assert torch.equal(bitpack.words_from_numpy(jwords),
                       bitpack.pack(torch.from_numpy(mid != 0).to(
                           torch.uint8)))

    eng = Engine(device="cpu")
    final, final_turn = eng.server_distributor(
        Params(threads=1, image_width=512, image_height=512, turns=63),
        mid, start_turn=turn)
    assert final_turn == 100
    want = read_pgm(str(check_dir / "images" / "512x512x100.pgm"))
    assert np.array_equal(final, want)
    assert eng.alive_count() == (int((want != 0).sum()), 100)
