"""The plain reference against the coursework's fixtures, and its
cycle arithmetic."""

from __future__ import annotations

import csv
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from yardstick import board as bd
from yardstick import registry

ref = registry.reference("life")
CONWAY = ref.parse_rule("B3/S23")


def _cells(path: str) -> np.ndarray:
    return (bd.read_pgm(path) != 0).astype(np.uint8)


@pytest.fixture(scope="module")
def history_512():
    return ref.History(_cells(os.path.join(ROOT, "images", "512x512.pgm")),
                       "B3/S23")


@pytest.mark.parametrize("size", [16, 64, 512])
@pytest.mark.parametrize("turns", [0, 1, 100])
def test_reference_matches_check_images(size, turns):
    start = _cells(os.path.join(ROOT, "images", f"{size}x{size}.pgm"))
    want = _cells(os.path.join(ROOT, "check", "images",
                               f"{size}x{size}x{turns}.pgm"))
    b = torch.from_numpy(start)
    for _ in range(turns):
        b = ref.step(b, CONWAY)
    np.testing.assert_array_equal(b.numpy(), want)


def test_history_matches_alive_csv(history_512):
    with open(os.path.join(ROOT, "check", "alive", "512x512.csv")) as f:
        rows = [(int(t), int(a)) for t, a in list(csv.reader(f))[1:]]
    assert len(rows) == 10001
    assert [history_512.count_at(t) for t, _ in rows] == [a for _, a in rows]


def test_history_cycle_of_the_contract_board(history_512):
    # The coursework board settles into ash of period 2 at turn 4207.
    assert (history_512.t0, history_512.period) == (4207, 2)
    big = 10**8 + 1  # 4207 + an even number of turns
    a = history_512.state_at(big)
    np.testing.assert_array_equal(a, history_512.state_at(4207))
    assert not np.array_equal(a, history_512.state_at(4208))
    assert history_512.count_at(big) == int(a.sum())


def test_the_committed_board_is_the_contract_board_settled(history_512):
    cfg = registry.config(registry.load_benchmark(), "life-512")
    settled = _cells(os.path.join(ROOT, cfg["image"]))
    np.testing.assert_array_equal(settled, history_512.state_at(4208))


def _cfg(name: str, **kw) -> dict:
    cfg = dict(registry.config(registry.load_benchmark(), name))
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 2**33 + 5, 7, 8, 9])
def test_planted_board_has_period_six_from_turn_0(seed):
    cfg = _cfg("life-512")
    board = ref.make_board(cfg, np.random.default_rng(seed), ROOT)
    hist = ref.oracle(board, cfg)
    assert (hist.t0, hist.period) == (0, 6)
    # A step that stopped while the turn advanced by a power of two
    # (the engine's chunks) would publish a wrong count: the pulsar's
    # three phases differ and 2**k is never a multiple of 3.
    for t in range(6):
        for k in range(1, 24):
            assert hist.count_at(t) != hist.count_at(t + 2**k)
    assert hist.count_at(0) == 7527 + 48


def test_a_tiled_board_holds_one_plant_and_keeps_period_six():
    cfg = _cfg("life-5120", tile=[2, 3], height=1024, width=1536)
    board = ref.make_board(cfg, np.random.default_rng(2**32 + 1), ROOT)
    tiles = [np.roll(board, (-512 * i, -512 * j), (0, 1))[:512, :512]
             for i in range(2) for j in range(3)]
    assert sum(not np.array_equal(t, tiles[0]) for t in tiles) in (1, 5)
    hist = ref.oracle(board, cfg)
    assert (hist.t0, hist.period) == (0, 6)
    assert hist.count_at(1) == 6 * 7525 + 56


def test_state_before_the_cycle_replays(history_512):
    want = _cells(os.path.join(ROOT, "check", "images", "512x512x100.pgm"))
    np.testing.assert_array_equal(history_512.state_at(100), want)


def test_torus_and_plane_differ_on_a_glider_at_the_edge():
    b = np.zeros((16, 16), np.uint8)
    b[14, 15] = b[15, 13] = b[15, 14] = b[15, 15] = b[13, 14] = 1
    t = torch.from_numpy(b)
    torus, plane = t, t
    for _ in range(8):
        torus = ref.step(torus, CONWAY)
        plane = ref.step(plane, CONWAY, wrap=False)
    assert int(torus.sum()) == 5
    assert not torch.equal(torus, plane)


def test_history_refuses_a_board_that_does_not_repeat():
    b = np.zeros((64, 64), np.uint8)
    b[1, 2] = b[2, 3] = b[3, 1] = b[3, 2] = b[3, 3] = 1  # a glider
    with pytest.raises(RuntimeError):
        ref.History(b, "B3/S23", limit=100)


@pytest.mark.parametrize("rule,born,survive", [
    ("B3/S23", {3}, {2, 3}), ("b36/s23", {3, 6}, {2, 3}),
    ("B/S", set(), set())])
def test_parse_rule(rule, born, survive):
    assert ref.parse_rule(rule) == (born, survive)
