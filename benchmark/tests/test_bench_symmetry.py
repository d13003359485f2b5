"""The torus's symmetries and the tiling commute with a step, so the
cells' inputs keep the committed board's history."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from yardstick import board as bd
from yardstick import registry

ref = registry.reference("life")
CONWAY = ref.parse_rule("B3/S23")


def _step(b: np.ndarray, turns: int = 1) -> np.ndarray:
    t = torch.from_numpy(b)
    for _ in range(turns):
        t = ref.step(t, CONWAY)
    return t.numpy()


def _soup(seed: int, h: int, w: int) -> np.ndarray:
    return (np.random.default_rng(seed).random((h, w)) < 0.3).astype(
        np.uint8)


@pytest.mark.parametrize("k,flip", list(itertools.product(range(4),
                                                          (False, True))))
def test_symmetry_commutes_with_a_step(k, flip):
    b = _soup(k * 2 + flip, 24, 24)
    sym = (k, flip, 5, 17)
    np.testing.assert_array_equal(_step(bd.apply_symmetry(b, sym), 3),
                                  bd.apply_symmetry(_step(b, 3), sym))


def test_tiling_commutes_with_a_step():
    b = _soup(1, 16, 24)
    np.testing.assert_array_equal(_step(bd.tile(b, (3, 2)), 5),
                                  bd.tile(_step(b, 5), (3, 2)))


def test_drawn_symmetries_cover_the_group():
    rng = np.random.default_rng(2**33 + 7)
    seen = {bd.draw_symmetry(rng, 8, 8)[:2] for _ in range(400)}
    assert seen == set(itertools.product(range(4), (False, True)))


def test_non_square_boards_draw_only_half_turns():
    rng = np.random.default_rng(3)
    assert {bd.draw_symmetry(rng, 8, 16)[0] for _ in range(100)} == {0, 2}


def test_seed_fixes_the_symmetry():
    a = [bd.draw_symmetry(np.random.default_rng(2**32 + 9), 512, 512)
         for _ in range(3)]
    assert a[0] == a[1] == a[2]


def test_pgm_round_trip(tmp_path):
    b = (_soup(4, 7, 9) * 255).astype(np.uint8)
    p = str(tmp_path / "x" / "9x7.pgm")
    bd.write_pgm(p, b)
    np.testing.assert_array_equal(bd.read_pgm(p), b)


def test_cells_from_alive_counts_bad_entries():
    board, bad = bd.cells_from_alive([(1, 2), (1, 2), (9, 0), (0, 0)], 4, 4)
    assert bad == 2 and int(board.sum()) == 2 and board[2, 1] == 1
