"""The port's sparse path (`run(..., sparse=True)` on
`SparseEngine(device="cpu")`) against the plain coordinate-list
reference (`tools/sparse_reference.py`), which imports neither JAX nor
either package: the R-pentomino under each of its 8 rotations and
reflections for 1,536 turns and two seeded 16 x 16 soups on a 4,096
torus, every published (alive, turn) pair, FinalTurnComplete's torus
cells and the window PGM's live pixels at the window's origin. The
reference alone: the R-pentomino's 116 cells from turn 1,103 on and its
six gliders, and its history of a seed board under each of the 8
rotations and reflections, at an offset, is the image of the unturned
board's. The benchmark's reference (`benchmark/reference/sparse.py`)
steps with this file and agrees with it. Tolerance: none."""

from __future__ import annotations

import importlib.util
import inspect
import os
import queue
import subprocess
import sys

import numpy as np
import pytest
import torch

import gol_tpu_torch
from gol_tpu_torch import Params, events as ev
from gol_tpu_torch.io.pgm import read_pgm, write_pgm
from gol_tpu_torch.sparse_engine import SparseEngine

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 4096


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # where `inspect` finds a class's source
    spec.loader.exec_module(mod)
    return mod


ref = _load(os.path.join(REPO, "tools", "sparse_reference.py"),
            "sparse_reference_tools")
bench_ref = _load(os.path.join(REPO, "benchmark", "reference", "sparse.py"),
                  "sparse_reference_bench")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("SER", "CONT", "SUB", "GOL_RULE", "GOL_SPARSE_SHARDS",
              "GOL_TRACE_SPANS", "GOL_FLIGHT", "GOL_CKPT"):
        monkeypatch.delenv(k, raising=False)


class _Recording(SparseEngine):
    """A sparse engine that notes every (turn, alive) pair it publishes."""

    def __init__(self, *a, **kw) -> None:
        super().__init__(*a, **kw)
        self.published: list = []

    def _publish_locked(self, alive=None) -> None:
        super()._publish_locked(alive)
        if self._pub is not None:
            self.published.append((self._pub[3], self._pub[4]))


def _symmetric(k: int) -> np.ndarray:
    """The R-pentomino under rotation k % 4, reflected when k >= 4."""
    pat = np.rot90(ref.rows_board(ref.R_PENTOMINO_ROWS), k % 4)
    return pat[:, ::-1] if k >= 4 else pat


def _seed(pattern: np.ndarray, at=(5, 7)) -> np.ndarray:
    board = np.zeros((16, 16), np.uint8)
    ph, pw = pattern.shape
    board[at[0]:at[0] + ph, at[1]:at[1] + pw] = pattern
    return board


def _soup(seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).random((16, 16)) < 0.4).astype(
        np.uint8)


def _run_port(board: np.ndarray, turns: int, tmp_path) -> tuple:
    """(engine, events, PGM path) of one `run(sparse=True)` job."""
    images = tmp_path / "images"
    write_pgm(str(images / "seed.pgm"), board * np.uint8(255))
    eng = _Recording(SIZE, device="cpu")
    q = queue.Queue()
    th = gol_tpu_torch.run(Params(image_width=SIZE, image_height=SIZE,
                                  turns=turns), q, None, engine=eng,
                           images_dir=str(images),
                           out_dir=str(tmp_path / "out"), sparse=True)
    th.join(170)
    assert not th.is_alive() and th.exception is None
    events = ev.drain(q)
    (img,) = [e for e in events if isinstance(e, ev.ImageOutputComplete)]
    return eng, events, str(tmp_path / "out" / img.filename)


def _check_against_reference(board: np.ndarray, turns: int, tmp_path):
    hist = ref.History(board, SIZE, turns)
    eng, events, pgm = _run_port(board, turns, tmp_path)
    assert eng.published and eng.published[-1][0] == turns
    assert [a for _, a in eng.published] == \
        [hist.count_at(t) for t, _ in eng.published]
    for e in events:
        if isinstance(e, ev.AliveCellsCount) and e.completed_turns:
            assert e.cells_count == hist.count_at(e.completed_turns)
    (final,) = [e for e in events if isinstance(e, ev.FinalTurnComplete)]
    want = hist.cells()
    assert final.completed_turns == turns
    assert final.count() == len(want) == len(final.alive)
    assert set(final.alive) == want
    pix, (ox, oy), turn = eng.get_window()
    assert turn == turns
    on_disk = read_pgm(pgm)
    np.testing.assert_array_equal(on_disk, pix)
    assert os.path.basename(pgm) == \
        f"{on_disk.shape[1]}x{on_disk.shape[0]}x{turns}.pgm"
    ys, xs = np.nonzero(on_disk)
    assert {((int(x) + ox) % SIZE, (int(y) + oy) % SIZE)
            for x, y in zip(xs, ys)} == want
    return eng


@pytest.mark.parametrize("k", range(8))
def test_r_pentomino_symmetries_match_the_reference(k, tmp_path):
    eng = _check_against_reference(_seed(_symmetric(k)), 1536, tmp_path)
    st = eng.stats()
    assert st["grows"] >= 1 and st["margin_fetches"] >= st["grows"]


@pytest.mark.parametrize("seed", [11, 2**33 + 7])
def test_seeded_soups_match_the_reference(seed, tmp_path):
    _check_against_reference(_soup(seed), 1024, tmp_path)


def _components(cells: set) -> list:
    """Groups of cells within a king's move of another of the group."""
    left, out = set(cells), []
    while left:
        todo = [left.pop()]
        group = set(todo)
        while todo:
            x, y = todo.pop()
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    c = (x + dx, y + dy)
                    if c in left:
                        left.remove(c)
                        group.add(c)
                        todo.append(c)
        out.append(group)
    return out


def test_r_pentomino_settles_at_116_cells_with_six_gliders():
    board = ref.rows_board(ref.R_PENTOMINO_ROWS)
    size = 1 << 20
    hist = ref.History(board, size, 2000)
    assert hist.count_at(0) == 5
    assert hist.count_at(1102) != 116
    assert all(hist.count_at(t) == 116 for t in range(1103, 2001))
    later = ref.History(board, size, 2004).cells()
    gliders = 0
    for group in _components(hist.cells()):
        if len(group) != 5:
            continue
        moved = [{(x + dx, y + dy) for x, y in group}
                 for dx in (-1, 1) for dy in (-1, 1)]
        gliders += any(m <= later for m in moved)
    assert gliders == 6


def test_the_benchmark_copy_agrees():
    """The benchmark's reference steps with this file's coordinate list
    and draws R-pentomino seed boards the tools' History agrees on."""
    assert os.path.samefile(bench_ref.coords.__file__, ref.__file__)
    cfg = {"pattern": {"rows": list(ref.R_PENTOMINO_ROWS)},
           "seed_board": [64, 64], "width": SIZE, "turns": 700,
           "rule": "B3/S23"}
    rng = np.random.default_rng(2**31 + 3)
    for _ in range(4):
        board = bench_ref.make_board(cfg, rng, REPO)
        assert board.shape == (64, 64) and board.sum() == 5
        a, b = bench_ref.oracle(board, cfg), ref.History(board, SIZE, 700)
        assert a.counts == b.counts and a.cells() == b.cells()
    soup = _soup(5)
    cfg.update(turns=300, rule="B36/S23")
    a = bench_ref.oracle(soup, cfg)
    b = ref.History(soup, SIZE, 300, "B36/S23")
    assert a.counts == b.counts and a.cells() == b.cells()


def _place(rows, sym: int, oy: int, ox: int) -> np.ndarray:
    """A 64 x 64 seed board holding `rows` under `sym` at (oy, ox)."""
    pat = bench_ref.oriented(rows, sym)
    board = np.zeros((64, 64), np.uint8)
    board[oy:oy + pat.shape[0], ox:ox + pat.shape[1]] = pat
    return board


def _image(rows, sym: int, oy: int, ox: int, cells) -> set:
    """The torus cells that `cells`, cells of `rows` placed unturned at
    (0, 0) of a 64 x 64 seed board, become under `sym` at (oy, ox)."""
    off = (SIZE - 64) // 2
    h, w = ref.rows_board(rows).shape
    out = set()
    for x, y in cells:
        r = (y - off + SIZE // 2) % SIZE - SIZE // 2
        c = (x - off + SIZE // 2) % SIZE - SIZE // 2
        hh, ww = h, w
        for _ in range(sym % 4):
            r, c = ww - 1 - c, r  # np.rot90 once
            hh, ww = ww, hh
        if sym >= 4:
            c = ww - 1 - c
        out.add(((off + ox + c) % SIZE, (off + oy + r) % SIZE))
    return out


@pytest.mark.parametrize("sym", range(8))
def test_a_placement_s_history_is_the_image_of_the_pattern_s(sym):
    """The reference commutes with the seed board's rotations,
    reflections and translations, as Life does far from the seam."""
    rng = np.random.default_rng(2**32 + sym)
    for rows in (ref.R_PENTOMINO_ROWS, ("OOO.", "O...", ".O..")):
        base = ref.History(_place(rows, 0, 0, 0), SIZE, 500)
        oy, ox = (int(v) for v in rng.integers(0, 60, 2))
        placed = ref.History(_place(rows, sym, oy, ox), SIZE, 500)
        assert placed.counts == base.counts
        assert placed.cells() == _image(rows, sym, oy, ox, base.cells())
        if (sym, oy, ox) != (0, 0, 0):
            assert placed.cells() != base.cells()


def test_make_board_draws_every_symmetry():
    cfg = {"pattern": {"rows": list(ref.R_PENTOMINO_ROWS)},
           "seed_board": [64, 64]}
    rng = np.random.default_rng(9)
    shapes = set()
    for _ in range(200):
        ys, xs = np.nonzero(bench_ref.make_board(cfg, rng, REPO))
        shapes.add(frozenset(zip(ys - ys.min(), xs - xs.min())))
    assert len(shapes) == 8


def test_the_reference_wraps_the_torus():
    """A glider that crosses the seam comes back where it started."""
    glider = ref.rows_board((".O.", "..O", "OOO"))
    hist = ref.History(glider, 32, 4 * 32)
    assert set(hist.counts) == {5}
    assert hist.cells() == ref.History(glider, 32, 0).cells()


def test_the_references_import_neither_jax_nor_the_packages(tmp_path):
    code = (
        "import sys, importlib.util\n"
        "for p in %r:\n"
        "    s = importlib.util.spec_from_file_location('m', p)\n"
        "    m = importlib.util.module_from_spec(s)\n"
        "    s.loader.exec_module(m)\n"
        "bad = sorted({n.split('.')[0] for n in sys.modules}\n"
        "             & {'jax', 'jaxlib', 'gol_tpu', 'gol_tpu_torch'})\n"
        "print(bad)\n" % ([os.path.join(REPO, "tools", "sparse_reference.py"),
                           os.path.join(REPO, "benchmark", "reference",
                                        "sparse.py")],))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"
