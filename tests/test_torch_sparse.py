"""The port's sparse torus (`gol_tpu_torch.models.sparse`) against the JAX
package's (`gol_tpu.models.sparse`, its CPU jnp path): the same seeds give
the same cells, turn, window shape, torus origin and margins after every
`run(k)`, and K8's plain version (`window_occupancy_plain`) equals JAX
`_occupancy` on random words with the sign bit set. The cases of
`tests/test_sparse.py` against the dense numpy oracle. Tolerance: none."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gol_tpu.models import sparse as jsp
from gol_tpu.models.lifelike import LifeLikeRule as JRule
from gol_tpu.ops.reference import run_turns_np

from gol_tpu_torch.models import sparse as tsp
from gol_tpu_torch.models.lifelike import LifeLikeRule as TRule
from gol_tpu_torch.ops import cuda_stencil as cs
from gol_tpu_torch.ops.bitpack import packed_alive_count, words_from_numpy

torch.set_num_threads(2)

BIG = 2**20
GLIDER = ((1, 0), (2, 1), (0, 2), (1, 2), (2, 2))
R_PENTOMINO = tsp.R_PENTOMINO


def pair(size, cells, rule="B3/S23"):
    return (jsp.SparseTorus(size, cells, JRule(rule)),
            tsp.SparseTorus(size, cells, TRule(rule), device="cpu"))


def agree(j, t):
    """Every observable of the two tori is equal; returns the cell set."""
    assert t.turn == j.turn
    assert t.window_shape() == j.window_shape()
    assert (t._ox, t._oy) == (j._ox, j._oy)
    assert t._margins() == j._margins()
    cells = set(t.alive_cells())
    assert cells == set(j.alive_cells())
    assert t.alive_count() == j.alive_count() == len(cells)
    return cells


def run_both(j, t, turns, macro=None):
    j.run(turns, macro=macro)
    t.run(turns, macro=macro)
    return agree(j, t)


def dense_cells(size, cells, turns):
    board = np.zeros((size, size), dtype=np.uint8)
    for x, y in cells:
        board[y % size, x % size] = 1
    ys, xs = np.nonzero(run_turns_np(board, turns))
    return {(int(x), int(y)) for x, y in zip(xs, ys)}


def test_r_pentomino_matches_dense_oracle():
    start = [(x + 120, y + 120) for x, y in R_PENTOMINO]
    j, t = pair(BIG, start)
    agree(j, t)
    for k in (16, 34):
        run_both(j, t, k, macro=16)
    assert run_both(j, t, 0) == dense_cells(256, start, 50)
    assert t.turn == 50


def test_glider_travels_across_window_growth():
    start = [(x + 500, y + 500) for x, y in GLIDER]
    j, t = pair(BIG, start)
    shapes = set()
    for k in (100, 100, 200):
        run_both(j, t, k, macro=128)
        shapes.add(t.window_shape())
    assert set(t.alive_cells()) == {(x + 100, y + 100) for x, y in start}
    assert len(shapes) > 1, "the glider must cross a window growth"


def test_blinker_window_stays_bounded():
    j, t = pair(BIG, [(100, 100), (101, 100), (102, 100)])
    cells = run_both(j, t, 301, macro=64)
    h, w = t.window_shape()
    assert h <= 2048 and w <= 8192
    assert cells == {(101, 99), (101, 100), (101, 101)}


def test_pattern_near_torus_origin_wraps_coordinates():
    j, t = pair(BIG, [(0, 0), (1, 0), (2, 0)])
    assert (t._ox, t._oy) == (j._ox, j._oy)
    assert t._ox > BIG // 2 and t._oy > BIG // 2  # the origin wrapped
    assert run_both(j, t, 2, macro=2) == {(0, 0), (1, 0), (2, 0)}


def test_adaptive_macro_matches_dense_oracle():
    # The adaptive ladder: the first pick exceeds the initial margin,
    # forcing a grow and a quantized deep macro, then an exact tail.
    start = [(x + 512, y + 512) for x, y in R_PENTOMINO]
    j, t = pair(BIG, start)
    cells = run_both(j, t, 300)
    assert cells == dense_cells(1024, start, 300)
    assert t.grows >= 1 and t.margin_fetches >= 1


def test_cached_alive_count_matches_recount():
    j, t = pair(BIG, [(x + 100, y + 100) for x, y in R_PENTOMINO])
    run_both(j, t, 120)
    assert t._occ is not None
    assert t.alive_count() == packed_alive_count(t._packed)


def test_pattern_straddling_torus_seam():
    j, t = pair(BIG, [(BIG - 1, 10), (0, 10), (1, 10)])
    assert run_both(j, t, 1) == {(0, 9), (0, 10), (0, 11)}
    assert run_both(j, t, 1) == {(BIG - 1, 10), (0, 10), (1, 10)}


@pytest.mark.parametrize("coords,size", [
    ([5], 100), ([3, 4, 5], 100), ([99, 0, 1], 100), ([0, 99], 100),
    ([0, 50], 100), ([7, 7, 7], 64), ([1, 30, 60, 90], 96),
    (list(range(0, 1000, 3)), 1024)])
def test_cyclic_extent(coords, size):
    assert tsp._cyclic_extent(coords, size) == jsp._cyclic_extent(
        coords, size)
    origin, extent = tsp._cyclic_extent(coords, size)
    assert all((c - origin) % size < extent for c in coords)


def test_cyclic_extent_cases():
    assert tsp._cyclic_extent([5], 100) == (5, 1)
    assert tsp._cyclic_extent([3, 4, 5], 100) == (3, 3)
    assert tsp._cyclic_extent([99, 0, 1], 100) == (99, 3)
    assert tsp._cyclic_extent([0, 99], 100) == (99, 2)
    assert tsp._cyclic_extent([0, 50], 100) in {(0, 51), (50, 51)}


@pytest.mark.parametrize("size,cells,rule", [
    (1000, [(0, 0)], "B3/S23"),                    # not a multiple of 32
    (BIG, [], "B3/S23"),                            # no live cell
    (64, [(0, 0), (40, 0), (20, 0)], "B3/S23"),     # spans most of it
    (BIG, [(0, 0)], "B0/S23"),                      # births on 0
])
def test_rejects_bad_input(size, cells, rule):
    with pytest.raises(ValueError):
        jsp.SparseTorus(size, cells, JRule(rule))
    with pytest.raises(ValueError):
        tsp.SparseTorus(size, cells, TRule(rule), device="cpu")


def test_died_out_pattern_is_stable():
    j, t = pair(BIG, [(100, 100)])
    run_both(j, t, 1)
    shape = t.window_shape()
    assert run_both(j, t, 600, macro=256) == set()
    assert t.turn == 601 and t.window_shape() == shape
    assert t._margins() is None


def test_window_saturates_torus_degenerates_to_dense():
    size = 64
    start = [(x + 30, y + 30) for x, y in R_PENTOMINO]
    j, t = pair(size, start)
    assert t.window_shape() == (size, size)
    assert t._safe_budget(12345) == 12345  # no margins fetch
    assert t.margin_fetches == 0
    cells = run_both(j, t, 300)
    assert cells == dense_cells(size, start, 300)


@pytest.mark.parametrize("budget,raises", [(1 << 16, True), (0, False),
                                           (-5, False), ("junk", False)])
def test_window_budget_ceiling_is_a_clear_error(budget, raises,
                                                monkeypatch):
    """A window the device cannot hold raises before allocating, in both
    packages; GOL_SPARSE_MAX_BYTES=0 disables the guard, and garbage or a
    negative value keeps the default (8 GiB on the CPU)."""
    monkeypatch.setenv("GOL_SPARSE_MAX_BYTES", str(budget))
    cells = [(500, 500), (501, 500), (502, 500)]
    for make in (lambda: jsp.SparseTorus(BIG, cells),
                 lambda: tsp.SparseTorus(BIG, cells, device="cpu")):
        if raises:
            with pytest.raises(RuntimeError, match="outgrown this sparse"):
                make()
        else:
            make()


def test_budget_refuses_a_grow(monkeypatch):
    """The guard also stops a grow past the budget (as in the JAX
    package), before the new window is made."""
    j, t = pair(BIG, [(x + 500, y + 500) for x, y in R_PENTOMINO])
    monkeypatch.setenv("GOL_SPARSE_MAX_BYTES", str(1 << 18))
    for torus in (j, t):
        with pytest.raises(RuntimeError, match="outgrown"):
            torus.run(2000)


def test_shard_count_validation_matches_jax():
    for n, size in ((3, BIG), (2, BIG), (4, 96), (1, 100)):
        outcomes = []
        for check in (jsp.check_sparse_mesh, tsp.check_sparse_mesh):
            try:
                check(n, size)
                outcomes.append(None)
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1]


def test_constants_match_jax():
    for name in ("R_PENTOMINO", "_ROW_ALIGN", "_COL_ALIGN",
                 "_WIDE_COL_ALIGN", "_GROW_NUM", "_GROW_DEN", "_MACRO_CAP",
                 "_MACRO_MIN", "_MAX_BYTES_ENV", "_DEFAULT_BUDGET",
                 "_WINDOW_COST_FACTOR"):
        assert getattr(tsp, name) == getattr(jsp, name), name
    for v in (0, 1, 255, 256, 257, 511, 512, 1000, 2048, 5000):
        assert tsp._ladder_floor(v) == jsp._ladder_floor(v)
        assert tsp._round_up(v, 256) == jsp._round_up(v, 256)


@pytest.mark.parametrize("rule", ["B36/S23", "B3/S012345678"])
def test_other_rules_agree(rule):
    """HighLife and Life without Death (a pattern that only grows)."""
    start = [(x + 300, y + 900) for x, y in R_PENTOMINO]
    j, t = pair(BIG, start, rule)
    for k in (40, 90):
        run_both(j, t, k, macro=32)


def test_from_state_round_trip():
    j, t = pair(BIG, [(x + 700, y + 700) for x, y in GLIDER])
    run_both(j, t, 64)
    words = np.asarray(j._packed)
    jj = jsp.SparseTorus._from_state(BIG, words, j._ox, j._oy)
    tt = tsp.SparseTorus._from_state(BIG, words, j._ox, j._oy,
                                     device="cpu")
    agree(jj, tt)
    run_both(jj, tt, 96, macro=32)


# -------------------------------------------------- K8's plain version

@pytest.mark.parametrize("shape", [(256, 64), (768, 64), (1, 1), (33, 7),
                                   (5, 130)])
def test_occupancy_plain_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    raw = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)
    raw[0, 0] = 0xFFFFFFFF  # every bit, the sign bit included
    raw[-1, -1] = 0x80000000  # the sign bit alone
    rows, cols = jsp._occupancy(jnp.asarray(raw))
    want = np.concatenate([np.asarray(rows), np.asarray(cols)])
    occ = cs.window_occupancy(words_from_numpy(raw))
    assert occ.dtype == torch.int32 and occ.shape == (sum(shape),)
    np.testing.assert_array_equal(occ.numpy(), want)
    rows, cols = occ[:shape[0]], occ[shape[0]:]
    assert int(rows.sum()) == int(cols.sum()) == int(
        np.unpackbits(raw.view(np.uint8)).sum())


def test_occupancy_sparse_words():
    """A window with a few live words: zero counts everywhere else."""
    raw = np.zeros((256, 64), dtype=np.uint32)
    raw[10, 3] = 0x80000001
    raw[200, 63] = 0x7
    occ = cs.window_occupancy(words_from_numpy(raw)).numpy()
    rows, cols = occ[:256], occ[256:]
    assert rows[10] == 2 and rows[200] == 3 and rows.sum() == 5
    assert cols[3] == 2 and cols[63] == 3 and cols.sum() == 5


def test_occupancy_on_cpu_counts_no_launch():
    cs.reset_launch_counts()
    cs.window_occupancy(torch.ones((4, 4), dtype=torch.int32))
    assert cs.window_occupancy.launches == 0
    assert cs.window_occupancy in cs.KERNELS


def test_glider_long_haul_exact_position():
    """A glider moves exactly (+1, +1) every 4 turns, so its cell set
    after N turns is closed-form: the episode scheduler, the grows and
    their analytic margins and origin updates over many regrowths, with
    the JAX object's geometry at every step."""
    start = [(x + 500, y + 500) for x, y in GLIDER]
    j, t = pair(BIG, start)
    turns = 0
    for k in (512, 1024, 1464):
        run_both(j, t, k, macro=512)
        turns += k
    d = turns // 4
    assert set(t.alive_cells()) == {((x + d) % BIG, (y + d) % BIG)
                                    for x, y in start}
    assert t.turn == turns == 3000
    assert t.grows > 1
