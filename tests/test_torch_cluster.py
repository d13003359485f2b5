"""Geometry of the port's redesigned Hopper kernels: K1's thread-block
cluster (N CTAs, each a slab of rows) and K2's tile heights. The
policies are pure functions of the board's shape; the plain versions
walk the same slabs and tiles the card runs, and must equal the JAX
package's whole-board scan and Pallas kernel (interpret mode) bit for
bit at every cluster size and tile height. The kernels themselves run
only on a CUDA device (`chip_smoke.py`)."""

import numpy as np
import pytest
import torch

from gol_tpu.models import lifelike as jl
from gol_tpu.ops import bitpack as jbp
from gol_tpu.ops.pallas_stencil import (
    interpret_supported,
    pallas_packed_run_turns,
)

from gol_tpu_torch.models import lifelike as tl
from gol_tpu_torch.ops import bitpack as tbp
from gol_tpu_torch.ops import cuda_stencil as cs

torch.set_num_threads(2)

# (rows, words): 64², 512², one-word boards, the main path's tiled
# boards, and the odd boards of test_torch_kernels.py's tiled tests.
SHAPES = [(64, 2), (512, 16), (33, 1), (96, 1), (5120, 160), (8192, 256),
          (65536, 2048), (400, 70), (5, 3), (1, 1), (385, 63), (3, 200)]


def board(h, w, seed, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < density).astype(np.uint8)


def words(b):
    return tbp.words_from_numpy(tbp.pack_np(b))


def scan(b, turns, rule="B3/S23"):
    return np.asarray(jbp.packed_run_turns(jbp.pack(b), turns,
                                           jl.LifeLikeRule(rule)))


@pytest.mark.parametrize("shape", SHAPES)
def test_geometry_policies_are_legal(shape):
    h, wp = shape
    n = cs.resident_cluster_ctas(h, wp)
    assert 1 <= n <= min(cs.RESIDENT_MAX_CTAS, h)
    per = cs.resident_rows_per_thread(h, wp, n)
    assert per >= 1 and per % 2 == 1
    assert cs._resident_slots(h, n, per) <= cs.RESIDENT_THREADS
    cs._check_resident_geometry(h, n, per)
    rows = cs.tile_rows(h, wp)
    assert rows in cs.TILE_ROW_CHOICES
    assert -(-h // rows) <= 65535


def test_geometry_policies_at_the_main_path_shapes():
    """The picks measured best on the card (PERF.md): 512² on the largest
    cluster at 5 rows a thread, 64² and one-word boards on one CTA at one
    row a thread; 5120² in 128-row tiles (120 blocks, one wave), 8192²
    and 65536² in 384-row tiles."""
    assert cs.resident_cluster_ctas(512, 16) == cs.RESIDENT_MAX_CTAS
    assert cs.resident_rows_per_thread(512, 16, 16) == 5
    for h, wp in ((64, 2), (33, 1), (96, 1)):
        assert cs.resident_cluster_ctas(h, wp) == 1
        assert cs.resident_rows_per_thread(h, wp, 1) == 1
    assert cs.tile_rows(5120, 160) == 128
    assert cs.tile_rows(8192, 256) == 384
    assert cs.tile_rows(65536, 2048) == 384


@pytest.mark.parametrize("shape", [(37, 3), (48, 1)])
def test_slab_plain_every_cluster_size(shape):
    """Slabs of floor(h/N) or ceil(h/N) rows, N = 1..16, on boards N does
    not divide, one word wide or a few: equal to the whole-board scan."""
    h, wp = shape
    b = board(h, wp * 32, seed=h + wp)
    want = scan(b, 9)
    w = words(b)
    for n in range(1, cs.RESIDENT_MAX_CTAS + 1):
        got = cs.resident_run_turns(w, 9, ctas=n)
        assert np.array_equal(tbp.words_to_numpy(got), want), n


@pytest.mark.parametrize("h", [1, 2, 5, 16])
def test_slab_plain_one_row_slabs(h):
    """N = h: every CTA holds one row, whose rows above and below are
    both its neighbours'."""
    b = board(h, 64, seed=h)
    got = cs.resident_run_turns_plain(words(b), 7, tl.HIGHLIFE, ctas=h)
    assert np.array_equal(tbp.words_to_numpy(got), scan(b, 7, "B36/S23"))


@pytest.mark.parametrize("shape", [(256, 256), (40, 52 * 32)])
def test_slab_plain_matches_pallas_at_policy(shape):
    """At the policy's N (16 here: slabs of 16 rows, and of 2 or 3)
    against the TPU kernel."""
    ok, why = interpret_supported()
    if not ok:
        pytest.skip(why)
    b = board(*shape, seed=sum(shape))
    h, wp = shape[0], shape[1] // 32
    assert cs.resident_cluster_ctas(h, wp) > 1
    want = np.asarray(pallas_packed_run_turns(jbp.pack(b), 6,
                                              interpret=True))
    got = cs.resident_run_turns(words(b), 6)
    assert np.array_equal(tbp.words_to_numpy(got), want)


@pytest.mark.parametrize("rows", cs.TILE_ROW_CHOICES)
@pytest.mark.parametrize("shape,t", [((50, 3 * 32), 32), ((100, 10 * 32), 7),
                                     ((1, 32), 1), ((130, 70 * 32), 32),
                                     ((129, 63 * 32), 32), ((385, 2 * 32), 5)])
def test_tiled_plain_every_tile_height(rows, shape, t):
    """Every candidate R on boards shorter and narrower than one window,
    and on boards one row taller than a tile, or one word wider."""
    b = board(*shape, seed=rows + t)
    got = cs.tiled_sweep_plain(words(b), t, rows=rows)
    assert np.array_equal(tbp.words_to_numpy(got), scan(b, t))


@pytest.mark.parametrize("ctas,per", [(0, 3), (17, 3), (9, 3), (2, 0),
                                      (1, 1)])
def test_resident_rejects_illegal_geometry(ctas, per):
    """N outside 1..min(16, h) on an 8-row board, no rows per thread, or
    a walk that needs more than 1024 thread slots (one CTA, one row a
    thread, 2048 rows)."""
    h = 2048 if (ctas, per) == (1, 1) else 8
    w = words(board(h, 32, seed=1))
    with pytest.raises(ValueError):
        cs.resident_run_turns(w, 2, ctas=ctas, per=per)


@pytest.mark.parametrize("rows", [0, 96, 100, 192, 320])
def test_tiled_sweep_rejects_illegal_rows(rows):
    w = words(board(8, 32, seed=1))
    with pytest.raises(ValueError):
        cs.tiled_sweep(w, torch.empty_like(w), 4, rows=rows)
