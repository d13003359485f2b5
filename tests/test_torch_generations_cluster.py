"""Geometry of the port's redesigned two-plane Hopper kernels: K4's
thread-block cluster (N CTAs, each a slab of both planes) and K5's tile
heights. The policies are pure functions of the planes' shape; the plain
versions walk the same slabs and tiles the card runs, and must equal the
JAX package's packed scans and Pallas kernels (interpret mode) bit for
bit at every cluster size and tile height, for both families (gen3:
alive and dying planes; gen4: binary-encoded states). The kernels
themselves run only on a CUDA device (`chip_smoke.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gol_tpu.models import generations as jg
from gol_tpu.ops import bitpack as jbp
from gol_tpu.ops.pallas_stencil import (
    interpret_supported,
    pallas_packed_run_turns3,
    pallas_packed_run_turns4,
)

from gol_tpu_torch.models import generations as tg
from gol_tpu_torch.ops import bitpack as tbp
from gol_tpu_torch.ops import cuda_stencil as cs

torch.set_num_threads(2)

RULES = ["/2/3", "125/36/3", "345/2/4", "/234/4"]
FAMILY = {3: "gen3", 4: "gen4"}

# (rows, words a plane): 64², 512², one-word boards, the main path's
# tiled boards, and odd boards.
SHAPES = [(64, 2), (512, 16), (33, 1), (96, 1), (256, 8), (128, 4),
          (4096, 128), (16384, 512), (1024, 32), (400, 70), (5, 3), (1, 1),
          (162, 63), (3, 200), (65536, 2048)]


def rules(s):
    return tg.GenerationsRule(s), jg.GenerationsRule(s)


def state(h, w, states, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, states, size=(h, w)).astype(np.uint8)


def jplanes(b, states):
    """The JAX package's stacked (2, H, Wp) uint32 planes of a board."""
    if states == 3:
        return np.stack([np.asarray(jbp.pack((b == 1).astype(np.uint8))),
                         np.asarray(jbp.pack((b == 2).astype(np.uint8)))])
    return np.stack([np.asarray(p) for p in jg.pack_state4(b)])


def scan(b, jr, turns):
    """The JAX package's packed scan of the planes, stacked."""
    p = jplanes(b, jr.states)
    fn = (jg._packed_run_turns3_scan if jr.states == 3
          else jg._packed_run_turns4_scan)
    return np.stack([np.asarray(x) for x in fn(
        jnp.asarray(p[0]), jnp.asarray(p[1]), turns, jr)])


def setup(s, shape, seed):
    tr, jr = rules(s)
    b = state(*shape, tr.states, seed)
    return tr, jr, b, tbp.words_from_numpy(jplanes(b, tr.states))


@pytest.mark.parametrize("shape", SHAPES)
def test_geometry_policies_are_legal(shape):
    h, wp = shape
    n = cs.resident2p_cluster_ctas(h, wp)
    assert 1 <= n <= min(cs.RESIDENT_MAX_CTAS, h)
    per = cs.resident2p_rows_per_thread(h, wp, n)
    assert per >= 1 and per % 2 == 1
    assert cs._resident_slots(h, n, per) <= cs.RESIDENT2P_THREADS
    cs._check_resident_geometry(h, n, per, max_threads=cs.RESIDENT2P_THREADS)
    rows = cs.tile2p_rows(h, wp)
    assert rows in cs.TILE2P_ROW_CHOICES
    assert -(-h // rows) <= 65535
    # Two planes x two buffers of the deepest window fit one block.
    assert 4 * 4 * (rows + 2 * cs.TILE_MAX_T) * 64 <= cs.SMEM_BYTES


def test_geometry_policies_at_the_main_path_shapes():
    """The picks PERF.md reports: 512² planes on the largest cluster, 64²
    and one-word boards on one CTA at one row a thread; 4096² in 96-row
    tiles (129 blocks, one wave of 132 SMs), 16384² in 161-row tiles
    (918 blocks, 7 waves)."""
    assert cs.resident2p_cluster_ctas(512, 16) == cs.RESIDENT_MAX_CTAS
    assert cs.resident2p_rows_per_thread(512, 16, 16) == 5
    for h, wp in ((64, 2), (33, 1), (96, 1)):
        assert cs.resident2p_cluster_ctas(h, wp) == 1
        assert cs.resident2p_rows_per_thread(h, wp, 1) == 1
    assert cs.tile2p_rows(4096, 128) == 96
    assert cs.tile2p_rows(16384, 512) == 161


@pytest.mark.parametrize("shape", [(37, 3), (48, 1)])
@pytest.mark.parametrize("s", RULES)
def test_k4_slab_plain_every_cluster_size(s, shape):
    """Slabs of floor(h/N) or ceil(h/N) rows of both planes, N = 1..16,
    on boards N does not divide, one word wide or a few: equal to the
    JAX package's scan."""
    tr, jr, b, p = setup(s, (shape[0], shape[1] * 32), sum(shape))
    want = scan(b, jr, 9)
    for n in range(1, cs.RESIDENT_MAX_CTAS + 1):
        got = cs.resident_run_turns2p(p, 9, tr, FAMILY[tr.states], ctas=n)
        np.testing.assert_array_equal(tbp.words_to_numpy(got), want,
                                      err_msg=f"N={n}")


@pytest.mark.parametrize("h", [1, 2, 5, 16])
@pytest.mark.parametrize("s", ["/2/3", "345/2/4"])
def test_k4_slab_plain_one_row_slabs(s, h):
    """N = h: every CTA holds one row of each plane, whose rows above and
    below are both its neighbours'."""
    tr, jr, b, p = setup(s, (h, 64), h)
    got = cs.resident_run_turns2p_plain(p, 7, tr, FAMILY[tr.states], ctas=h)
    np.testing.assert_array_equal(tbp.words_to_numpy(got), scan(b, jr, 7))


@pytest.mark.parametrize("shape", [(256, 256), (40, 52 * 32)])
@pytest.mark.parametrize("s", ["/2/3", "345/2/4"])
def test_k4_slab_plain_matches_pallas_at_policy(s, shape):
    """At the policy's N (16 here: slabs of 16 rows, and of 2 or 3)
    against the TPU kernel."""
    ok, why = interpret_supported()
    if not ok:
        pytest.skip(why)
    tr, jr, b, p = setup(s, shape, sum(shape))
    h, wp = shape[0], shape[1] // 32
    assert cs.resident2p_cluster_ctas(h, wp) > 1
    kernel = (pallas_packed_run_turns3 if tr.states == 3
              else pallas_packed_run_turns4)
    want = np.asarray(kernel(jnp.asarray(jplanes(b, tr.states)), 6, jr,
                             interpret=True))
    got = cs.resident_run_turns2p(p, 6, tr, FAMILY[tr.states])
    np.testing.assert_array_equal(tbp.words_to_numpy(got), want)


@pytest.mark.parametrize("rows", cs.TILE2P_ROW_CHOICES)
@pytest.mark.parametrize("shape,t", [
    ((50, 3 * 32), 32), ((1, 32), 1), ((100, 10 * 32), 7),
    ((162, 2 * 32), 32), ((97, 63 * 32), 32), ((161, 64 * 32), 5)])
@pytest.mark.parametrize("s", ["/2/3", "345/2/4"])
def test_k5_plain_every_tile_height(s, shape, t, rows):
    """Every candidate R on boards shorter and narrower than one window,
    on boards one row taller than a tile (162 rows against R = 161, 97
    against 96), and one word wider (63 words against 62)."""
    tr, jr, b, p = setup(s, shape, rows + t + shape[0])
    got = cs.tiled_sweep2p_plain(p, t, tr, FAMILY[tr.states], rows=rows)
    np.testing.assert_array_equal(tbp.words_to_numpy(got), scan(b, jr, t))


@pytest.mark.parametrize("s", RULES)
def test_k5_wrapper_and_banded_run_at_pinned_and_policy_rows(s):
    """`tiled_sweep2p(..., rows=R)` runs R's plain version on the CPU, and
    `banded_run_turns2p` (the policy's R) equals the scan over 36 turns."""
    tr, jr, b, p = setup(s, (170, 64), 170)
    fam = FAMILY[tr.states]
    for rows in cs.TILE2P_ROW_CHOICES:
        out = torch.empty_like(p)
        cs.tiled_sweep2p(p, out, 20, tr, fam, rows=rows)
        np.testing.assert_array_equal(tbp.words_to_numpy(out),
                                      scan(b, jr, 20))
    got = cs.banded_run_turns2p(p, 36, tr, fam)
    np.testing.assert_array_equal(tbp.words_to_numpy(got), scan(b, jr, 36))


@pytest.mark.parametrize("ctas,per", [(0, 3), (17, 3), (9, 3), (2, 0),
                                      (1, 1)])
def test_k4_rejects_illegal_geometry(ctas, per):
    """N outside 1..min(16, h) on an 8-row board, no rows per thread, or
    a walk that needs more than K4's 512 thread slots (one CTA, one row a
    thread, 1024 rows)."""
    h = 1024 if (ctas, per) == (1, 1) else 8
    p = tbp.words_from_numpy(jplanes(state(h, 32, 3, seed=1), 3))
    with pytest.raises(ValueError):
        cs.resident_run_turns2p(p, 2, tg.BRIANS_BRAIN, "gen3", ctas=ctas,
                                per=per)
    if not 1 <= ctas <= min(cs.RESIDENT_MAX_CTAS, h):
        with pytest.raises(ValueError):
            cs.resident_run_turns2p_plain(p, 2, tg.BRIANS_BRAIN, "gen3",
                                          ctas=ctas)


@pytest.mark.parametrize("rows", [0, 96 + 1, 128, 160, 384])
def test_k5_rejects_illegal_rows(rows):
    p = tbp.words_from_numpy(jplanes(state(8, 32, 4, seed=1), 4))
    with pytest.raises(ValueError):
        cs.tiled_sweep2p(p, torch.empty_like(p), 4, tg.STAR_WARS, "gen4",
                         rows=rows)
