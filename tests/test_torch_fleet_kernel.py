"""K9, the fleet's batched step (`gol_tpu_torch.ops.cuda_stencil.
fleet_run_turns`), through its plain version on the CPU: each route's
decomposition against `gol_tpu.fleet.buckets.step_program` (a jnp scan
over the slots plus each slot's popcount), fed the same numpy-seeded
(cap, hb, wpb) uint32 batch. Tolerance: exact (words and counts)."""

import numpy as np
import pytest
import torch

from gol_tpu.fleet.buckets import step_program
from gol_tpu.models import HIGHLIFE as J_HIGHLIFE
from gol_tpu.models import CONWAY as J_CONWAY

from gol_tpu_torch.fleet.buckets import bucket_from_jax, bucket_to_jax
from gol_tpu_torch.models.lifelike import CONWAY, HIGHLIFE
from gol_tpu_torch.ops import cuda_stencil as cs

torch.set_num_threads(2)

# (rows, words): the tests' 64² class, a 128² class and the private
# bucket of a 24 x 24 legacy board (24 x lcm(24, 32) = 24 x 96 cells).
SHAPES = ((64, 2), (128, 4), (24, 3))
QUANTA = (1, 8, 33, 64)


def _batch(cap: int, h: int, wp: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (cap, h, wp), dtype=np.uint64).astype(
        np.uint32)


def _jax_step(words: np.ndarray, turns: int, rule=J_CONWAY):
    out, alive = step_program(rule, turns)(words)
    return np.asarray(out), np.asarray(alive)


def _check(words: np.ndarray, turns: int, jrule=J_CONWAY, rule=CONWAY,
           **geometry) -> None:
    want_w, want_a = _jax_step(words, turns, jrule)
    got_w, got_a = cs.fleet_run_turns_plain(
        bucket_from_jax(words), turns, rule, **geometry)
    np.testing.assert_array_equal(bucket_to_jax(got_w), want_w)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    assert got_a.dtype == torch.int32


@pytest.mark.parametrize("turns", QUANTA)
@pytest.mark.parametrize("kind", cs.FLEET_ROUTES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}w")
def test_routes_match_step_program(shape, kind, turns):
    """Both routes' decompositions (route 1's slabs, route 2's tiles and
    sweeps of at most 32 turns) equal the JAX scan, caps 1-16."""
    h, wp = shape
    cap = 1 + (h * 7 + wp * 3 + turns) % 16
    words = _batch(cap, h, wp, seed=h * 1000 + wp * 10 + turns)
    _check(words, turns, kind=kind)


@pytest.mark.parametrize("ctas", (1, 2, 4, 8, 16))
def test_route1_every_cluster_size(ctas):
    """Route 1 at every CTA count a slot may take (slabs of 8-128 rows):
    each slab's rows from its neighbours, each slot its own torus."""
    _check(_batch(3, 128, 4, seed=ctas), 9, ctas=ctas)


@pytest.mark.parametrize("rows", cs.TILE_ROW_CHOICES)
def test_route2_every_tile_height(rows):
    """Route 2 at each tile height, with 40 turns: two sweeps (32 + 8)."""
    _check(_batch(2, 128, 4, seed=rows), 40, kind="tiled", rows=rows)


@pytest.mark.parametrize("cap", (1, 2, 5, 16))
def test_other_rule_and_caps(cap):
    """A rule other than Conway's (HighLife, B36/S23) at several caps."""
    _check(_batch(cap, 64, 2, seed=100 + cap), 8, J_HIGHLIFE, HIGHLIFE)


def test_popcounts_exact_at_the_extremes():
    """Empty and full slots count 0 and hb x wb: the bounds the fleet's
    quarantine check reads as plausible."""
    words = np.zeros((3, 64, 2), dtype=np.uint32)
    words[1] = 0xFFFFFFFF
    out, alive = cs.fleet_run_turns_plain(bucket_from_jax(words), 0)
    assert alive.tolist() == [0, 64 * 64, 0]
    _check(words, 1)


def test_route_and_geometry_policy():
    """Route from the shape alone (K1's shared memory); route 1's CTAs a
    slot from K1's cluster, halved until the batch fits the card's SMs;
    route 2's tile height over the batch's blocks."""
    assert cs.fleet_run_kind((8, 512, 16)) == "resident"
    assert cs.fleet_run_kind((8, 1024, 32)) == "tiled"
    assert cs.fleet_run_kind((8, 2048, 64)) == "tiled"
    assert cs.fleet_run_kind((1, 24, 3)) == "resident"
    assert cs.fleet_resident_ctas(1, 512, 16) == 16
    assert cs.fleet_resident_ctas(8, 512, 16) == 16
    assert cs.fleet_resident_ctas(64, 512, 16) == 2
    assert cs.fleet_resident_ctas(512, 512, 16) == 1
    assert cs.fleet_resident_ctas(2, 64, 2) == 1
    for cap in (1, 8, 64, 512):
        n = cs.fleet_resident_ctas(cap, 512, 16)
        assert n == 1 or cap * n <= cs.CARD_SMS
    assert cs.fleet_tile_rows(8, 1024, 32) == 128
    assert cs.fleet_tile_rows(1, 65536, 2048) == cs.tile_rows(65536, 2048)
    assert cs.fleet_tile_rows(8, 2048, 64) in cs.TILE_ROW_CHOICES


def test_wrapper_refuses_what_the_routes_do_not_take():
    words = bucket_from_jax(_batch(2, 64, 2, seed=1))
    with pytest.raises(ValueError, match="cap, H, Wp"):
        cs.fleet_run_turns(words[0], 8)
    with pytest.raises(ValueError, match="route"):
        cs.fleet_run_turns(words, 8, kind="banded")
    with pytest.raises(ValueError, match="rows"):
        cs.fleet_run_turns(words, 8, rows=128)
    with pytest.raises(ValueError, match="ctas"):
        cs.fleet_run_turns(words, 8, kind="tiled", ctas=2)
    with pytest.raises(ValueError, match="not in"):
        cs.fleet_run_turns(words, 8, kind="tiled", rows=100)
    big = torch.zeros((1, 1024, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="route 1"):
        cs.fleet_run_turns(big, 8, kind="resident")


def test_cpu_wrapper_runs_the_plain_version_and_never_writes_input():
    """On a CPU tensor the wrapper is the plain version; the input stays
    as it was (the kernel writes a new batch)."""
    src = _batch(4, 64, 2, seed=5)
    words = bucket_from_jax(src)
    out, alive = cs.fleet_run_turns(words, 8)
    want_w, want_a = _jax_step(src, 8)
    np.testing.assert_array_equal(bucket_to_jax(out), want_w)
    np.testing.assert_array_equal(alive.numpy(), want_a)
    np.testing.assert_array_equal(bucket_to_jax(words), src)


def test_bucket_from_jax_is_a_view_of_the_bits():
    src = _batch(2, 24, 3, seed=9)
    t = bucket_from_jax(src)
    assert t.dtype == torch.int32 and tuple(t.shape) == src.shape
    np.testing.assert_array_equal(t.numpy().view(np.uint32), src)
    np.testing.assert_array_equal(bucket_to_jax(t), src)
