"""The torch port's plain stepping ops (`gol_tpu_torch.ops.bitpack`,
`gol_tpu_torch.ops.stencil`) against the JAX package and the numpy
oracle: bit-exact (integer boards, tolerance 0)."""

import numpy as np
import pytest
import torch

from gol_tpu.models import lifelike as jl
from gol_tpu.ops import bitpack as jbp
from gol_tpu.ops import stencil as jst
from gol_tpu.ops.reference import run_turns_np

from gol_tpu_torch.models import lifelike as tl
from gol_tpu_torch.ops import bitpack as tbp
from gol_tpu_torch.ops import stencil as tst
from gol_tpu_torch.ops.cuda_stencil import row_popcounts

torch.set_num_threads(2)

RULES = ["B3/S23", "B36/S23", "B3678/S34678", "B2/S"]


def board(h, w, seed, density=0.35):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < density).astype(np.uint8)


def tw(b):
    """Port words of a {0,1} board."""
    return tbp.words_from_numpy(tbp.pack_np(b))


@pytest.mark.parametrize("shape", [(1, 32), (7, 64), (33, 96), (64, 128),
                                   (2, 5, 64)])
def test_pack_unpack_match_jax(shape):
    b = board(int(np.prod(shape[:-1])), shape[-1],
              seed=sum(shape)).reshape(shape)
    jw = np.asarray(jbp.pack(b))
    assert np.array_equal(tbp.pack_np(b), jw)
    words = tbp.pack(torch.from_numpy(b))
    assert words.dtype == torch.int32
    assert np.array_equal(tbp.words_to_numpy(words), jw)
    assert np.array_equal(tbp.unpack(words).numpy(), b)
    assert np.array_equal(tbp.unpack_np(jw), np.asarray(jbp.unpack(jw)))
    assert np.array_equal(
        tbp.words_to_numpy(tbp.words_from_numpy(jw)), jw)


def test_pack_rejects_ragged_width():
    with pytest.raises(ValueError):
        tbp.pack_np(np.zeros((4, 20), dtype=np.uint8))


def test_pixels_pack_like_cells():
    b = board(8, 64, seed=2)
    assert np.array_equal(tbp.pack_np(b * 255), tbp.pack_np(b))


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("shape", [(32, 32), (33, 32), (17, 64), (8, 160),
                                   (3, 96)])
def test_packed_run_turns_matches_jax(shape, rule):
    b = board(*shape, seed=shape[0] * 31 + shape[1])
    jr, tr = jl.LifeLikeRule(rule), tl.LifeLikeRule(rule)
    want = np.asarray(jbp.packed_run_turns(jbp.pack(b), 9, jr))
    got = tbp.words_to_numpy(tbp.packed_run_turns(tw(b), 9, tr))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(32, 32), (31, 64), (64, 96)])
def test_packed_run_turns_matches_oracle(shape):
    b = board(*shape, seed=7)
    got = tbp.unpack(tbp.packed_run_turns(tw(b), 12)).numpy()
    assert np.array_equal(got, run_turns_np(b, 12))


def test_packed_zero_turns_and_batch_axis():
    b = board(2 * 16, 64, seed=3).reshape(2, 16, 64)
    words = tw(b)
    assert tbp.packed_run_turns(words, 0) is words
    stepped = tbp.packed_run_turns(words, 3)
    for i in range(2):
        assert torch.equal(stepped[i], tbp.packed_run_turns(words[i], 3))


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("shape", [(16, 16), (9, 20), (33, 33)])
def test_u8_run_turns_matches_jax(shape, rule):
    b = board(*shape, seed=shape[0] + shape[1])
    want = np.asarray(jst.run_turns(b, 10, jl.LifeLikeRule(rule)))
    got = tst.run_turns(torch.from_numpy(b), 10, tl.LifeLikeRule(rule))
    assert np.array_equal(got.numpy(), want)


def test_u8_pixels_and_counts():
    b = board(20, 24, seed=5)
    px = tst.to_pixels(torch.from_numpy(b))
    assert np.array_equal(px.numpy(), np.asarray(jst.to_pixels(b)))
    assert torch.equal(tst.from_pixels(px), torch.from_numpy(b))
    assert tst.alive_count_exact(torch.from_numpy(b)) == \
        int(jst.alive_count_exact(b))
    assert np.array_equal(tst.neighbour_counts(torch.from_numpy(b)).numpy(),
                          np.asarray(jst.neighbour_counts(b)))


@pytest.mark.parametrize("shape", [(1, 32), (33, 64), (64, 2048)])
def test_row_popcounts_match_jax(shape):
    b = board(*shape, seed=shape[0], density=0.6)
    jw = jbp.pack(b)
    rows = tbp.row_popcounts_plain(tw(b))
    assert rows.dtype == torch.int32
    assert np.array_equal(rows.numpy(), np.asarray(jbp._row_popcounts(jw)))
    assert tbp.packed_alive_count(tw(b)) == jbp.packed_alive_count(jw)
    assert torch.equal(row_popcounts(tw(b)), rows)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("rule", RULES)
def test_rule_masks_match_jax(rule, offset):
    rng = np.random.default_rng(offset)
    planes = rng.integers(0, 2**32, size=(4, 8), dtype=np.uint32)
    r = jl.LifeLikeRule(rule)
    want = jbp.rule_masks(*planes, r.born, r.survive, offset)
    got = tbp.rule_masks(*[torch.from_numpy(p.view(np.int32))
                           for p in planes], r.born, r.survive, offset)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w))
    mid = planes[0] ^ planes[3]
    want = jbp._rule_from_count_bits(mid, *planes, r, offset)
    got = tbp._rule_from_count_bits(
        torch.from_numpy(mid.view(np.int32)),
        *[torch.from_numpy(p.view(np.int32)) for p in planes],
        tl.LifeLikeRule(rule), offset)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
