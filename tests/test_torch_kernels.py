"""Plain versions of the port's Hopper kernels (`gol_tpu_torch.ops.
cuda_stencil`) against the JAX package's Pallas kernels in interpret mode
and its jnp scan: bit-exact (integer boards, tolerance 0). The kernels
themselves run only on a CUDA device; `chip_smoke.py` holds them against
these plain versions there."""

import numpy as np
import pytest
import torch

from gol_tpu.models import lifelike as jl
from gol_tpu.ops import bitpack as jbp
from gol_tpu.ops.pallas_stencil import (
    BAND_T,
    banded_packed_run_turns,
    interpret_supported,
    pallas_packed_run_turns,
)

from gol_tpu_torch.models import lifelike as tl
from gol_tpu_torch.ops import bitpack as tbp
from gol_tpu_torch.ops import cuda_stencil as cs
from gol_tpu_torch.parallel.halo import (
    packed_run_by_kind,
    packed_run_kind,
    select_representation,
)

torch.set_num_threads(2)


@pytest.fixture
def pallas():
    ok, why = interpret_supported()
    if not ok:
        pytest.skip(why)


def board(h, w, seed, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < density).astype(np.uint8)


def words(b):
    return tbp.words_from_numpy(tbp.pack_np(b))


@pytest.mark.parametrize("shape", [(32, 32), (16, 64), (64, 96)])
def test_resident_plain_matches_pallas(shape, pallas):
    b = board(*shape, seed=sum(shape))
    want = np.asarray(pallas_packed_run_turns(jbp.pack(b), 8,
                                              interpret=True))
    got = cs.resident_run_turns(words(b), 8)
    assert np.array_equal(tbp.words_to_numpy(got), want)


@pytest.mark.parametrize("rule", ["B36/S23", "B3678/S34678", "B2/S"])
def test_resident_plain_matches_pallas_rules(rule, pallas):
    b = board(32, 64, seed=4)
    want = np.asarray(pallas_packed_run_turns(
        jbp.pack(b), 6, jl.LifeLikeRule(rule), interpret=True))
    got = cs.resident_run_turns(words(b), 6, tl.LifeLikeRule(rule))
    assert np.array_equal(tbp.words_to_numpy(got), want)


def test_resident_zero_turns_and_one_word_board():
    b = board(33, 32, seed=9)
    w = words(b)
    assert cs.resident_run_turns(w, 0) is w
    got = cs.resident_run_turns(w, 13)
    want = np.asarray(jbp.packed_run_turns(jbp.pack(b), 13))
    assert np.array_equal(tbp.words_to_numpy(got), want)


@pytest.mark.parametrize("turns,rule", [(BAND_T, "B3/S23"),
                                        (BAND_T + 4, "B3/S23"),
                                        (BAND_T, "B36/S23")])
def test_banded_matches_pallas_banded(turns, rule, pallas):
    b = board(64, 4096, seed=31)
    want = np.asarray(banded_packed_run_turns(
        jbp.pack(b), turns, jl.LifeLikeRule(rule), interpret=True))
    got = cs.banded_run_turns(words(b), turns, tl.LifeLikeRule(rule))
    assert np.array_equal(tbp.words_to_numpy(got), want)


@pytest.mark.parametrize("t", [1, 7, 32])
@pytest.mark.parametrize("shape", [(400, 70 * 32), (5, 3 * 32), (1, 32),
                                   (385, 63 * 32), (3, 200 * 32)])
def test_tiled_sweep_plain_matches_scan(shape, t):
    """Boards not aligned to the 384 x 62-word tile, and boards shorter
    or narrower than one tile window (modular window indices)."""
    b = board(*shape, seed=shape[0] + t)
    want = np.asarray(jbp.packed_run_turns(jbp.pack(b), t))
    assert np.array_equal(
        tbp.words_to_numpy(cs.tiled_sweep_plain(words(b), t)), want)


def test_tiled_sweep_rule_and_output_buffer():
    b = board(390, 64 * 32, seed=2)
    w = words(b)
    out = torch.zeros_like(w)
    cs.tiled_sweep(w, out, 20, tl.SEEDS)
    want = np.asarray(jbp.packed_run_turns(jbp.pack(b), 20, jl.SEEDS))
    assert np.array_equal(tbp.words_to_numpy(out), want)


@pytest.mark.parametrize("bad", [0, 33])
def test_tiled_sweep_rejects_depth(bad):
    w = words(board(8, 32, seed=1))
    with pytest.raises(ValueError):
        cs.tiled_sweep(w, torch.empty_like(w), bad)


def test_tiled_sweep_rejects_aliased_output():
    w = words(board(8, 32, seed=1))
    with pytest.raises(ValueError):
        cs.tiled_sweep(w, w, 4)


def test_banded_run_turns_depths():
    """floor(K/32) sweeps at 32, then K mod 32; the input is kept."""
    b = board(70, 96, seed=5)
    w = words(b)
    before = w.clone()
    for k in (1, 31, 32, 65):
        got = cs.banded_run_turns(w, k)
        want = np.asarray(jbp.packed_run_turns(jbp.pack(b), k))
        assert np.array_equal(tbp.words_to_numpy(got), want)
    assert torch.equal(w, before)
    assert cs.banded_run_turns(w, 0) is w


@pytest.mark.parametrize("shape,kind", [
    ((512, 16), "resident"), ((64, 2), "resident"), ((32, 1), "resident"),
    ((5120, 160), "tiled"), ((65536, 2048), "tiled"), ((1024, 32), "tiled"),
])
def test_packed_run_kind(shape, kind):
    assert packed_run_kind(shape) == kind  # shapes only, nothing allocated
    assert packed_run_by_kind(kind) in (cs.resident_run_turns,
                                        cs.banded_run_turns)


def test_select_representation():
    assert select_representation(512)[0] is True
    assert select_representation(16)[0] is False


def test_cpu_wrappers_run_plain_and_count_nothing():
    cs.reset_launch_counts()
    b = board(64, 64, seed=3)
    w = words(b)
    assert torch.equal(cs.resident_run_turns(w, 3),
                       cs.resident_run_turns_plain(w, 3))
    out = torch.empty_like(w)
    cs.tiled_sweep(w, out, 3)
    assert torch.equal(out, cs.tiled_sweep_plain(w, 3))
    assert torch.equal(cs.row_popcounts(w), tbp.row_popcounts_plain(w))
    assert [fn.launches for fn in cs.KERNELS] == [0] * len(cs.KERNELS)


def test_probe_names_what_is_missing():
    probe = cs.cuda_probe()
    assert "torch" in probe and "nvcc" in probe
