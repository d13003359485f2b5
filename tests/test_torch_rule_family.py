"""The life-like kernels' two rule families (`gol_tpu_torch.ops.
cuda_stencil`, `csrc/stencil.cu`): B3/S23 with the rule compiled in, and
every other rule through a table of its masks. The B3/S23 formula against
the masks' table at every state and count, the family chosen from the
rule, and the plain versions of K1, K2 and K6 on both families against the
JAX package's scan, the goldens and the table family's plain step:
bit-exact (integer boards, tolerance 0). The kernels themselves run only
on a CUDA device; `chip_smoke.py` holds them against these plain versions
there."""

import os

import numpy as np
import pytest
import torch

from gol_tpu.models import lifelike as jl
from gol_tpu.ops import bitpack as jbp

from gol_tpu_torch.io.pgm import read_pgm
from gol_tpu_torch.models import lifelike as tl
from gol_tpu_torch.ops import bitpack as tbp
from gol_tpu_torch.ops import cuda_stencil as cs

torch.set_num_threads(2)

IMAGES = os.path.join(os.path.dirname(__file__), "..", "check", "images")


def words(b):
    return tbp.words_from_numpy(tbp.pack_np(b))


def as_bits(a):
    """int32 words as uint32 values, for comparing bit patterns."""
    return a.to(torch.int64) & 0xFFFFFFFF


def table_next(mid, n9, rule):
    """Cell by cell from the rule's masks: born on n9 live neighbours for
    a dead cell, survive on n9 - 1 for a live one."""
    born, survive = rule.masks()
    if mid:
        return (survive >> (n9 - 1)) & 1 if n9 >= 1 else 0
    return (born >> n9) & 1 if n9 <= 8 else 0


@pytest.mark.parametrize("mid", [0, 1])
@pytest.mark.parametrize("n9", range(10))
def test_b3s23_formula_matches_conway_table(mid, n9):
    """(mid, n9) at a third of the bits of 64 words, every other (mid,
    n9) pair at the rest, bit 31 among them (the words read as uint32)."""
    rng = np.random.default_rng(10 * n9 + mid)
    shape = (64, 32)
    mids = rng.integers(0, 2, shape)
    counts = rng.integers(0, 10, shape)
    mids[:, 31] = 1  # a negative int32 word in every row
    here = rng.random(shape) < 1 / 3
    here[0, :] = True
    mids[here], counts[here] = mid, n9

    def plane(bits):
        return torch.tensor(
            (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
                axis=1).astype(np.uint32).view(np.int32))

    n = [plane((counts >> k) & 1) for k in range(3)]
    got = as_bits(cs._b3s23_next(plane(mids), *n))
    want = [[table_next(m, c, tl.CONWAY) for m, c in zip(mr, cr)]
            for mr, cr in zip(mids, counts)]
    assert torch.equal(got, as_bits(plane(np.array(want))))


@pytest.mark.parametrize("rulestring,family", [
    ("B3/S23", "b3s23"), ("B3/S32", "b3s23"), ("B36/S23", "table"),
    ("B2/S", "table"), ("B3/S012345678", "table"),
    ("B3678/S34678", "table"), ("B3/S2", "table")])
def test_family_from_the_rule(rulestring, family):
    """The wrappers' choice (`rule_family`) agrees with the C entry
    points' test of the masks, born == 1 << 3 and survive == 1 << 2 |
    1 << 3, and the plain versions take the same branch."""
    rule = tl.LifeLikeRule(rulestring)
    assert cs.rule_family(rule) == family
    assert (rule.masks() == (1 << 3, 1 << 2 | 1 << 3)) == (family == "b3s23")
    assert (cs._life_step(rule) is cs._step_b3s23) == (family == "b3s23")


def sweeps(plain, w, turns, depth, **kw):
    for t in cs.sweep_depths(turns, depth):
        w = plain(w, t, **kw)
    return w


# The plain versions of each kernel and geometry, as (words, turns, rule)
# -> words: K1 at the policy's N and G and at N = 16, G = 1; K2 at each R
# in 32-turn sweeps; K6 in 64-turn sweeps.
PLAIN = {
    "K1": lambda w, n, r: cs.resident_run_turns_plain(w, n, r),
    "K1 N=16 G=1": lambda w, n, r: cs.resident_run_turns_plain(
        w, n, r, ctas=16, halo=1),
    "K2 R=384": lambda w, n, r: sweeps(cs.tiled_sweep_plain, w, n, 32,
                                       rule=r, rows=384),
    "K2 R=128": lambda w, n, r: sweeps(cs.tiled_sweep_plain, w, n, 32,
                                       rule=r, rows=128),
    "K6": lambda w, n, r: sweeps(cs.tiled_sweep_deep_plain, w, n, 64,
                                 rule=r),
}


def table_path(w, turns, rule):
    """The table family's plain step on the whole torus."""
    for _ in range(turns):
        w = cs._step_shared_sums(w, rule)
    return w


@pytest.mark.parametrize("kernel", PLAIN)
@pytest.mark.parametrize("size", [64, 512])
def test_b3s23_plain_versions_on_goldens(kernel, size):
    start = read_pgm(os.path.join(IMAGES, f"{size}x{size}x0.pgm")) // 255
    golden = read_pgm(os.path.join(IMAGES, f"{size}x{size}x100.pgm")) // 255
    got = PLAIN[kernel](words(start), 100, tl.CONWAY)
    assert np.array_equal(tbp.unpack_np(tbp.words_to_numpy(got)), golden)
    want = np.asarray(jbp.packed_run_turns(jbp.pack(start), 100))
    assert np.array_equal(tbp.words_to_numpy(got), want)
    assert torch.equal(got, table_path(words(start), 100, tl.CONWAY))


@pytest.fixture(scope="module")
def board_5120():
    """A 5120² board at density 0.3 and its JAX scan after 32 turns."""
    b = (np.random.default_rng(5120).random((5120, 5120)) < 0.3).astype(
        np.uint8)
    return words(b), np.asarray(jbp.packed_run_turns(jbp.pack(b), 32))


@pytest.mark.parametrize("kernel", ["K2 R=384", "K2 R=128", "K6"])
def test_b3s23_plain_versions_at_5120(kernel, board_5120):
    """The coursework's 5120² board, one 32-turn sweep (K6 at T = 32)."""
    w, want = board_5120
    got = PLAIN[kernel](w, 32, tl.CONWAY)
    assert np.array_equal(tbp.words_to_numpy(got), want)
    assert torch.equal(got, table_path(w, 32, tl.CONWAY))


@pytest.mark.parametrize("kernel", PLAIN)
def test_highlife_through_the_plain_versions(kernel):
    """HighLife stays on the table family, bit-exact (K6 under a table
    rule among them, which no other CPU test runs)."""
    b = read_pgm(os.path.join(IMAGES, "64x64x0.pgm")) // 255
    got = PLAIN[kernel](words(b), 50, tl.HIGHLIFE)
    want = np.asarray(jbp.packed_run_turns(jbp.pack(b), 50, jl.HIGHLIFE))
    assert np.array_equal(tbp.words_to_numpy(got), want)


def test_cpu_wrappers_count_no_rule_family():
    """`by_rule` counts launches; the CPU wrappers run the plain versions
    and launch nothing, on either family."""
    cs.reset_launch_counts()
    w = words(read_pgm(os.path.join(IMAGES, "64x64x0.pgm")) // 255)
    for rule in (tl.CONWAY, tl.HIGHLIFE):
        cs.resident_run_turns(w, 3, rule)
        cs.tiled_sweep(w, torch.empty_like(w), 3, rule)
        cs.tiled_sweep_deep(w, torch.empty_like(w), 40, rule)
    assert [fn.by_rule for fn in cs.KERNELS_RULE] == [
        dict.fromkeys(cs.RULE_FAMILIES, 0)] * len(cs.KERNELS_RULE)
