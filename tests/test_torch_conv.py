"""The port's conv/FFT tier (`gol_tpu_torch/ops/conv.py`) and K7's
plain version against the JAX package (`gol_tpu/ops/conv.py`) on the
same seeded numpy inputs: neighbourhood taps, both tiers' counts bit-exact
at non-power-of-two shapes and under a heavy DC term, `run_turns`
bit-identical for the Larger-than-Life rules on each tier, K7's plain
version against JAX `_ltl_step` (a board narrower than the box, counts
above 65,535), Conway as an LtL rule against the port's packed Conway,
and the `select_tier` policy. Tolerance: 0 (integer boards)."""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gol_tpu.models import largerthanlife as jltl
from gol_tpu.ops import conv as JC

from gol_tpu_torch.models import largerthanlife as tltl
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.ops import bitpack, conv as C, cuda_stencil as cs
from gol_tpu_torch.ops import stencil

torch.set_num_threads(2)

SHAPES = [(96, 80), (50, 70), (63, 49)]


def _board(shape, seed, p=0.35):
    return (np.random.default_rng(seed).random(shape) < p).astype(np.uint8)


# ------------------------------------------------------------- kernels


@pytest.mark.parametrize("kind", ["M", "N", "C"])
@pytest.mark.parametrize("middle", [False, True])
def test_neighborhood_kernel_matches_jax(kind, middle):
    for r in (1, 2, 5, 13):
        np.testing.assert_array_equal(
            C.neighborhood_kernel(r, kind, middle),
            JC.neighborhood_kernel(r, kind, middle))
    assert C.neighborhood_kernel(2, "M").sum() == 24
    assert C.neighborhood_kernel(2, "N", middle=True).sum() == 13
    assert C.neighborhood_kernel(2, "C").sum() == 12


def test_neighborhood_kernel_refusals():
    with pytest.raises(ValueError):
        C.neighborhood_kernel(0)
    with pytest.raises(ValueError):
        C.neighborhood_kernel(2, "X")


@pytest.mark.parametrize("key", [("ltl", 3, "M", True), ("ltl", 4, "C", False),
                                 ("ltl", 2, "N", False), ("lenia", 6)])
def test_embed_kernel_and_spectrum_match_jax(key):
    kern = C.kernel_from_key(key)
    np.testing.assert_array_equal(kern, JC.kernel_from_key(key))
    for h, w in ((40, 56), (27, 31)):
        np.testing.assert_array_equal(C._embed_kernel(kern, h, w),
                                      JC._embed_kernel(kern, h, w))
        np.testing.assert_array_equal(C._fft_spectrum_np(h, w, key),
                                      JC._fft_spectrum_np(h, w, key))


def test_kernel_wider_than_torus_refused():
    with pytest.raises(ValueError):
        C._embed_kernel(C.neighborhood_kernel(8, "M"), 16, 64)


def test_box_center_delta_matches_jax():
    for key in (("ltl", 3, "M", True), ("ltl", 3, "M", False),
                ("ltl", 3, "N", True), ("lenia", 5)):
        kern = C.kernel_from_key(key)
        assert C._box_center_delta(kern) == JC._box_center_delta(kern)


def test_oracles_match_jax():
    b = _board((40, 56), 1, 0.4)
    for r in (1, 3, 7):
        for middle in (False, True):
            np.testing.assert_array_equal(C.box_counts_np(b, r, middle),
                                          JC.box_counts_np(b, r, middle))
            kern = C.neighborhood_kernel(r, "C", middle)
            np.testing.assert_array_equal(C.counts_np(b, kern),
                                          JC.counts_np(b, kern))


# ----------------------------------------------- tier parity vs JAX


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["M", "N", "C"])
@pytest.mark.parametrize("tier", ["conv", "fft"])
def test_counts_bit_exact_nonpow2(shape, kind, tier):
    """Each tier's sums equal the JAX tier's and the numpy oracle's once
    rounded, at every radius and M0/M1."""
    b = _board(shape, 2)
    tfn = C.conv_neighbor_sum if tier == "conv" else C.fft_neighbor_sum
    jfn = JC.conv_neighbor_sum if tier == "conv" else JC.fft_neighbor_sum
    for r in (1, 2, 3, 5, 8):
        for middle in (False, True):
            key = ("ltl", r, kind, middle)
            want = np.rint(C.counts_np(b, C.kernel_from_key(key))).astype(
                np.int64)
            got = np.rint(tfn(torch.from_numpy(b).float(), key).numpy())
            jgot = np.rint(np.asarray(jfn(
                jnp.asarray(b, dtype=jnp.float32), key)))
            np.testing.assert_array_equal(got.astype(np.int64), want)
            np.testing.assert_array_equal(got, jgot)
            if kind == "M":
                np.testing.assert_array_equal(
                    want, C.box_counts_np(b, r, middle))


def test_fft_exact_under_heavy_dc():
    rng = np.random.default_rng(1)
    b = np.ones((128, 96), dtype=np.uint8)
    b[rng.integers(0, 128, 200), rng.integers(0, 96, 200)] = 0
    key = ("ltl", 8, "M", False)
    got = np.rint(C.fft_neighbor_sum(torch.from_numpy(b), key).numpy())
    np.testing.assert_array_equal(got.astype(np.int64),
                                  C.box_counts_np(b, 8))
    jgot = np.rint(np.asarray(JC.fft_neighbor_sum(
        jnp.asarray(b, dtype=jnp.float32), key)))
    np.testing.assert_array_equal(got, jgot)


NN_RULE = "R3,C0,M0,S4..9,B5..7,NN"
NC_RULE = "R4,C0,M1,S14..30,B15..22,NC"
RULES = [tltl.CONWAY_LTL.rulestring, tltl.BOSCO.rulestring,
         tltl.MAJORITY_R4.rulestring, NN_RULE, NC_RULE]


@pytest.mark.parametrize("rulestring", RULES)
@pytest.mark.parametrize("tier", ["conv", "fft"])
def test_run_turns_bit_identical_to_jax(rulestring, tier):
    """`run_turns` equals `gol_tpu.ops.conv.run_turns` and the numpy
    oracle at every turn (one turn a call, so each turn is compared)."""
    trule = tltl.LargerThanLifeRule(rulestring)
    jrule = jltl.LargerThanLifeRule(rulestring)
    assert trule.rulestring == jrule.rulestring
    b = _board((64, 96), 3)
    got = torch.from_numpy(b)
    jgot = jnp.asarray(b)
    want = b
    for turn in range(4):
        got = C.run_turns(got, 1, trule, tier=tier)
        jgot = JC.run_turns(jgot, 1, jrule, tier=tier)
        want = jltl.step_np(want, jrule)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgot),
                                      err_msg=f"turn {turn + 1}")
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tltl.run_turns_np(b, 4, trule), jltl.run_turns_np(b, 4, jrule))


@pytest.mark.parametrize("tier", ["conv", "fft"])
def test_run_turns_meters_dispatch(tier):
    before = obs.CONV_DISPATCHES.labels(tier=tier).value
    C.run_turns(torch.from_numpy(_board((32, 32), 4)), 1, tltl.BOSCO,
                tier=tier)
    assert obs.CONV_DISPATCHES.labels(tier=tier).value == before + 1
    assert obs.KERNEL_TIER.labels(tier=tier).value == 1.0
    assert all(obs.KERNEL_TIER.labels(tier=t).value == 0.0
               for t in C.TIERS if t != tier)


def test_run_fns_never_write_their_input():
    b = torch.from_numpy(_board((48, 40), 5))
    keep = b.clone()
    for tier in ("conv", "fft"):
        out = C.ltl_run_fn(tier)(b, 3, tltl.BOSCO)
        assert out.data_ptr() != b.data_ptr()
        assert torch.equal(b, keep)
    assert C.ltl_run_fn("conv")(b, 0, tltl.BOSCO) is b
    assert C.ltl_run_fn("conv") is C.ltl_run_fn("conv")


# ------------------------------------------------------------------ K7


def _k7_rule(r, middle):
    """The JAX bench's radius-scaled Bosco fractions (`bench._conv_rule`)
    with M0 or M1."""
    area = (2 * r + 1) ** 2
    return (f"R{r},C0,M{int(middle)},S{round(0.273 * area)}.."
            f"{round(0.471 * area)},B{round(0.281 * area)}.."
            f"{round(0.372 * area)},NM")


@pytest.mark.parametrize("shape,r,middle", [
    ((64, 64), 1, False), ((64, 64), 5, True), ((63, 49), 2, False),
    ((50, 70), 8, True), ((40, 300), 16, False), ((96, 80), 32, True),
])
def test_k7_plain_matches_jax_ltl_step(shape, r, middle):
    rule = _k7_rule(r, middle)
    b = _board(shape, 6)
    got = cs.ltl_box_run_turns_plain(torch.from_numpy(b), 1,
                                     tltl.LargerThanLifeRule(rule))
    want = np.asarray(JC._ltl_step(jnp.asarray(b),
                                   jltl.LargerThanLifeRule(rule), "conv"))
    np.testing.assert_array_equal(got.numpy(), want)
    if 2 * r + 1 <= min(shape):
        np.testing.assert_array_equal(
            want, jltl.step_np(b, jltl.LargerThanLifeRule(rule)))


@pytest.mark.parametrize("rulestring", ["R10,C0,M0,S150..190,B160..180,NM",
                                        "R10,C0,M1,S150..190,B120..160,NM"])
def test_k7_plain_board_narrower_than_box(rulestring):
    """16² at r = 10: the 21-wide box wraps the torus more than once, and
    the rolls count each of its 441 offsets; so does K7's plain version,
    turn after turn."""
    b = _board((16, 16), 7, 0.4)
    got = torch.from_numpy(b)
    want = jnp.asarray(b)
    alive = []
    for _ in range(3):
        got = cs.ltl_box_run_turns_plain(
            got, 1, tltl.LargerThanLifeRule(rulestring))
        want = JC._ltl_step(want, jltl.LargerThanLifeRule(rulestring),
                            "conv")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        alive.append(int(got.sum()))
    rule = tltl.LargerThanLifeRule(rulestring)
    counts = C._ltl_counts(torch.from_numpy(b).float(), rule, "conv")
    # Each of the 441 offsets once, with the rolls' multiplicity.
    kern = C.neighborhood_kernel(10, "M", rule.middle)
    np.testing.assert_array_equal(
        counts.numpy(), np.rint(C.counts_np(b, kern)).astype(np.int32))
    assert kern.sum() + 1 > b.size
    assert 0 < alive[0] < b.size


@pytest.mark.timeout(300)
def test_k7_plain_counts_above_16_bits():
    """r = 128 on a 300² board nearly full: counts of the 257² box run
    past 65,535, and the survive range splits them."""
    rng = np.random.default_rng(8)
    b = np.ones((300, 300), np.uint8)
    b[rng.integers(0, 300, 40), rng.integers(0, 300, 40)] = 0
    rulestring = "R128,C0,M1,S66022..66049,B65900..66048,NM"
    counts = C.box_counts_np(b, 128, True)
    assert counts.min() > 65535
    got = cs.ltl_box_run_turns_plain(torch.from_numpy(b), 1,
                                     tltl.LargerThanLifeRule(rulestring))
    want = np.asarray(JC._ltl_step(
        jnp.asarray(b), jltl.LargerThanLifeRule(rulestring), "conv"))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, jltl.step_np(b, jltl.LargerThanLifeRule(rulestring)))
    assert 0 < int(got.sum()) < 300 * 300


def test_conway_ltl_equals_packed_conway():
    b = _board((64, 96), 9)
    got = cs.ltl_box_run_turns_plain(torch.from_numpy(b), 6,
                                     tltl.CONWAY_LTL)
    via_engine_run = C.ltl_run_fn("conv")(torch.from_numpy(b), 6,
                                          tltl.CONWAY_LTL)
    packed = bitpack.packed_run_turns(
        bitpack.words_from_numpy(bitpack.pack_np(b), torch.device("cpu")), 6)
    np.testing.assert_array_equal(
        got.numpy(), bitpack.unpack_np(bitpack.words_to_numpy(packed)))
    np.testing.assert_array_equal(
        got.numpy(), stencil.run_turns(torch.from_numpy(b), 6).numpy())
    assert torch.equal(got, via_engine_run)


def test_k7_wrapper_on_cpu_runs_the_plain_version():
    b = torch.from_numpy(_board((40, 48), 10))
    before = cs.ltl_box_run_turns.launches
    got = cs.ltl_box_run_turns(b, 3, tltl.BOSCO)
    assert torch.equal(got, cs.ltl_box_run_turns_plain(b, 3, tltl.BOSCO))
    assert cs.ltl_box_run_turns.launches == before  # no kernel launched
    assert cs.ltl_box_run_turns(b, 0, tltl.BOSCO) is b
    assert cs.ltl_box_run_turns in cs.KERNELS
    with pytest.raises(ValueError, match="Moore-box"):
        cs.ltl_box_run_turns(b, 1, tltl.LargerThanLifeRule(NN_RULE))


def test_k7_luts_are_the_rule_tables_as_bits():
    """The kernels' rule table is the rule's `luts()` by (cell, box
    count), M0's "minus the cell" folded in: bytes up to r = 64, the same
    entries as little-endian bits beyond, nothing set past them."""
    for rule in (tltl.BOSCO, tltl.CONWAY_LTL,
                 tltl.LargerThanLifeRule(_k7_rule(128, False))):
        packed = cs.ltl_table(rule, torch.device("cpu")).numpy()
        assert packed.dtype == np.uint8
        assert packed.size == cs.ltl_table_bytes(rule.radius)
        if rule.radius <= cs.LTL_BYTE_TABLE_MAX_RADIUS:
            entries = packed
        else:
            entries = np.unpackbits(packed, bitorder="little")
        stride = cs.ltl_stride(rule.radius)
        survive, born = rule.luts()
        skip = 0 if rule.middle else 1
        np.testing.assert_array_equal(entries[:len(born)], born)
        np.testing.assert_array_equal(
            entries[stride + skip:stride + skip + len(survive)], survive)
        assert not entries[2 * stride:].any()


def test_k7_tile_policy_fits_shared_memory():
    for r in (1, 2, 5, 8, 16, 32, 64, 128):
        for h, w in ((16, 16), (300, 300), (512, 512), (1000, 777),
                     (4096, 4096)):
            t = cs.ltl_tile(h, w, r)
            assert t in cs.LTL_TILE_CHOICES
            assert cs.ltl_tile_smem_bytes(t, r) <= cs.SMEM_BYTES
    # Route 2's measured policy at 4096²: 64 below r = 16, 128 from it.
    assert cs.ltl_tile(4096, 4096, 5) == 64
    assert cs.ltl_tile(4096, 4096, 32) == 128
    assert cs.ltl_tile(4096, 4096, 128) == 64  # 128 does not fit
    assert cs.ltl_tile(512, 512, 5) == 32  # 16 tiles of 128 leave SMs idle
    assert cs.ltl_tile(1024, 1024, 32) == 64  # 64 tiles of 128 idle SMs
    # A tile-32 block at r = 128 takes one SM alone: the widest tile wins.
    assert cs.ltl_tile(512, 512, 128) == 64
    # 512² is route 1's; route 2 takes 4096².
    assert cs.ltl_resident_ctas(512, 512, 128) == 16
    assert cs.ltl_resident_ctas(4096, 4096, 5) == 0


# ------------------------------------------------------- tier policy


def test_select_tier_binary_defaults(monkeypatch):
    monkeypatch.delenv(C.TIER_ENV, raising=False)
    monkeypatch.delenv(C.CROSSOVER_ENV, raising=False)
    monkeypatch.delenv("GOL_FUSE_K", raising=False)
    assert C.select_tier(4096, 4096, 1, "uint8") == "bitplane"
    monkeypatch.setenv("GOL_FUSE_K", "8")
    assert C.select_tier(4096, 4096, 1, "uint8") == "fused"
    monkeypatch.delenv("GOL_FUSE_K")
    x = C._crossover_radius(4096 * 4096)
    assert C.select_tier(4096, 4096, x - 1, "uint8") == "conv"
    assert C.select_tier(4096, 4096, x, "uint8") == "fft"
    for area, r in C.CROSSOVER_FFT_RADIUS:
        assert C._crossover_radius(min(area, 1 << 40)) == r


@pytest.mark.parametrize("kind", ["N", "C"])
def test_select_tier_general_kinds_leave_conv2d(monkeypatch, kind):
    """The direct tier of a diamond or a disc is F.conv2d, not K7: its own
    crossover table sends r = 8 at 4096² to the FFT, where the box's keeps
    K7."""
    monkeypatch.delenv(C.TIER_ENV, raising=False)
    monkeypatch.delenv(C.CROSSOVER_ENV, raising=False)
    assert C.select_tier(4096, 4096, 8, "uint8", kind=kind) == "fft"
    assert C.select_tier(4096, 4096, 8, "uint8", kind="M") == "conv"
    x = C._crossover_radius(4096 * 4096, kind)
    assert C.select_tier(4096, 4096, x - 1, "uint8", kind=kind) == "conv"
    for area, r in C.CROSSOVER_FFT_RADIUS_GENERAL:
        assert C._crossover_radius(min(area, 1 << 40), kind) == r
    rule = tltl.LargerThanLifeRule(f"R8,C0,M1,S40..80,B45..60,N{kind}")
    assert C.select_tier(4096, 4096, rule.radius, "uint8",
                         allowed=("conv", "fft"), kind=rule.kind) == "fft"


def test_select_tier_matches_jax_policy_shape(monkeypatch):
    """Everything but the crossover table is the JAX package's policy."""
    monkeypatch.delenv(C.TIER_ENV, raising=False)
    monkeypatch.setenv(C.CROSSOVER_ENV, "9")
    for h, w, r, dt, allowed in ((64, 64, 1, "uint8", C.TIERS),
                                 (4096, 4096, 8, "uint8", C.TIERS),
                                 (4096, 4096, 9, "uint8", C.TIERS),
                                 (512, 512, 4, "float32", C.TIERS),
                                 (512, 512, 4, "float32", ("conv",)),
                                 (512, 512, 20, "uint8", ("conv",)),
                                 (512, 512, 2, "uint8", ("fft",))):
        assert C.select_tier(h, w, r, dt, allowed) == \
            JC.select_tier(h, w, r, dt, allowed)


def test_select_tier_float_boards_never_bitplane(monkeypatch):
    monkeypatch.delenv(C.TIER_ENV, raising=False)
    monkeypatch.delenv(C.CROSSOVER_ENV, raising=False)
    for r in (2, 4, 13, 64):
        assert C.select_tier(1024, 1024, r, "float32") == "fft"
    assert C.select_tier(
        1024, 1024, 4, "float32", allowed=("conv",)) == "conv"


def test_select_tier_forced_and_fallback(monkeypatch):
    monkeypatch.setenv(C.TIER_ENV, "fft")
    assert C.select_tier(64, 64, 1, "uint8") == "fft"
    monkeypatch.setenv(C.TIER_ENV, "bitplane")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = C.select_tier(1024, 1024, 13, "float32",
                            allowed=("conv", "fft"))
    assert got == "fft"
    assert any("GOL_KERNEL_TIER" in str(w.message) for w in caught)
    monkeypatch.setenv(C.TIER_ENV, "warp")
    with pytest.raises(ValueError):
        C.select_tier(64, 64, 1, "uint8")
    with pytest.raises(ValueError):
        C.select_tier(64, 64, 3, "uint8", allowed=())


def test_select_tier_crossover_override(monkeypatch):
    monkeypatch.delenv(C.TIER_ENV, raising=False)
    monkeypatch.setenv(C.CROSSOVER_ENV, "3")
    assert C.select_tier(4096, 4096, 3, "uint8") == "fft"
    assert C.select_tier(4096, 4096, 2, "uint8") == "conv"
    monkeypatch.setenv(C.CROSSOVER_ENV, "not-a-number")
    assert C._crossover_radius(4096 * 4096) == \
        C.CROSSOVER_FFT_RADIUS[-1][1]


def test_spectrum_cached_per_shape_and_device():
    key = ("ltl", 3, "M", True)
    C._fft_spectrum.cache_clear()
    s1 = C._fft_spectrum(60, 44, key, torch.device("cpu"))
    assert s1 is C._fft_spectrum(60, 44, key, torch.device("cpu"))
    assert s1.dtype == torch.complex64
    info = C._fft_spectrum.cache_info()
    C._fft_spectrum(52, 44, key, torch.device("cpu"))
    assert C._fft_spectrum.cache_info().misses == info.misses + 1
