"""K7's two routes (`gol_tpu_torch/ops/cuda_stencil.py`) on the CPU,
against the JAX package (`gol_tpu/ops/conv.py:_ltl_step`) on the same
seeded numpy inputs: route 1's plain version (the cluster's slabs, each
row's vertical sums read from its owner's slab, modulo h) at every shape
the gate admits at the slab counts it picks and at N = 1 and 16, for
r = 1, 5, 32 and 128 with M0 and M1, slabs thinner than r, boxes wider
and taller than the torus, and counts past 65,535; the gate and the tile
policy from the shape alone; the rule table; and the wrappers' CPU
dispatch (no launch, no fallback). Tolerance: 0 (integer boards)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gol_tpu.models import largerthanlife as jltl
from gol_tpu.ops import conv as JC

from gol_tpu_torch.models import largerthanlife as tltl
from gol_tpu_torch.ops import conv as C, cuda_stencil as cs

torch.set_num_threads(2)


def _board(shape, seed, p=0.4):
    return (np.random.default_rng(seed).random(shape) < p).astype(np.uint8)


def _rule(r, middle):
    """The JAX bench's radius-scaled Bosco fractions with M0 or M1."""
    area = (2 * r + 1) ** 2
    return (f"R{r},C0,M{int(middle)},S{round(0.273 * area)}.."
            f"{round(0.471 * area)},B{round(0.281 * area)}.."
            f"{round(0.372 * area)},NM")


def _jax_turns(b, turns, rulestring):
    rule = jltl.LargerThanLifeRule(rulestring)
    out = jnp.asarray(b)
    for _ in range(turns):
        out = JC._ltl_step(out, rule, "conv")
    return np.asarray(out)


# Shapes the gate admits (one CTA up to 64², 16 above), with radii that
# make the slabs thinner than r and the box wider than the torus.
ROUTE1_CASES = [
    ((16, 16), 1), ((16, 16), 5), ((16, 16), 32),
    ((64, 64), 1), ((64, 64), 5), ((64, 64), 32),
    ((96, 80), 1), ((96, 80), 5), ((96, 80), 32),
    ((17, 300), 5), ((40, 130), 32),
]


@pytest.mark.parametrize("middle", [False, True], ids=["M0", "M1"])
@pytest.mark.parametrize("shape,r", ROUTE1_CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else f"r{v}")
def test_route1_plain_matches_jax_ltl_step(shape, r, middle):
    """At the gate's N, at N = 1 and at N = min(16, h): three turns equal
    JAX `_ltl_step`'s and route 2's plain version's."""
    h, w = shape
    rs = _rule(r, middle)
    rule = tltl.LargerThanLifeRule(rs)
    n = cs.ltl_resident_ctas(h, w, r)
    assert n == (1 if h * w <= cs.LTL_RESIDENT_SOLO_CELLS else min(16, h))
    b = _board(shape, h * 7 + w + r)
    want = _jax_turns(b, 3, rs)
    cells = torch.from_numpy(b)
    np.testing.assert_array_equal(
        cs.ltl_box_run_turns_plain(cells, 3, rule).numpy(), want)
    for ctas in sorted({n, 1, min(16, h)}):
        got = cs.ltl_resident_run_turns_plain(cells, 3, rule, ctas)
        assert got.dtype == torch.uint8 and got.shape == shape
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"N={ctas}")


@pytest.mark.parametrize("ctas", [1, 2, 3, 7, 16])
def test_route1_plain_every_slab_count_radius_128(ctas):
    """r = 128 on a 16² torus: the 257-row box wraps it 16 times and each
    of its rows is read from its owner's slab; 1-row slabs at N = 16."""
    rs = _rule(128, True)
    b = _board((16, 16), 11)
    got = cs.ltl_resident_run_turns_plain(
        torch.from_numpy(b), 2, tltl.LargerThanLifeRule(rs), ctas)
    np.testing.assert_array_equal(got.numpy(), _jax_turns(b, 2, rs))


@pytest.mark.timeout(300)
def test_route1_plain_counts_above_16_bits():
    """r = 128 on a nearly full 300² board (16 slabs of 18-19 rows, each
    thinner than r): counts pass 65,535 and the survive range splits
    them."""
    rng = np.random.default_rng(8)
    b = np.ones((300, 300), np.uint8)
    b[rng.integers(0, 300, 40), rng.integers(0, 300, 40)] = 0
    rs = "R128,C0,M1,S66022..66049,B65900..66048,NM"
    rule = tltl.LargerThanLifeRule(rs)
    assert C.box_counts_np(b, 128, True).min() > 65535
    assert cs.ltl_resident_ctas(300, 300, 128) == 16
    got = cs.ltl_resident_run_turns_plain(torch.from_numpy(b), 1, rule)
    want = _jax_turns(b, 1, rs)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(got.sum()) < 300 * 300


def test_route1_plain_slab_indexing():
    """Each board row's owner and row there follow `slab_start`
    (csrc/stencil.cu): owner (g + 1)·N - 1 // h, for uneven slabs."""
    for h, n in ((512, 16), (300, 16), (17, 16), (1000, 7), (16, 16)):
        starts = cs._slab_starts(h, n)
        for g in range(h):
            owner = ((g + 1) * n - 1) // h
            assert starts[owner] <= g < starts[owner + 1]


def test_route1_gate_from_the_shape():
    for r in (1, 5, 32, 64, 127, 128):
        assert cs.ltl_resident_ctas(512, 512, r) == 16
        assert cs.ltl_resident_ctas(64, 64, r) == 1
        assert cs.ltl_resident_ctas(16, 16, r) == 1
        assert cs.ltl_resident_ctas(4096, 4096, r) == 0
        assert cs.ltl_resident_ctas(1000, 777, r) == 16
    for r in (1, 5, 32, 127):
        assert cs.ltl_resident_ctas(1024, 1024, r) == 16
    # Two bytes of vertical sums at r = 128 do not fit 1024² on 16 CTAs.
    assert cs.ltl_resident_ctas(1024, 1024, 128) == 0
    assert cs.ltl_resident_ctas(2048, 2048, 1) == 0
    for h, w, r in ((512, 512, 128), (1024, 1024, 127), (16, 16, 128),
                    (1000, 777, 64)):
        n = cs.ltl_resident_ctas(h, w, r)
        assert cs.ltl_resident_smem_bytes(h, w, r, n) <= cs.SMEM_BYTES
    assert cs.ltl_resident_smem_bytes(1024, 1024, 128, 16) > cs.SMEM_BYTES


def test_route1_smem_layout():
    """The mirror of csrc/stencil.cu:ltl_resident_smem_bytes: table, 16
    bases and lengths, two buffers of cells at an odd word pitch, the
    vertical sums (one byte below r = 128, two at it) and slack."""
    assert cs.ltl_resident_smem_bytes(512, 512, 5, 16) == (
        256 + 192 + 2 * 32 * 516 + 32 * 516 + 16)
    assert cs.ltl_resident_smem_bytes(512, 512, 128, 16) == (
        cs.ltl_table_bytes(128) + 192 + 2 * 32 * 516 + 32 * 1028 + 16)
    assert cs.ltl_sum_bytes(127) == 1 and cs.ltl_sum_bytes(128) == 2


@pytest.mark.parametrize("rulestring", [
    _rule(1, False), _rule(5, True), _rule(64, False), _rule(65, True),
    _rule(128, False), "R3,C0,M0,S1..3+5..9,B2..4+10..12,NM"])
def test_rule_table_is_the_rule(rulestring):
    """t[me][n] is the next state of a cell `me` whose box (itself
    included) counts n, with M0's "minus the cell" folded in; held as
    bytes up to r = 64 and as little-endian bits beyond."""
    rule = tltl.LargerThanLifeRule(rulestring)
    survive, born = rule.luts()
    t = cs.ltl_count_table(rule)
    r = rule.radius
    assert t.shape == (2, (2 * r + 1) ** 2 + 1)
    for n in range(t.shape[1]):
        assert t[0, n] == (born[n] if n < len(born) else 0)
        k = n - (0 if rule.middle else 1)
        assert t[1, n] == (survive[k] if 0 <= k < len(survive) else 0)
    packed = cs.ltl_table(rule, torch.device("cpu")).numpy()
    assert packed.dtype == np.uint8
    assert len(packed) == cs.ltl_table_bytes(r) and len(packed) % 16 == 0
    flat = t.reshape(-1)
    if r <= cs.LTL_BYTE_TABLE_MAX_RADIUS:
        np.testing.assert_array_equal(packed[:flat.size], flat)
    else:
        bits = np.unpackbits(packed, bitorder="little")
        np.testing.assert_array_equal(bits[:flat.size], flat)
        assert not bits[flat.size:].any()


def test_route2_tile_policy_fits_and_is_shape_only():
    for r in (1, 2, 5, 8, 16, 32, 64, 128):
        for h, w in ((16, 16), (300, 300), (1000, 777), (4096, 4096),
                     (2048, 8192)):
            t = cs.ltl_tile(h, w, r)
            assert t in cs.LTL_TILE_CHOICES
            assert cs.ltl_tile_smem_bytes(t, r) <= cs.SMEM_BYTES
            assert t == cs.ltl_tile(h, w, r)


def test_wrappers_on_cpu_run_the_plain_versions():
    b = torch.from_numpy(_board((64, 64), 12))
    rule = tltl.BOSCO
    before = (cs.ltl_resident_run_turns.launches,
              cs.ltl_box_run_turns.launches)
    want = cs.ltl_box_run_turns_plain(b, 4, rule)
    # The gate sends 64² to route 1; a pinned tile keeps route 2.
    assert torch.equal(cs.ltl_box_run_turns(b, 4, rule), want)
    assert torch.equal(cs.ltl_box_run_turns(b, 4, rule, tile=32), want)
    assert torch.equal(cs.ltl_resident_run_turns(b, 4, rule, ctas=16), want)
    assert (cs.ltl_resident_run_turns.launches,
            cs.ltl_box_run_turns.launches) == before
    assert cs.ltl_resident_run_turns(b, 0, rule) is b
    assert cs.ltl_resident_run_turns in cs.KERNELS
    assert cs.ltl_box_run_turns in cs.KERNELS
    with pytest.raises(ValueError, match="Moore-box"):
        cs.ltl_resident_run_turns(
            b, 1, tltl.LargerThanLifeRule("R3,C0,M0,S4..9,B5..7,NN"))
    with pytest.raises(ValueError, match="does not fit a cluster"):
        cs.ltl_resident_run_turns(torch.zeros((4096, 4096), dtype=torch.uint8),
                                  1, rule)
    with pytest.raises(ValueError, match="CTAs"):
        cs.ltl_resident_run_turns(b, 1, rule, ctas=17)


def test_engine_run_fn_goes_through_the_gate():
    """The engine's conv run fn on a Moore-box rule equals JAX
    `_ltl_step` over a chunk, whichever route the gate picks."""
    for shape in ((16, 16), (96, 80)):
        b = _board(shape, 13)
        got = C.ltl_run_fn("conv")(torch.from_numpy(b), 5, tltl.BOSCO)
        np.testing.assert_array_equal(
            got.numpy(), _jax_turns(b, 5, tltl.BOSCO.rulestring))
