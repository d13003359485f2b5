"""The Generations family of the torch port against the JAX package:
rulestrings, the gray codec and PGM levels, the uint8 gen8 path, the
packed scans, the plain versions of the two-plane Hopper kernels K4/K5
(against the Pallas kernels in interpret mode and the scans), the
dispatch by shape, and `GenerationsTorus`. Integer boards: every
comparison is bit-exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gol_tpu.io import pgm as jpgm
from gol_tpu.models import generations as jg
from gol_tpu.ops import bitpack as jbp
from gol_tpu.ops.pallas_stencil import (
    interpret_supported,
    pallas_packed_run_turns3,
    pallas_packed_run_turns4,
)
from gol_tpu.ops.reference import run_turns_np

from gol_tpu_torch.io import pgm as tpgm
from gol_tpu_torch.models import generations as tg
from gol_tpu_torch.ops import bitpack as tbp
from gol_tpu_torch.ops import cuda_stencil as cs
from gol_tpu_torch.parallel.halo import (
    planes_run_by_kind,
    planes_run_kind,
    select_generations_representation,
)

torch.set_num_threads(2)


@pytest.fixture
def pallas():
    ok, why = interpret_supported()
    if not ok:
        pytest.skip(why)


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


def tplanes(b, states):
    return tbp.words_from_numpy(jplanes(b, states))


FAMILY = {3: "gen3", 4: "gen4"}

# ------------------------------------------------------------ rulestrings

RULESTRINGS = ["/2/3", "345/2/4", "543/2/4", "/22/3", "125/36/3",
               "23/36/8", "23/3/2", "/2/256", "/2/1", "/2/257", "2/3",
               "B3/S23", "9/2/3", "/2/x", ""]


@pytest.mark.parametrize("s", RULESTRINGS)
def test_rulestrings_canonicalised_alike(s):
    try:
        want = jg.GenerationsRule(s)
    except ValueError:
        with pytest.raises(ValueError):
            tg.GenerationsRule(s)
        return
    got = tg.GenerationsRule(s)
    assert got.rulestring == want.rulestring
    assert (got.born, got.survive, got.states) == \
        (want.born, want.survive, want.states)
    born, survive = got.masks()
    assert {i for i in range(9) if born >> i & 1} == set(want.born)
    assert {i for i in range(9) if survive >> i & 1} == set(want.survive)


def test_named_rules():
    assert tg.BRIANS_BRAIN.rulestring == jg.BRIANS_BRAIN.rulestring
    assert tg.STAR_WARS.rulestring == jg.STAR_WARS.rulestring
    assert tg.GenerationsRule() == tg.BRIANS_BRAIN


# ------------------------------------------------------------- gray codec

CODEC_RULES = ["/2/3", "345/2/4", "23/36/8", "23/3/2", "/2/256"]


@pytest.mark.parametrize("s", CODEC_RULES)
def test_gray_codec_matches_jax(s):
    tr, jr = rules(s)
    levels = tg.gray_levels(tr)
    assert levels.dtype == np.uint8
    np.testing.assert_array_equal(levels, jg.gray_levels(jr))
    st = state(24, 40, tr.states, seed=tr.states)
    px = tg.to_pixels_gen(st, tr)
    np.testing.assert_array_equal(px, jg.to_pixels_gen(st, jr))
    np.testing.assert_array_equal(tg.from_pixels_gen(px, tr),
                                  jg.from_pixels_gen(px, jr))
    np.testing.assert_array_equal(tg.from_pixels_gen(px, tr), st)


@pytest.mark.parametrize("s", ["/2/3", "345/2/4", "23/36/8"])
def test_gray_codec_rejects_alike(s):
    tr, jr = rules(s)
    px = np.array([[0, 255, 7]], dtype=np.uint8)
    with pytest.raises(ValueError, match="encode no state"):
        jg.from_pixels_gen(px, jr)
    with pytest.raises(ValueError, match="encode no state"):
        tg.from_pixels_gen(px, tr)


@pytest.mark.parametrize("s", ["/2/3", "345/2/4", "23/36/8"])
def test_pgm_levels_bytes_identical(s, tmp_path):
    tr, jr = rules(s)
    px = tg.to_pixels_gen(state(16, 24, tr.states, seed=3), tr)
    levels = tuple(tg.gray_levels(tr).tolist())
    tpgm.write_pgm(str(tmp_path / "t.pgm"), px, levels=levels)
    jpgm.write_pgm(str(tmp_path / "j.pgm"), px, levels=levels)
    assert (tmp_path / "t.pgm").read_bytes() == \
        (tmp_path / "j.pgm").read_bytes()
    np.testing.assert_array_equal(
        tpgm.read_pgm(str(tmp_path / "j.pgm"), levels=levels), px)
    if tr.states > 2:
        with pytest.raises(ValueError):
            tpgm.write_pgm(str(tmp_path / "x.pgm"), px)
        with pytest.raises(ValueError):
            tpgm.read_pgm(str(tmp_path / "j.pgm"))


def _gray_payload(values, n=32, seed=0):
    rng = np.random.default_rng(seed)
    return np.asarray(values, dtype=np.uint8)[
        rng.integers(0, len(values), n)].tobytes()


BB_LEVELS = (0, 255, 128)
LEVEL_FILES = {
    "brian_gray": (b"P5\n8 4\n255\n" + _gray_payload(BB_LEVELS), BB_LEVELS),
    "life_file_bb_levels": (
        b"P5\n8 4\n255\n" + _gray_payload((0, 255)), BB_LEVELS),
    "foreign_gray": (
        b"P5\n8 4\n255\n\x07" + _gray_payload(BB_LEVELS)[1:], BB_LEVELS),
    "gray_without_levels": (
        b"P5\n8 4\n255\n" + _gray_payload(BB_LEVELS, seed=1), None),
    "short_gray": (
        b"P5\n8 4\n255\n" + _gray_payload(BB_LEVELS)[:-1], BB_LEVELS),
    "star_wars_gray": (
        b"P5\n8 4\n255\n" + _gray_payload((0, 255, 170, 85)),
        (0, 255, 170, 85)),
}


@pytest.mark.parametrize("name", sorted(LEVEL_FILES))
def test_read_pgm_levels_accepts_and_rejects_alike(name, tmp_path):
    data, levels = LEVEL_FILES[name]
    path = str(tmp_path / f"{name}.pgm")
    with open(path, "wb") as f:
        f.write(data)
    try:
        want = jpgm.read_pgm(path, levels=levels)
    except ValueError:
        with pytest.raises(ValueError):
            tpgm.read_pgm(path, levels=levels)
        return
    np.testing.assert_array_equal(tpgm.read_pgm(path, levels=levels), want)


# -------------------------------------------------------------- gen8 path

GEN8_RULES = ["/2/3", "345/2/4", "23/36/8", "125/36/3", "23/3/2"]


@pytest.mark.parametrize("turns", [1, 9])
@pytest.mark.parametrize("s", GEN8_RULES)
def test_gen8_run_turns_matches_jax(s, turns):
    tr, jr = rules(s)
    b = state(24, 40, tr.states, seed=len(s) + turns)
    want = np.asarray(jg.run_turns(jnp.asarray(b), turns, jr))
    got = tg.run_turns(torch.from_numpy(b), turns, tr)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert tg.state_alive_count(got) == jg.state_alive_count(
        jnp.asarray(want))


def test_gen8_256_states_do_not_wrap():
    """c == 256: a cell in the last dying state (255) dies next turn, and
    no dying cell wraps to 0 early."""
    tr, jr = rules("/2/256")
    b = np.array([[0, 1, 2, 254, 255, 200, 0, 1]] * 8, dtype=np.uint8)
    want = np.asarray(jg.run_turns(jnp.asarray(b), 3, jr))
    got = tg.run_turns(torch.from_numpy(b), 3, tr).numpy()
    np.testing.assert_array_equal(got, want)
    one = tg.run_turns(torch.from_numpy(b), 1, tr).numpy()
    assert one[0, 2:6].tolist() == [3, 255, 0, 201]


def test_apply_generations_rule_matches_jax():
    tr, jr = rules("345/2/4")
    rng = np.random.default_rng(4)
    st = rng.integers(0, 4, size=(9, 50)).astype(np.uint8)
    n = rng.integers(0, 9, size=(9, 50)).astype(np.uint8)
    want = np.asarray(jg.apply_generations_rule(
        jnp.asarray(st), jnp.asarray(n), jr))
    got = tg.apply_generations_rule(torch.from_numpy(st),
                                    torch.from_numpy(n), tr)
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------- packed bit algebra


def test_transitions_match_jax():
    rng = np.random.default_rng(8)
    w = rng.integers(0, 2**32, size=(4, 3, 5), dtype=np.uint64).astype(
        np.uint32)
    tw = [tbp.words_from_numpy(x) for x in w]
    for tfn, jfn in ((tbp.gen3_transition, jbp.gen3_transition),
                     (tbp.gen4_transition, jbp.gen4_transition)):
        got = tfn(*tw)
        want = jfn(*(jnp.asarray(x) for x in w))
        for g, j in zip(got, want):
            np.testing.assert_array_equal(tbp.words_to_numpy(g),
                                          np.asarray(j))


@pytest.mark.parametrize("s", ["/2/3", "125/36/3", "345/2/4", "/234/4"])
def test_packed_scans_match_jax(s):
    tr, jr = rules(s)
    b = state(32, 96, tr.states, seed=5)
    p = jplanes(b, tr.states)
    t0, t1 = tbp.words_from_numpy(p[0]), tbp.words_from_numpy(p[1])
    if tr.states == 3:
        want = jg._packed_run_turns3_scan(jnp.asarray(p[0]),
                                          jnp.asarray(p[1]), 11, jr)
        got = tg._packed_run_turns3_scan(t0, t1, 11, tr)
    else:
        want = jg._packed_run_turns4_scan(jnp.asarray(p[0]),
                                          jnp.asarray(p[1]), 11, jr)
        got = tg._packed_run_turns4_scan(t0, t1, 11, tr)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(tbp.words_to_numpy(g), np.asarray(j))


def test_pack_state4_round_trip_matches_jax():
    b = state(8, 64, 4, seed=2)
    b0, b1 = tg.pack_state4(b)
    j0, j1 = jg.pack_state4(b)
    np.testing.assert_array_equal(tbp.words_to_numpy(b0), np.asarray(j0))
    np.testing.assert_array_equal(tbp.words_to_numpy(b1), np.asarray(j1))
    np.testing.assert_array_equal(tg.unpack_state4(b0, b1), b)
    a3 = tg.pack_state3(state(8, 64, 3, seed=2))
    assert a3.shape == (2, 8, 2) and a3.dtype == torch.int32


# ------------------------------------------------------------ K4 (plain)


@pytest.mark.parametrize("turns", [1, 8, 19])
@pytest.mark.parametrize("s", ["/2/3", "125/36/3", "345/2/4", "/234/4"])
def test_resident2p_plain_matches_pallas(s, turns, pallas):
    """K4's plain version against `pallas_packed_run_turns3/4` in
    interpret mode, on the shapes of the JAX package's own tests."""
    tr, jr = rules(s)
    b = state(40, 64, tr.states, seed=turns * 7 + tr.states)
    kernel = (pallas_packed_run_turns3 if tr.states == 3
              else pallas_packed_run_turns4)
    want = np.asarray(kernel(jnp.asarray(jplanes(b, tr.states)), turns, jr,
                             interpret=True))
    got = cs.resident_run_turns2p(tplanes(b, tr.states), turns, tr,
                                  FAMILY[tr.states])
    np.testing.assert_array_equal(tbp.words_to_numpy(got), want)


@pytest.mark.parametrize("s", ["/2/3", "125/36/3", "345/2/4", "/234/4"])
def test_resident2p_plain_one_word_board(s):
    """Wp = 1 (a word's west and east neighbours are itself) against the
    scan and the uint8 path."""
    tr, jr = rules(s)
    b = state(33, 32, tr.states, seed=9)
    got = cs.resident_run_turns2p(tplanes(b, tr.states), 13, tr,
                                  FAMILY[tr.states])
    p = jplanes(b, tr.states)
    scan = (jg._packed_run_turns3_scan if tr.states == 3
            else jg._packed_run_turns4_scan)
    want = scan(jnp.asarray(p[0]), jnp.asarray(p[1]), 13, jr)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(tbp.words_to_numpy(g), np.asarray(j))
    gen8 = np.asarray(jg.run_turns(jnp.asarray(b), 13, jr))
    if tr.states == 3:
        a, d = (tbp.unpack_np(tbp.words_to_numpy(x)) for x in got)
        np.testing.assert_array_equal(a + 2 * d, gen8)
    else:
        np.testing.assert_array_equal(tg.unpack_state4(got[0], got[1]),
                                      gen8)


def test_resident2p_zero_turns_and_bad_family():
    p = tplanes(state(8, 32, 3, seed=1), 3)
    assert cs.resident_run_turns2p(p, 0, tg.BRIANS_BRAIN, "gen3") is p
    with pytest.raises(ValueError):
        cs.resident_run_turns2p(p, 1, tg.BRIANS_BRAIN, "gen8")


# ------------------------------------------------------------ K5 (plain)


def _scan_planes(b, tr, jr, turns):
    p = jplanes(b, tr.states)
    scan = (jg._packed_run_turns3_scan if tr.states == 3
            else jg._packed_run_turns4_scan)
    return np.stack([np.asarray(x) for x in scan(
        jnp.asarray(p[0]), jnp.asarray(p[1]), turns, jr)])


@pytest.mark.parametrize("s", ["345/2/4", "/2/3"])
@pytest.mark.parametrize("t", [1, 7, 32])
@pytest.mark.parametrize("shape", [(400, 70 * 32), (5, 3 * 32), (1, 32),
                                   (161, 63 * 32)])
def test_tiled_sweep2p_plain_matches_scan(shape, t, s):
    """Boards not aligned to the policy's R x 62-word tiles, boards
    shorter or narrower than one window (modular window indices), and
    Wp = 1."""
    tr, jr = rules(s)
    b = state(*shape, tr.states, seed=shape[0] + t)
    got = cs.tiled_sweep2p_plain(tplanes(b, tr.states), t, tr,
                                 FAMILY[tr.states])
    np.testing.assert_array_equal(tbp.words_to_numpy(got),
                                  _scan_planes(b, tr, jr, t))


@pytest.mark.parametrize("s", ["/2/3", "125/36/3", "345/2/4", "/234/4"])
def test_banded_run_turns2p_36_turns(s):
    """One sweep at 32 and one at 4; the input planes are kept."""
    tr, jr = rules(s)
    b = state(200, 96, tr.states, seed=36)
    p = tplanes(b, tr.states)
    before = p.clone()
    got = cs.banded_run_turns2p(p, 36, tr, FAMILY[tr.states])
    np.testing.assert_array_equal(tbp.words_to_numpy(got),
                                  _scan_planes(b, tr, jr, 36))
    assert torch.equal(p, before)
    assert cs.banded_run_turns2p(p, 0, tr, FAMILY[tr.states]) is p


def test_tiled_sweep2p_output_buffer_and_rejects():
    tr, jr = rules("345/2/4")
    b = state(170, 64, 4, seed=3)
    p = tplanes(b, 4)
    out = torch.zeros_like(p)
    cs.tiled_sweep2p(p, out, 20, tr, "gen4")
    np.testing.assert_array_equal(tbp.words_to_numpy(out),
                                  _scan_planes(b, tr, jr, 20))
    for bad in (0, 33):
        with pytest.raises(ValueError):
            cs.tiled_sweep2p(p, torch.empty_like(p), bad, tr, "gen4")
    with pytest.raises(ValueError):
        cs.tiled_sweep2p(p, p, 4, tr, "gen4")
    with pytest.raises(ValueError):
        cs.tiled_sweep2p(p, torch.empty_like(p), 4, tr, "gen5")


# --------------------------------------------------------------- dispatch


@pytest.mark.parametrize("shape", [(40, 64), (480, 1024)])
@pytest.mark.parametrize("s", ["/2/3", "345/2/4"])
def test_packed_dispatchers_match_jax(s, shape):
    """`packed_run_turns3/4` (K4 at 40 x 64, K5 at 480 x 1024 here as
    plain versions) against the JAX package's dispatchers."""
    tr, jr = rules(s)
    b = state(*shape, tr.states, seed=shape[0])
    p = jplanes(b, tr.states)
    t0, t1 = tbp.words_from_numpy(p[0]), tbp.words_from_numpy(p[1])
    if tr.states == 3:
        got = tg.packed_run_turns3(t0, t1, 9, tr)
        want = jg.packed_run_turns3(jnp.asarray(p[0]), jnp.asarray(p[1]),
                                    9, jr)
    else:
        got = tg.packed_run_turns4(t0, t1, 9, tr)
        want = jg.packed_run_turns4(jnp.asarray(p[0]), jnp.asarray(p[1]),
                                    9, jr)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(tbp.words_to_numpy(g), np.asarray(j))
    assert tg.packed_run_turns3(t0, t1, 0, tr)[0] is t0


@pytest.mark.parametrize("shape,kind", [
    ((2, 512, 16), "resident"), ((2, 64, 2), "resident"),
    ((2, 32, 1), "resident"), ((2, 113, 128), "resident"),
    ((2, 114, 128), "tiled"), ((2, 1024, 32), "tiled"),
    ((2, 4096, 128), "tiled"), ((2, 16384, 512), "tiled"),
])
def test_planes_run_kind(shape, kind):
    assert planes_run_kind(shape) == kind  # shapes only, nothing allocated
    assert planes_run_by_kind(kind) in (cs.resident_run_turns2p,
                                        cs.banded_run_turns2p)


@pytest.mark.parametrize("s,width,repr_", [
    ("/2/3", 64, "gen3"), ("/2/3", 48, "gen8"), ("345/2/4", 64, "gen8"),
    ("23/36/8", 64, "gen8"), ("125/36/3", 4096, "gen3"),
])
def test_select_generations_representation(s, width, repr_):
    assert select_generations_representation(
        width, tg.GenerationsRule(s))[0] == repr_


def test_cpu_wrappers_2p_run_plain_and_count_nothing():
    cs.reset_launch_counts()
    tr = tg.STAR_WARS
    p = tplanes(state(64, 64, 4, seed=3), 4)
    assert torch.equal(cs.resident_run_turns2p(p, 3, tr, "gen4"),
                       cs.resident_run_turns2p_plain(p, 3, tr, "gen4"))
    out = torch.empty_like(p)
    cs.tiled_sweep2p(p, out, 3, tr, "gen4")
    assert torch.equal(out, cs.tiled_sweep2p_plain(p, 3, tr, "gen4"))
    g = tg.GenerationsTorus(state(64, 64, 3, seed=1), device="cpu")
    g.run(5)
    g.alive_count()
    assert [fn.launches for fn in cs.KERNELS] == [0] * len(cs.KERNELS)
    assert all(n == 0 for fn in cs.KERNELS_2P
               for n in fn.by_family.values())


# -------------------------------------------------------- GenerationsTorus


@pytest.mark.parametrize("width", [64, 48])
@pytest.mark.parametrize("s", ["/2/3", "345/2/4", "23/36/8"])
def test_torus_matches_jax(s, width):
    tr, jr = rules(s)
    b = state(40, width, tr.states, seed=width)
    gt = tg.GenerationsTorus(b, tr, device="cpu")
    jt = jg.GenerationsTorus(b, jr)
    assert (gt._packed, gt._packed4) == (jt._packed, jt._packed4)
    for turns in (7, 23):
        gt.run(turns)
        jt.run(turns)
        np.testing.assert_array_equal(gt.board, jt.board)
        assert gt.alive_count() == jt.alive_count()
        assert gt.turn == jt.turn


def test_torus_c2_degenerates_to_conway():
    rng = np.random.default_rng(29)
    b = (rng.random((32, 32)) < 0.4).astype(np.uint8)
    gt = tg.GenerationsTorus(b, tg.GenerationsRule("23/3/2"), device="cpu")
    gt.run(20)
    np.testing.assert_array_equal(gt.board, run_turns_np(b, 20))


def test_torus_large_board_takes_the_tiled_path():
    """A 3-state board above K4's limit runs K5's plain version."""
    tr, jr = rules("/2/3")
    b = state(480, 1024, 3, seed=480)  # 480 x 32 x 4 = 61,440 B a plane
    assert planes_run_kind((2, 480, 32)) == "tiled"
    gt = tg.GenerationsTorus(b, tr, device="cpu")
    gt.run(33)
    want = np.asarray(jg.run_turns(jnp.asarray(b), 33, jr))
    np.testing.assert_array_equal(gt.board, want)
    assert gt.alive_count() == int((want == 1).sum())


def test_torus_validates_and_needs_a_device():
    with pytest.raises(ValueError):
        tg.GenerationsTorus(np.zeros((2, 2, 2), np.uint8), device="cpu")
    with pytest.raises(ValueError):
        tg.GenerationsTorus(np.full((4, 32), 3, np.uint8), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tg.GenerationsTorus(np.zeros((4, 32), np.uint8))
