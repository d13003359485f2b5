"""The alive count that rides a chunk's last stepping launch (`count=` of
the stepping wrappers in `gol_tpu_torch.ops.cuda_stencil` and of the
run functions in `gol_tpu_torch.parallel.halo`), through the plain
versions on the CPU, against the JAX package: the same numpy-seeded
board stepped by its scans and counted by its engine's
`_firing_row_counts` (the chunk token's rule: popcounts of the packed
words, of gen3's alive plane). Tolerance: exact. On the card
`chip_smoke.py` holds each counted launch against these plain counts."""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gol_tpu.engine import _firing_row_counts as jax_firing_row_counts
from gol_tpu.models import generations as jg
from gol_tpu.models.lifelike import LifeLikeRule as JLifeLikeRule
from gol_tpu.ops import bitpack as jbp

from gol_tpu_torch import Params
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.io.pgm import read_pgm
from gol_tpu_torch.models import generations as tg
from gol_tpu_torch.models.lifelike import HIGHLIFE, LifeLikeRule
from gol_tpu_torch.ops import bitpack as tbp
from gol_tpu_torch.ops import cuda_stencil as cs
from gol_tpu_torch.parallel.halo import gen3_run_turns, packed_run_turns

torch.set_num_threads(2)

# (rows, words): 64², a 96 x 3-word board and a 256 x 8-word one.
SHAPES = ((64, 2), (96, 3), (256, 8))
GEN3 = "/2/3"


def _board(h: int, wp: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random((h, wp * 32)) < 0.35).astype(np.uint8)


def _gen3_state(h: int, wp: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 3, size=(h, wp * 32)).astype(np.uint8)


def _jax_packed_count(b: np.ndarray, turns: int) -> int:
    words = jbp.packed_run_turns(jbp.pack(b), turns)
    return int(jax_firing_row_counts(words, "packed").sum())


def _jax_gen3_count(state: np.ndarray, turns: int) -> int:
    rule = jg.GenerationsRule(GEN3)
    p0 = jbp.pack((state == 1).astype(np.uint8))
    p1 = jbp.pack((state == 2).astype(np.uint8))
    a, d = jg._packed_run_turns3_scan(p0, p1, turns, rule)
    return int(jax_firing_row_counts(jnp.stack([a, d]), "gen3").sum())


def _gen3_planes(state: np.ndarray) -> torch.Tensor:
    return tbp.words_from_numpy(np.stack([
        np.asarray(jbp.pack((state == 1).astype(np.uint8))),
        np.asarray(jbp.pack((state == 2).astype(np.uint8)))]))


def _count() -> torch.Tensor:
    return torch.full((1,), -1, dtype=torch.int64)


@pytest.mark.parametrize("turns", (1, 13))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}w")
def test_resident_count(shape, turns):
    """K1 at the policy's N and at N = 16 (slabs of 4-16 rows)."""
    b = _board(*shape, seed=shape[0] + turns)
    want = _jax_packed_count(b, turns)
    for ctas in (None, 16):
        count = _count()
        out = cs.resident_run_turns(tbp.words_from_numpy(tbp.pack_np(b)),
                                    turns, ctas=ctas, count=count)
        assert count.item() == want
        assert count.item() == int(tbp.row_popcounts_plain(out).sum())


@pytest.mark.parametrize("box", (None, (5, 250, 1, 7), (0, 37, 0, 8)))
@pytest.mark.parametrize("turns", (1, 8, 13))
def test_resident_count_rounds(turns, box):
    """K1's rounds at G = 8 on 256 x 8 words (16 slabs of 16 rows): one
    round, one exactly, and one and five turns; the whole board and two
    boxes (rows across slab edges and part of the words)."""
    b = _board(256, 8, seed=256 + turns)
    count = _count()
    out = cs.resident_run_turns(tbp.words_from_numpy(tbp.pack_np(b)), turns,
                                ctas=16, halo=8, count=count, box=box)
    want = np.asarray(jbp.packed_run_turns(jbp.pack(b), turns))
    r0, r1, c0, c1 = box or (0, 256, 0, 8)
    assert np.array_equal(tbp.words_to_numpy(out), want)
    assert count.item() == int(np.unpackbits(
        want[r0:r1, c0:c1].view(np.uint8)).sum())


@pytest.mark.parametrize("turns", (13, 40))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}w")
def test_banded_count(shape, turns):
    """K2's sweeps: one at 13 turns, 32 + 8 at 40 (the last counts)."""
    b = _board(*shape, seed=7 * shape[0] + turns)
    count = _count()
    cs.banded_run_turns(tbp.words_from_numpy(tbp.pack_np(b)), turns,
                        count=count)
    assert count.item() == _jax_packed_count(b, turns)


@pytest.mark.parametrize("turns", (48, 100))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}w")
def test_fused_count_at_k48(shape, turns):
    """B3 at k = 48: a K6 sweep counts at 48 turns, and at 100 (48 + 48
    + 4) the last sweep, on K2, counts."""
    b = _board(*shape, seed=11 * shape[0] + turns)
    count = _count()
    cs.fused_banded_run_turns(tbp.words_from_numpy(tbp.pack_np(b)), turns,
                              48, count=count)
    assert count.item() == _jax_packed_count(b, turns)


@pytest.mark.parametrize("turns", (1, 13, 40))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}w")
def test_gen3_counts(shape, turns):
    """K4 and K5 (`banded_run_turns2p`) count gen3's alive plane."""
    state = _gen3_state(*shape, seed=3 * shape[0] + turns)
    want = _jax_gen3_count(state, turns)
    rule = tg.GenerationsRule(GEN3)
    for run in (cs.resident_run_turns2p, cs.banded_run_turns2p):
        count = _count()
        run(_gen3_planes(state), turns, rule, "gen3", count=count)
        assert count.item() == want, run.__name__


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}w")
def test_single_sweeps_count(shape):
    """One K2, K6 and K5 sweep each, a rule other than Conway's for K2."""
    b = _board(*shape, seed=shape[1])
    w = tbp.words_from_numpy(tbp.pack_np(b))
    out = torch.empty_like(w)
    count = _count()
    cs.tiled_sweep(w, out, 9, HIGHLIFE, count=count)
    want = jbp.packed_run_turns(jbp.pack(b), 9, JLifeLikeRule("B36/S23"))
    assert count.item() == int(jax_firing_row_counts(want, "packed").sum())
    cs.tiled_sweep_deep(w, out, 50, count=count)
    assert count.item() == _jax_packed_count(b, 50)
    state = _gen3_state(*shape, seed=shape[1] + 1)
    planes = _gen3_planes(state)
    cs.tiled_sweep2p(planes, torch.empty_like(planes), 7,
                     tg.GenerationsRule(GEN3), "gen3", count=count)
    assert count.item() == _jax_gen3_count(state, 7)


@pytest.mark.parametrize("turns", (5, 64))
def test_run_functions_pass_the_count(turns):
    """The engine's run functions (`packed_run_turns`, `gen3_run_turns`)
    hand `count=` to the launch their shape selects: K1 at 64², K2 at a
    board K1 does not hold."""
    for h, wp in ((64, 2), (1024, 32)):
        b = _board(h, wp, seed=h + turns)
        count = _count()
        packed_run_turns(tbp.words_from_numpy(tbp.pack_np(b)), turns,
                         cs.CONWAY, count=count)
        assert count.item() == _jax_packed_count(b, turns)
    state = _gen3_state(64, 2, seed=turns)
    count = _count()
    gen3_run_turns(_gen3_planes(state), turns, tg.GenerationsRule(GEN3),
                   count=count)
    assert count.item() == _jax_gen3_count(state, turns)


def test_a_full_board_counts_every_cell():
    """All ones under B3/S012345678 stay all ones: the count is h x w
    (2^14 here; the card's check takes 65536², 2^32, past int32)."""
    w = torch.full((128, 4), -1, dtype=torch.int32)
    rule = LifeLikeRule("B3/S012345678")
    for run in (cs.resident_run_turns, cs.banded_run_turns):
        count = _count()
        out = run(w, 3, rule, count=count)
        assert torch.equal(out, w)
        assert count.item() == 128 * 128


def test_counts_refused():
    """count= wants one int64 on the board's device and at least one
    turn; gen4's plane 0 is not its alive plane."""
    w = tbp.words_from_numpy(tbp.pack_np(_board(64, 2, seed=1)))
    with pytest.raises(ValueError, match="int64"):
        cs.resident_run_turns(w, 3, count=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="int64"):
        cs.banded_run_turns(w, 3, count=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="rides a launch"):
        cs.resident_run_turns(w, 0, count=_count())
    with pytest.raises(ValueError, match="rides a launch"):
        cs.banded_run_turns(w, 0, count=_count())
    planes = torch.zeros((2, 64, 2), dtype=torch.int32)
    rule = tg.GenerationsRule("345/2/4")
    with pytest.raises(ValueError, match="gen4"):
        cs.resident_run_turns2p(planes, 3, rule, "gen4", count=_count())
    with pytest.raises(ValueError, match="gen4"):
        cs.banded_run_turns2p(planes, 3, rule, "gen4", count=_count())


class _Recording(Engine):
    """An engine that keeps every (alive, turn) pair it publishes."""

    @property
    def _alive_pub(self):
        return self.__dict__.get("_pub")

    @_alive_pub.setter
    def _alive_pub(self, pair):
        self.__dict__.setdefault("pairs", [])
        if pair is not None:
            self.pairs.append(pair)
        self.__dict__["_pub"] = pair


def test_engine_published_pairs_equal_the_csv(monkeypatch, check_dir):
    """Engine(device="cpu") at 64² x 100, chunks capped at 8 turns so it
    publishes many pairs: each (alive, turn) equals check/alive's row."""
    monkeypatch.setenv("GOL_MAX_CHUNK", "8")
    with open(check_dir / "alive" / "64x64.csv") as f:
        golden = {int(r["completed_turns"]): int(r["alive_cells"])
                  for r in csv.DictReader(f)}
    world = read_pgm(str(check_dir.parent / "images" / "64x64.pgm"))
    eng = _Recording(device="cpu")
    board, turn = eng.server_distributor(
        Params(threads=1, image_width=64, image_height=64, turns=100), world)
    assert turn == 100
    assert len(eng.pairs) > 12
    assert eng.pairs[-1][1] == 100
    for alive, t in eng.pairs:
        assert alive == golden[t], t
    assert eng.alive_count() == (golden[100], 100)


def test_engine_gen3_pairs_count_the_alive_plane(monkeypatch):
    """Brian's Brain (`/2/3`, gen3) at 64² x 20: each published count is
    the JAX reference's count of state-1 cells at its turn."""
    monkeypatch.setenv("GOL_MAX_CHUNK", "4")
    rule = tg.GenerationsRule(GEN3)
    state = _gen3_state(64, 2, seed=5)
    eng = _Recording(device="cpu", rule=rule)
    eng.server_distributor(
        Params(threads=1, image_width=64, image_height=64, turns=20),
        tg.to_pixels_gen(state, rule))
    assert len(eng.pairs) > 5
    for alive, t in eng.pairs:
        assert alive == (_jax_gen3_count(state, t) if t else
                         int((state == 1).sum())), t
