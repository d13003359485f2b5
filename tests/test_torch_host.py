"""Host contract layer of the torch port against the JAX package: PGM
bytes and acceptance, event texts, rulestrings."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import gol_tpu.events as jev
from gol_tpu.io import pgm as jpgm
from gol_tpu.models import parse_rule as jparse_rule
from gol_tpu.models.lifelike import LifeLikeRule as JRule

import gol_tpu_torch.events as tev
from gol_tpu_torch.io import pgm as tpgm
from gol_tpu_torch.models import parse_rule as tparse_rule
from gol_tpu_torch.models.lifelike import LifeLikeRule as TRule

torch.set_num_threads(2)

IMAGES = ["16x16", "64x64", "128x128", "256x256", "512x512"]


@pytest.mark.parametrize("name", IMAGES)
def test_pgm_bytes_identical(name, images_dir, tmp_path):
    src = os.path.join(images_dir, f"{name}.pgm")
    board = tpgm.read_pgm(src)
    np.testing.assert_array_equal(board, jpgm.read_pgm(src))
    tpgm.write_pgm(str(tmp_path / "t.pgm"), board)
    jpgm.write_pgm(str(tmp_path / "j.pgm"), board)
    assert (tmp_path / "t.pgm").read_bytes() == \
        (tmp_path / "j.pgm").read_bytes()


def _payload(w, h, seed=0):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((h, w)) < 0.4, 255, 0).astype(
        np.uint8).tobytes()


PGM_FILES = {
    "plain": b"P5\n8 4\n255\n" + _payload(8, 4),
    "comments": b"P5\n# made by hand\n8 # width\n4\n255\n" + _payload(8, 4),
    "one_line_header": b"P5 8 4 255\n" + _payload(8, 4),
    "trailing_bytes": b"P5\n8 4\n255\n" + _payload(8, 4) + b"\n\n",
    "bad_magic": b"P2\n8 4\n255\n" + _payload(8, 4),
    "maxval_1": b"P5\n8 4\n1\n" + bytes(32),
    "short_payload": b"P5\n8 4\n255\n" + _payload(8, 4)[:-1],
    "gray_cell": b"P5\n8 4\n255\n" + b"\x07" + _payload(8, 4)[1:],
    "zero_width": b"P5\n0 4\n255\n",
    "truncated_header": b"P5\n8",
}


@pytest.mark.parametrize("name", sorted(PGM_FILES))
def test_read_pgm_accepts_and_rejects_alike(name, tmp_path):
    path = str(tmp_path / f"{name}.pgm")
    with open(path, "wb") as f:
        f.write(PGM_FILES[name])
    try:
        want = jpgm.read_pgm(path)
    except ValueError:
        with pytest.raises(ValueError):
            tpgm.read_pgm(path)
        return
    np.testing.assert_array_equal(tpgm.read_pgm(path), want)


def test_write_pgm_rejects_cells_and_is_atomic(tmp_path):
    with pytest.raises(ValueError):
        tpgm.write_pgm(str(tmp_path / "x.pgm"),
                       np.ones((4, 4), dtype=np.uint8))
    tpgm.write_pgm(str(tmp_path / "sub" / "x.pgm"),
                   np.full((4, 4), 255, dtype=np.uint8))
    assert os.listdir(tmp_path / "sub") == ["x.pgm"]
    assert tpgm.input_path(5, 7, "d") == jpgm.input_path(5, 7, "d")
    assert tpgm.output_path(5, 7, 9, "o") == jpgm.output_path(5, 7, 9, "o")


EVENT_ARGS = {
    "AliveCellsCount": (12, 345),
    "ImageOutputComplete": (12, "64x64x12.pgm"),
    "StateChange": (12, "PAUSED"),
    "CellFlipped": (12, (3, 4)),
    "CellsFlipped": (12, ((1, 2), (3, 4))),
    "TurnComplete": (12,),
    "FinalTurnComplete": (12, ((1, 2),), 1),
    "EngineLost": (12,),
    "EngineReattached": (12,),
}


@pytest.mark.parametrize("name", sorted(EVENT_ARGS))
def test_event_texts_identical(name):
    def build(mod):
        args = list(EVENT_ARGS[name])
        if name == "StateChange":
            args[1] = getattr(mod.State, args[1])
        return getattr(mod, name)(*args)

    t, j = build(tev), build(jev)
    assert str(t) == str(j)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert t.completed_turns == j.completed_turns


def test_state_texts_and_drain():
    assert [str(s) for s in tev.State] == [str(s) for s in jev.State]
    import queue

    q = queue.Queue()
    q.put(tev.TurnComplete(1))
    q.put(tev.CLOSE)
    assert tev.drain(q) == [tev.TurnComplete(1)]
    assert repr(tev.CLOSE) == repr(jev.CLOSE)


RULESTRINGS = ["B3/S23", "B3/S32", "B33/S2233", "B36/S23", "B3678/S34678",
               "B2/S", "B/S", "B8/S012345678", "b3/s23", "B9/S23",
               "B3/S23/", "", "3/23"]


@pytest.mark.parametrize("s", RULESTRINGS)
def test_rulestrings_canonicalised_alike(s):
    try:
        want = JRule(s)
    except ValueError:
        with pytest.raises(ValueError):
            TRule(s)
        return
    got = TRule(s)
    assert got.rulestring == want.rulestring
    assert got.luts() == want.luts()
    assert got.is_conway == want.is_conway
    born, survive = got.masks()
    assert [born >> i & 1 for i in range(9)] == list(want.luts()[0])
    assert [survive >> i & 1 for i in range(9)] == list(want.luts()[1])


@pytest.mark.parametrize("s", ["", "B36/S23", "B3/S32"])
def test_parse_rule_lifelike(s):
    assert tparse_rule(s).rulestring == jparse_rule(s).rulestring


@pytest.mark.parametrize("s", ["/2/3", "345/2/4",
                               "R5,C0,M1,S33..57,B34..45,NM",
                               "lenia:r=13,mu=0.15,sigma=0.015,dt=0.1"])
def test_parse_rule_other_families_not_ported(s):
    """Generations, Larger-than-Life and Lenia rulestrings parse to the
    JAX package's canonical rule of the same family (all four families
    are ported; the name predates the conv/FFT families)."""
    want = jparse_rule(s)
    got = tparse_rule(s)
    assert type(got).__name__ == type(want).__name__
    assert got.rulestring == want.rulestring
    if type(want).__name__ == "GenerationsRule":
        assert (got.born, got.survive, got.states) == \
            (want.born, want.survive, want.states)
    elif type(want).__name__ == "LargerThanLifeRule":
        assert (got.radius, got.kind, got.middle, got.survive_ranges,
                got.born_ranges) == (want.radius, want.kind, want.middle,
                                     want.survive_ranges, want.born_ranges)
        assert [list(x) for x in got.luts()] == \
            [list(x) for x in want.luts()]
    else:
        assert (got.radius, got.mu, got.sigma, got.dt) == \
            (want.radius, want.mu, want.sigma, want.dt)


def test_parse_rule_garbage():
    with pytest.raises(ValueError):
        tparse_rule("conway please")
