"""The port's RLE codec and pattern library (`gol_tpu_torch/io/rle.py`,
`gol_tpu_torch/models/patterns.py`) against the JAX package's, and the
CLI's `--rle` seed: `python -m gol_tpu_torch --rle ...` writes the final
PGM bytes `gol_tpu`'s CLI writes."""

import os
import subprocess
import sys

import numpy as np
import pytest

from gol_tpu.io import rle as jrle
from gol_tpu.models import patterns as jpat

from gol_tpu_torch.io import rle as trle
from gol_tpu_torch.models import patterns as tpat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", sorted(jpat.PATTERNS))
def test_library_patterns_parse_as_jax(name):
    assert tpat.PATTERNS[name] == jpat.PATTERNS[name]
    cells, w, h, rule = trle.parse_rle(tpat.PATTERNS[name])
    jcells, jw, jh, jrule = jrle.parse_rle(jpat.PATTERNS[name])
    assert (cells, w, h) == (jcells, jw, jh)
    assert rule is None and jrule is None
    board = trle.rle_board(tpat.PATTERNS[name])
    np.testing.assert_array_equal(board, jrle.rle_board(jpat.PATTERNS[name]))
    assert trle.to_rle(board) == jrle.to_rle(board)
    assert tpat.pattern_cells(name, at=(3, 5)) == \
        jpat.pattern_cells(name, at=(3, 5))


@pytest.mark.parametrize("text", [
    "x = 2, y = 1, rule = B36/S23\n2o!\n",
    "x = 1, y = 1, rule = s23/b36\no!\n",
    "x = 1, y = 1, rule = 23/3\no!\n",
    "#C a comment\nx = 30, y = 2\n24bo$12o!\n",
])
def test_headers_and_runs_parse_as_jax(text):
    cells, w, h, rule = trle.parse_rle(text)
    jcells, jw, jh, jrule = jrle.parse_rle(text)
    assert (cells, w, h) == (jcells, jw, jh)
    assert (rule.rulestring if rule else None) == \
        (jrule.rulestring if jrule else None)


@pytest.mark.parametrize("bad", [
    "3o!",                          # no header
    "x = 3, y = 1\n3o",             # missing terminator
    "x = 3, y = 1\n3z!",            # unknown tag
    "x = 2, y = 1\n3o!",            # cell outside extent
    "x = 1, y = 1, rule = S23\no!\n",
    "x = 1, y = 1, rule = B3\no!\n",
    "x = 1, y = 1, rule = B3/S23/x\no!\n",
    "x = 1, y = 1, rule = B9/S23\no!\n",
    "x = 1, y = 1, rule = 3\no!\n",
])
def test_malformed_inputs_refused_as_jax(bad):
    with pytest.raises(jrle.RleError):
        jrle.parse_rle(bad)
    with pytest.raises(trle.RleError) as ei:
        trle.parse_rle(bad)
    assert isinstance(ei.value, ValueError)


def test_round_trip_random_boards():
    rng = np.random.default_rng(3)
    for shape in [(1, 1), (5, 9), (17, 33), (40, 40), (0, 3)]:
        board = (rng.random(shape) < 0.4).astype(np.uint8)
        text = trle.to_rle(board)
        assert text == jrle.to_rle(board)
        np.testing.assert_array_equal(trle.rle_board(text), board)


def test_stamp_wraps_on_torus():
    board = np.zeros((10, 10), dtype=np.uint8)
    tpat.stamp(board, "blinker", at=(9, 9), value=255)
    want = jpat.stamp(np.zeros((10, 10), np.uint8), "blinker", at=(9, 9),
                      value=255)
    np.testing.assert_array_equal(board, want)
    assert board[9, 9] == board[9, 0] == board[9, 1] == 255


def _env(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["GOL_OUT"] = str(tmp_path / "port")
    for k in ("SER", "CONT", "GOL_RULE"):
        env.pop(k, None)
    return env


def _jax_cli(args, tmp_path, monkeypatch):
    from gol_tpu.main import main
    import gol_tpu.distributor as dist

    monkeypatch.setenv("GOL_OUT", str(tmp_path / "jax"))
    monkeypatch.delenv("SER", raising=False)
    monkeypatch.delenv("CONT", raising=False)
    monkeypatch.setattr(dist, "_default_engine", None)
    assert main(args + ["--headless"]) == 0


@pytest.mark.parametrize("args,name", [
    (["--rle", "glider", "-w", "32", "-h", "32", "--turns", "8"],
     "32x32x8.pgm"),
    (["--rle", "gosper-gun", "-w", "64", "-h", "48", "--turns", "30"],
     "64x48x30.pgm"),
])
def test_cli_rle_writes_the_jax_clis_pgm(args, name, tmp_path, monkeypatch):
    out = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", *args, "--headless",
         "--device", "cpu"], capture_output=True, text=True, timeout=120,
        env=_env(tmp_path), cwd=str(tmp_path), stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stderr
    assert f"File {name} output complete" in out.stdout
    _jax_cli(args, tmp_path, monkeypatch)
    assert (tmp_path / "port" / name).read_bytes() == \
        (tmp_path / "jax" / name).read_bytes()


def test_cli_rle_declared_rule_and_override(tmp_path, monkeypatch):
    """An RLE file's rule drives the run unless --rule overrides it, as
    in the JAX CLI (Seeds, B2/S: the pair dies and four cells are
    born)."""
    rle = tmp_path / "pair.rle"
    rle.write_text("x = 2, y = 1, rule = B2/S\n2o!\n")
    for extra in ([], ["--rule", "B3/S23"]):
        args = ["--rle", str(rle), "-w", "16", "-h", "16", "--turns", "1",
                *extra]
        out = subprocess.run(
            [sys.executable, "-m", "gol_tpu_torch", *args, "--headless",
             "--device", "cpu"], capture_output=True, text=True,
            timeout=120, env=_env(tmp_path), cwd=str(tmp_path),
            stdin=subprocess.DEVNULL)
        assert out.returncode == 0, out.stderr
        _jax_cli(args, tmp_path, monkeypatch)
        got = (tmp_path / "port" / "16x16x1.pgm").read_bytes()
        assert got == (tmp_path / "jax" / "16x16x1.pgm").read_bytes()
        alive = int((np.frombuffer(got[-256:], np.uint8) == 255).sum())
        assert alive == (4 if not extra else 0)


def test_cli_rle_refuses_a_pattern_larger_than_the_board(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", "--rle", "gosper-gun",
         "-w", "16", "-h", "16", "--turns", "1", "--headless", "--device",
         "cpu"], capture_output=True, text=True, timeout=120,
        env=_env(tmp_path), cwd=str(tmp_path), stdin=subprocess.DEVNULL)
    assert out.returncode != 0
    assert "exceeds board" in out.stderr
