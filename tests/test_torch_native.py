"""The port's native host layer (`gol_tpu_torch/native.py`, its own
`csrc/golnative.cpp`) and the PGM codec that dispatches to it, held
against `gol_tpu`'s: the counterparts of `tests/test_native.py`, each
compared with `gol_tpu.native` and `gol_tpu`'s numpy functions, plus the
port's library location, the codec dispatch and its counters, and the
fixtures' ash counts re-derived with `step_torus`.

Both libraries build from source with the host's C++ compiler; the cases
skip only where there is none. Tolerance: none (bytes and bits)."""

import os
import shutil

import numpy as np
import pytest
import torch

from gol_tpu import fixtures as jfixtures
from gol_tpu import native as jnative
from gol_tpu.io.pgm import read_pgm as jread_pgm
from gol_tpu.io.pgm import write_pgm as jwrite_pgm
from gol_tpu.ops.bitpack import pack as jpack
from gol_tpu.ops.bitpack import unpack as junpack
from gol_tpu.ops.reference import run_turns_np

from gol_tpu_torch import fixtures, native
from gol_tpu_torch.io import pgm
from gol_tpu_torch.ops import bitpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler in this environment")
    assert native.lib(build=True) is not None, "the port's library"
    assert jnative.ensure_built() and jnative.lib(build=True) is not None


def random_pixels(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random((h, w)) < 0.3).astype(np.uint8)) * 255


def test_port_loads_its_own_library():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "gol_tpu_torch")
    assert path.name.startswith("libgolnative_") and path.exists()
    assert path == native.target_path()
    assert path.resolve() != (native.BUILD_DIR.parent
                              / "libgolnative.so").resolve()
    assert native.SOURCE.parts[-3:] == ("gol_tpu_torch", "csrc",
                                        "golnative.cpp")


def test_pack_bits_matches_jax_layout():
    px = random_pixels(32, 96)
    got = native.pack_bits(px)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jnative.pack_bits(px))
    np.testing.assert_array_equal(
        got, np.asarray(jpack((px != 0).astype(np.uint8))))
    # The port's torch.int32 words carry the same bits.
    words = bitpack.pack(torch.from_numpy((px != 0).astype(np.uint8)))
    np.testing.assert_array_equal(bitpack.words_to_numpy(words), got)
    np.testing.assert_array_equal(got.view(np.int32), words.numpy())


def test_unpack_bits_roundtrip():
    px = random_pixels(16, 64, seed=3)
    words = native.pack_bits(px)
    np.testing.assert_array_equal(native.unpack_bits(words), px)
    np.testing.assert_array_equal(native.unpack_bits(words),
                                  jnative.unpack_bits(words))
    np.testing.assert_array_equal(np.asarray(junpack(words)) * 255, px)
    np.testing.assert_array_equal(bitpack.unpack_np(words) * 255, px)


def test_popcount():
    px = random_pixels(64, 128, seed=5)
    words = native.pack_bits(px)
    assert native.popcount(words) == jnative.popcount(words) \
        == int((px != 0).sum())
    assert bitpack.packed_alive_count(
        bitpack.words_from_numpy(words)) == native.popcount(words)


def test_pgm_roundtrip_and_python_interop(tmp_path):
    px = random_pixels(24, 40, seed=7)
    p_native = str(tmp_path / "native.pgm")
    p_port = str(tmp_path / "port.pgm")
    p_jax = str(tmp_path / "jax.pgm")
    assert native.write_pgm(p_native, px)
    pgm.write_pgm(p_port, px)
    jwrite_pgm(p_jax, px)
    want = open(p_jax, "rb").read()
    assert open(p_native, "rb").read() == want
    assert open(p_port, "rb").read() == want
    for p in (p_native, p_port, p_jax):
        np.testing.assert_array_equal(native.read_pgm(p), px)
        np.testing.assert_array_equal(pgm.read_pgm(p), px)
        np.testing.assert_array_equal(jread_pgm(p), px)
    # Path objects too.
    pgm.write_pgm(tmp_path / "path.pgm", px)
    assert (tmp_path / "path.pgm").read_bytes() == want
    np.testing.assert_array_equal(native.read_pgm(tmp_path / "path.pgm"),
                                  px)


def test_native_read_rejects_bad_payload(tmp_path):
    p = str(tmp_path / "bad.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n4 2\n255\n" + bytes([0, 255, 7, 0, 255, 0, 0, 255]))
    for read in (native.read_pgm, jnative.read_pgm, pgm.read_pgm):
        with pytest.raises(ValueError, match="not in"):
            read(p)


def test_native_read_missing_file():
    for read in (native.read_pgm, jnative.read_pgm, pgm.read_pgm):
        with pytest.raises(FileNotFoundError):
            read("no/such/file.pgm")


def test_step_torus_matches_oracle():
    b = (np.random.default_rng(9).random((48, 128)) < 0.3).astype(np.uint8)
    got = native.step_torus(b, 25)
    np.testing.assert_array_equal(got, run_turns_np(b, 25))
    np.testing.assert_array_equal(got, jnative.step_torus(b, 25))


def test_step_torus_glider_wraps():
    b = np.zeros((16, 64), dtype=np.uint8)
    for r, c in [(0, 1), (1, 2), (2, 0), (2, 1), (2, 2)]:
        b[r, (c + 62) % 64] = 1  # crosses the word boundary and the torus
    got = native.step_torus(b, 64 * 4)  # glider period x board wrap
    np.testing.assert_array_equal(got, run_turns_np(b, 64 * 4))
    np.testing.assert_array_equal(got, jnative.step_torus(b, 64 * 4))
    assert got.sum() == 5


def test_render_halfblocks():
    px = np.zeros((4, 6), dtype=np.uint8)
    px[0, 0] = 255  # top half
    px[1, 1] = 255  # bottom half
    px[2, 2] = 255
    px[3, 2] = 255  # full block
    s = native.render_halfblocks(px)
    lines = s.splitlines()
    assert len(lines) == 2
    assert lines[0][0] == "▀"
    assert lines[0][1] == "▄"
    assert lines[1][2] == "█"
    assert lines[0][2:] == "    "
    for board in (px, random_pixels(7, 33, seed=11)):
        assert native.render_halfblocks(board) \
            == jnative.render_halfblocks(board)


def test_native_header_rejects_partial_numeric_tokens(tmp_path):
    """'12abc' is a header error, not 12, in both packages."""
    p = tmp_path / "bad.pgm"
    p.write_bytes(b"P5\n12abc 16\n255\n" + bytes(16 * 16))
    for read in (native.read_pgm, jnative.read_pgm):
        with pytest.raises(ValueError, match="header"):
            read(str(p))
    with pytest.raises(ValueError):
        pgm.read_pgm(str(p))  # the Python re-parse rejects it too
    good = tmp_path / "good.pgm"
    good.write_bytes(b"P5\n16 16\n255\n" + bytes(256))
    assert native.read_pgm(str(good)).shape == (16, 16)


def test_native_header_reads_prefix_only(tmp_path):
    """The header parse reads a prefix: a giant sparse file's header
    parses without slurping the payload."""
    p = tmp_path / "big.pgm"
    h = w = 4096
    head = b"P5\n%d %d\n255\n" % (w, h)
    with open(p, "wb") as f:
        f.write(head)
        f.seek(len(head) + h * w - 1)
        f.write(b"\x00")
    board = native.read_pgm(str(p))
    assert board.shape == (h, w) and board.sum() == 0
    np.testing.assert_array_equal(board, jnative.read_pgm(str(p)))


def test_native_header_rejects_out_of_range_dims(tmp_path):
    """A dimension beyond long range is a header error, not a clamp."""
    p = tmp_path / "huge.pgm"
    p.write_bytes(b"P5\n99999999999999999999 16\n255\n" + bytes(16))
    for read in (native.read_pgm, jnative.read_pgm):
        with pytest.raises(ValueError, match="header"):
            read(str(p))


def test_codec_dispatch_and_counts(tmp_path):
    """io.pgm serves {0, 255} reads natively; `levels=` and a header the
    native tokenizer rejects (a comment past its 64 KB prefix) take the
    numpy path, which gol_tpu's reader agrees with. Writes are numpy's,
    byte-equal to the native codec's and to gol_tpu's."""
    px = random_pixels(8, 32, seed=13)
    before = dict(pgm.read_pgm.served)

    def delta():
        return {k: pgm.read_pgm.served[k] - before[k] for k in before}

    p = str(tmp_path / "a.pgm")
    pgm.write_pgm(p, px)
    np.testing.assert_array_equal(pgm.read_pgm(p), px)
    assert delta() == {"native": 1, "numpy": 0}
    n = str(tmp_path / "n.pgm")
    assert native.write_pgm(n, px)
    j = str(tmp_path / "j.pgm")
    jwrite_pgm(j, px)
    assert open(p, "rb").read() == open(n, "rb").read() \
        == open(j, "rb").read()

    gray = np.array([[0, 127, 255, 63]] * 2, dtype=np.uint8)
    q = str(tmp_path / "gray.pgm")
    pgm.write_pgm(q, gray, levels=(0, 63, 127, 255))
    np.testing.assert_array_equal(
        pgm.read_pgm(q, levels=(0, 63, 127, 255)), gray)
    assert delta() == {"native": 1, "numpy": 1}
    jq = str(tmp_path / "jgray.pgm")
    jwrite_pgm(jq, gray, levels=(0, 63, 127, 255))
    assert open(q, "rb").read() == open(jq, "rb").read()

    r = tmp_path / "comment.pgm"
    r.write_bytes(b"P5\n#" + b"x" * (70 * 1024) + b"\n32 8\n255\n"
                  + px.tobytes())
    with pytest.raises(native.HeaderParseError):
        native.read_pgm(str(r))
    np.testing.assert_array_equal(pgm.read_pgm(str(r)), px)
    np.testing.assert_array_equal(jread_pgm(str(r)), px)
    assert delta() == {"native": 1, "numpy": 2}


def test_fixtures_equal_jax_and_rederive():
    """The port's ash constants equal gol_tpu's, and the port's oracle
    re-derives them from the 512² fixture board."""
    for name in ("ASH_512_EVEN", "ASH_512_ODD", "ASH_512_SETTLED_BY"):
        assert getattr(fixtures, name) == getattr(jfixtures, name)
    for t in range(10_000, 10_004):
        assert fixtures.ash_512_alive(t) == jfixtures.ash_512_alive(t)
    start = pgm.read_pgm(os.path.join(REPO, "images", "512x512.pgm")) != 0
    b = native.step_torus(start.astype(np.uint8),
                          fixtures.ASH_512_SETTLED_BY)
    for t in range(fixtures.ASH_512_SETTLED_BY,
                   fixtures.ASH_512_SETTLED_BY + 3):
        assert int(b.sum()) == fixtures.ash_512_alive(t), t
        b = native.step_torus(b, 1)
