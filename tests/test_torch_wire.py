"""Wire codecs of the port against `gol_tpu.wire`, byte for byte: the same
boards, made from a seed with numpy, encode to the same frames under every
caps set in both packages, each package decodes the other's frames to the
same array, the caps handshake agrees, and hostile frames raise
`WireProtocolError` in both. Tolerance: none (bytes and integer boards)."""

import json
import socket
import struct
import threading
import zlib

import numpy as np
import pytest

from gol_tpu import wire as jw
from gol_tpu.ops.bitpack import pack_np as jpack_np
from gol_tpu.ops.bitpack import words_bytes_np
from gol_tpu.ops.reference import run_turns_np
from gol_tpu_torch import wire as tw
from gol_tpu_torch.models.generations import BRIANS_BRAIN, to_pixels_gen

PACKAGES = {"jax": jw, "torch": tw}
CAPSETS = {
    "none": frozenset(),
    "packed": frozenset({"packed"}),
    "zlib": frozenset({"zlib"}),
    "packed+zlib": frozenset({"packed", "zlib"}),
    "xrle": frozenset({"xrle"}),
    "f32": frozenset({"f32"}),
}


def _binary(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < 0.3).astype(np.uint8) * 255


def _gray(h, w, seed):
    rng = np.random.default_rng(seed)
    state = rng.choice(np.array([0, 1, 2], np.uint8), size=(h, w),
                       p=[0.6, 0.25, 0.15])
    return to_pixels_gen(state, BRIANS_BRAIN)


BOARDS = {
    "16x16": lambda: _binary(16, 16, 16),
    "64x64": lambda: _binary(64, 64, 64),
    "512x512": lambda: _binary(512, 512, 512),
    "33x17": lambda: _binary(33, 17, 33),
    "gray64x96": lambda: _gray(64, 96, 7),
}


def _frame_bytes(frame) -> bytes:
    return b"".join(memoryview(c).cast("B").tobytes() for c in frame.chunks)


def _pair():
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)
    return a, b


def _send_recv(sender, receiver, frame, xrle_basis=None):
    """sender.send_msg(frame) over a socketpair into receiver.recv_msg."""
    a, b = _pair()

    def send():
        try:
            sender.send_msg(a, {"ok": True}, frame=frame)
        except OSError:
            pass  # the receiver refused the frame and hung up

    t = threading.Thread(target=send)
    t.start()
    try:
        return receiver.recv_msg(b, xrle_basis=xrle_basis)
    finally:
        b.close()
        t.join(10)
        a.close()
        assert not t.is_alive()


# ------------------------------------------------------------ encoding


@pytest.mark.parametrize("caps", CAPSETS.values(), ids=CAPSETS.keys())
@pytest.mark.parametrize("board", BOARDS.values(), ids=BOARDS.keys())
def test_encode_board_same_bytes(board, caps):
    world = board()
    fj = jw.encode_board(world, caps)
    ft = tw.encode_board(world, caps)
    assert ft.meta() == fj.meta()
    assert tw.freeze_message({"ok": True, "turn": 5}, ft) == \
        jw.freeze_message({"ok": True, "turn": 5}, fj)


@pytest.mark.parametrize("caps", CAPSETS.values(), ids=CAPSETS.keys())
@pytest.mark.parametrize("board", BOARDS.values(), ids=BOARDS.keys())
@pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
def test_each_package_decodes_the_others_frames(direction, board, caps):
    world = board()
    src, dst = ((jw, tw) if direction == "jax->torch" else (tw, jw))
    hdr, got = _send_recv(src, dst, src.encode_board(world, caps))
    assert hdr["ok"] is True
    np.testing.assert_array_equal(got, world)


def test_freeze_message_fixed_header_same_bytes():
    header = {"method": "Alivecount", "caps": ["packed", "xrle", "zlib"],
              "req_id": "0123456789abcdef"}
    assert tw.freeze_message(header) == jw.freeze_message(header)
    assert tw.frame_header(header) == jw.frame_header(header)


def test_pack_bits_is_the_jax_byte_packing():
    for name, board in BOARDS.items():
        world = board()
        np.testing.assert_array_equal(tw.pack_bits(world), jpack_np(world),
                                      err_msg=name)
        np.testing.assert_array_equal(
            tw.unpack_bits(tw.pack_bits(world), *world.shape),
            jw.unpack_np(jpack_np(world), *world.shape), err_msg=name)


@pytest.mark.parametrize("shape", [(64, 64), (33, 17), (512, 512)])
def test_xrle_successive_boards_same_bytes(shape):
    cells = (_binary(*shape, seed=shape[1]) != 0).astype(np.uint8)
    boards = [cells]
    for _ in range(3):
        boards.append(run_turns_np(boards[-1], 1))
    boards.append(boards[-1].copy())  # an identical frame: b""
    px = [b * 255 for b in boards]
    for prev, cur in zip(px, px[1:]):
        dj = jw.xrle_encode(cur, prev)
        assert tw.xrle_encode(cur, prev) == dj
        for src, dst in ((jw, tw), (tw, jw)):
            frame = src.encode_view_frame(cur, src.SUPPORTED_CAPS,
                                          basis=prev, basis_turn=9,
                                          binary=True)
            _, got = _send_recv(src, dst, frame, xrle_basis=(9, prev))
            np.testing.assert_array_equal(got, cur)
    assert tw.xrle_encode(px[-1], px[-2]) == b""
    # a dense change loses to the raw board: both fall back (None)
    noise = np.random.default_rng(1).integers(0, 256, shape, np.uint8)
    assert tw.xrle_encode(noise, px[0]) is None
    assert jw.xrle_encode(noise, px[0]) is None


@pytest.mark.parametrize("caps", [frozenset({"f32"}),
                                  frozenset({"f32", "zlib"})],
                         ids=["f32", "f32+zlib"])
def test_encode_board_f32_same_bytes(caps):
    rng = np.random.default_rng(32)
    state = np.round(rng.random((48, 40)), 2).astype(np.float32)
    fj = jw.encode_board_f32(state, caps)
    ft = tw.encode_board_f32(state, caps)
    assert ft.codec == fj.codec
    assert _frame_bytes(ft) == _frame_bytes(fj)
    for src, dst in ((jw, tw), (tw, jw)):
        _, got = _send_recv(src, dst, src.encode_board_f32(state, caps))
        np.testing.assert_array_equal(got, state)
    with pytest.raises(ValueError):
        tw.encode_board_f32(state, frozenset())


def _word_bands(h, w, seed, dtype):
    """(rows, ceil(w/32)) word bands of a seeded board: uint32 for the
    JAX package, the port engine's int32 carrier (negative words
    included) for the port."""
    world = _binary(h, w, seed)
    words = jpack_np(world).view("<u4")
    bands = [words[r:r + 7] for r in range(0, h, 7)]
    return world, [b.view(dtype) for b in bands]


@pytest.mark.parametrize("caps", [frozenset(), frozenset({"packed"}),
                                  frozenset({"packed", "zlib"})],
                         ids=["none", "packed", "packed+zlib"])
@pytest.mark.parametrize("shape", [(64, 64), (33, 17), (40, 96)])
def test_packed_words_frame_same_bytes(shape, caps):
    world, jbands = _word_bands(*shape, seed=5, dtype=np.uint32)
    _, tbands = _word_bands(*shape, seed=5, dtype=np.int32)
    if shape[1] >= 32:  # the sign bit is data
        assert any((b < 0).any() for b in tbands)
    fj = jw.packed_words_frame(*shape, iter(jbands), caps)
    ft = tw.packed_words_frame(*shape, iter(tbands), caps)
    assert ft.meta() == fj.meta()
    assert _frame_bytes(ft) == _frame_bytes(fj)
    _, got = _send_recv(tw, jw, tw.packed_words_frame(
        *shape, iter(tbands), caps))
    np.testing.assert_array_equal(got, world)


@pytest.mark.parametrize("caps", [frozenset(), frozenset({"packed"}),
                                  frozenset({"zlib"})],
                         ids=["none", "packed", "zlib"])
@pytest.mark.parametrize("gray", [False, True], ids=["binary", "gray"])
def test_u8_band_frame_same_bytes(gray, caps):
    h, w = 50, 96
    if gray:
        px = _gray(h, w, 3)
        bands = [px[r:r + 16] for r in range(0, h, 16)]
        kw = dict(binary=False)
    else:
        px = _binary(h, w, 3)
        bands = [(px[r:r + 16] != 0).astype(np.uint8)
                 for r in range(0, h, 16)]
        kw = dict(binary=True, values01=True)
    fj = jw.u8_band_frame(h, w, iter(bands), caps, **kw)
    ft = tw.u8_band_frame(h, w, iter(bands), caps, **kw)
    assert ft.meta() == fj.meta()
    assert _frame_bytes(ft) == _frame_bytes(fj)
    _, got = _send_recv(tw, jw, tw.u8_band_frame(h, w, iter(bands), caps,
                                                 **kw))
    np.testing.assert_array_equal(got, px)


def test_words_bytes_reinterprets_int32():
    words = np.array([[-1, 1, -2147483648]], dtype=np.int32)
    assert tw.words_bytes(words).tobytes() == \
        words_bytes_np(words.view(np.uint32)).tobytes() == \
        b"\xff\xff\xff\xff\x01\x00\x00\x00\x00\x00\x00\x80"
    with pytest.raises(ValueError):
        tw.words_bytes(words.astype(np.int64))


# ----------------------------------------------------------- handshake


@pytest.mark.parametrize("env", [None, "", "packed", "packed, zlib",
                                 "bogus,xrle", "f32,zlib,packed,xrle"])
def test_caps_negotiation_agrees(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("GOL_WIRE_CAPS", raising=False)
    else:
        monkeypatch.setenv("GOL_WIRE_CAPS", env)
    assert tw.local_caps() == jw.local_caps()
    assert tw.advertised_caps() == jw.advertised_caps()
    for header in ({}, {"caps": "packed"}, {"caps": ["packed", "zlib"]},
                   {"caps": ["xrle", "bogus", 7]}, {"caps": [["x"], 1]},
                   {"caps": sorted(jw.SUPPORTED_CAPS)}):
        assert tw.negotiate(header) == jw.negotiate(header), header
        assert tw.ConnectionEncoder(header).caps == \
            jw.ConnectionEncoder(header).caps
        assert tw.ConnectionEncoder(header).stamp({}) == \
            jw.ConnectionEncoder(header).stamp({})
    assert tw.SUPPORTED_CAPS == jw.SUPPORTED_CAPS
    assert tw.CODECS == jw.CODECS


# ------------------------------------------------------- hostile input


def _hostile(case):
    """(raw bytes a peer sends, recv_msg kwargs, error pattern)."""
    basis = (0, np.zeros((64, 64), np.uint8))

    def head(world, extra=b""):
        hdr = json.dumps({"ok": True, "world": world}).encode()
        return struct.pack(">I", len(hdr)) + hdr + extra

    if case == "oversized header":
        return struct.pack(">I", jw.MAX_HEADER + 1), {}, "header too large"
    if case == "board cells":
        return head({"h": 2**18, "w": 2**18}), {}, "dims out of bounds"
    if case == "negative dims":
        return head({"h": -1, "w": 4}), {}, "dims out of bounds"
    if case == "not an object":
        raw = b"[1, 2]"
        return struct.pack(">I", len(raw)) + raw, {}, "expected object"
    if case == "bad json":
        return struct.pack(">I", 5) + b"notjs", {}, "malformed header"
    if case == "unknown codec":
        return head({"h": 8, "w": 8, "codec": "lzma", "nbytes": 64}), {}, \
            "unknown codec"
    if case.startswith("bound "):
        codec, nbytes = case.split()[1], int(case.split()[2])
        return head({"h": 64, "w": 64, "codec": codec, "nbytes": nbytes,
                     "basis_turn": 0}), {"xrle_basis": basis}, \
            "frame size out of bounds"
    if case == "zlib bomb":
        bomb = zlib.compress(b"\x00" * (64 * 64), 1)
        return head({"h": 8, "w": 8, "codec": "u8+zlib",
                     "nbytes": len(bomb)}, bomb), {}, "zlib payload"
    if case == "corrupt xrle":
        delta = struct.pack("<II", 4090, 100) + b"\x01" * 100
        return head({"h": 64, "w": 64, "codec": "xrle",
                     "nbytes": len(delta), "basis_turn": 0}, delta), \
            {"xrle_basis": basis}, "segment out of bounds"
    if case == "truncated xrle token":
        delta = b"\x01\x00\x00"
        return head({"h": 64, "w": 64, "codec": "xrle",
                     "nbytes": len(delta), "basis_turn": 0}, delta), \
            {"xrle_basis": basis}, "truncated token"
    if case == "xrle without basis":
        delta = struct.pack("<II", 0, 1) + b"\x01"
        return head({"h": 64, "w": 64, "codec": "xrle",
                     "nbytes": len(delta), "basis_turn": 3}, delta), \
            {"xrle_basis": basis}, "without matching basis"
    raise AssertionError(case)


HOSTILE = ["oversized header", "board cells", "negative dims",
           "not an object", "bad json", "unknown codec",
           "bound packed 1", "bound u8 1", "bound u8+zlib 4096",
           "bound xrle 4096", "bound u8+zlib 0", "bound f32 4096",
           "zlib bomb", "corrupt xrle", "truncated xrle token",
           "xrle without basis"]


@pytest.mark.parametrize("pkg", PACKAGES.values(), ids=PACKAGES.keys())
@pytest.mark.parametrize("case", HOSTILE)
def test_hostile_frames_raise_protocol_error(case, pkg, monkeypatch):
    monkeypatch.setenv("GOL_MAX_BOARD_CELLS", str(1 << 30))
    raw, kw, pattern = _hostile(case)
    a, b = _pair()
    try:
        a.sendall(raw)
        with pytest.raises(pkg.WireProtocolError, match=pattern):
            pkg.recv_msg(b, **kw)
    finally:
        a.close()
        b.close()
    assert issubclass(tw.WireProtocolError, ConnectionError)


def test_max_board_cells_is_read_per_message(monkeypatch):
    world = _binary(64, 64, 1)
    monkeypatch.setenv("GOL_MAX_BOARD_CELLS", str(64 * 64 - 1))
    for src, dst in ((jw, tw), (tw, jw)):
        with pytest.raises(dst.WireProtocolError, match="out of bounds"):
            _send_recv(src, dst, src.encode_board(world))
    monkeypatch.delenv("GOL_MAX_BOARD_CELLS")
    assert tw.max_board_cells() == jw.max_board_cells() == 1 << 35


# ----------------------------------------------------------- raw relay


@pytest.mark.parametrize("caps", [frozenset(), frozenset({"packed"})],
                         ids=["none", "packed"])
def test_raw_relay_forwards_jax_frames_verbatim(caps):
    world = _binary(64, 64, 11)
    msg = jw.freeze_message({"ok": True, "turn": 4},
                            jw.encode_board(world, caps))
    a, b = _pair()
    c, d = _pair()
    try:
        a.sendall(msg)
        header, raw = tw.recv_head_raw(b)
        n = tw.payload_nbytes(header)
        assert n == jw.payload_nbytes(header)
        t = threading.Thread(target=lambda: (
            tw.send_raw(c, raw), tw.relay_payload(b, c, n)))
        t.start()
        hdr, got = jw.recv_msg(d)
        t.join(10)
        assert hdr["turn"] == 4
        np.testing.assert_array_equal(got, world)
    finally:
        for s in (a, b, c, d):
            s.close()
