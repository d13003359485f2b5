"""Seeded fuzz of the port's hand-rolled parsers against `gol_tpu`'s
(`tests/test_fuzz.py`'s seeds and counts): every garbage RLE text, wire
frame and PGM file goes through the port's `io.rle`, `wire.recv_msg` and
`io.pgm.read_pgm` and through the JAX package's, and both raise the same
exception type (by name, with the same message for RLE) or parse to the
same result. The native C++ PGM reader (`gol_tpu_torch/csrc/golnative.cpp`)
reads every PGM case in a subprocess, so that a crash fails one test and
leaves the session running; it must never accept what the port's numpy
reader refuses. Regression: a NUL byte inside a header token ("2\\0"),
which the native tokenizer accepted and numpy's int() refuses. The JAX
package's native reader still accepts it; its numpy reader refuses it, and
the port now refuses it on both paths. Tolerance: none."""

import json
import os
import socket
import struct
import subprocess
import sys

import numpy as np
import pytest

from gol_tpu.io import pgm as jpgm
from gol_tpu.io import rle as jrle
from gol_tpu.wire import recv_msg as jrecv_msg
from gol_tpu_torch import native
from gol_tpu_torch.io import pgm
from gol_tpu_torch.io import rle
from gol_tpu_torch.wire import recv_msg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RLE_ALPHABET = list("bo$!0123456789xy=, \nB/S#rule")


def _outcome(fn, *args):
    """("ok", result) or (exception type name, message)."""
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 — the type is the verdict
        return type(e).__name__, str(e)


def _same_rle(text):
    got = _outcome(rle.parse_rle, text)
    want = _outcome(jrle.parse_rle, text)
    assert got[0] in ("ok", "RleError"), (text, got)
    if got[0] == "ok":
        cells, w, h, r = got[1]
        jcells, jw, jh, jr = want[1]
        assert (cells, w, h) == (jcells, jw, jh)
        assert (r is None) == (jr is None)
        if r is not None:
            assert r.rulestring == jr.rulestring
    else:
        assert got == want, text
    return got


def test_rle_parser_fuzz():
    rng = np.random.default_rng(1234)
    for _ in range(200):
        n = int(rng.integers(1, 120))
        _same_rle("".join(rng.choice(RLE_ALPHABET, size=n)))


def test_rle_header_prefix_fuzz():
    rng = np.random.default_rng(99)
    for _ in range(100):
        n = int(rng.integers(0, 60))
        body = "".join(rng.choice(RLE_ALPHABET, size=n))
        kind, res = _same_rle(f"x = 9, y = 9\n{body}")
        if kind == "ok":
            assert all(cx < 9 and cy < 9 for cx, cy in res[0])


def test_rle_round_trip_fuzz():
    rng = np.random.default_rng(7)
    for _ in range(50):
        h = int(rng.integers(1, 24))
        w = int(rng.integers(1, 24))
        board = (rng.random((h, w)) < rng.random()).astype(np.uint8)
        text = rle.to_rle(board)
        assert text == jrle.to_rle(board)
        np.testing.assert_array_equal(rle.rle_board(text), board)
        np.testing.assert_array_equal(jrle.rle_board(text), board)


def _recv(fn, data):
    """The name of the ConnectionError/OSError `fn` raises on `data`, or
    "ok"; any other exception propagates and fails the test."""
    a, b = socket.socketpair()
    try:
        a.sendall(data)
        a.close()
        b.settimeout(5)
        try:
            fn(b)
        except (ConnectionError, OSError, socket.timeout) as e:
            return type(e).__name__
        return "ok"
    finally:
        b.close()


def test_wire_recv_fuzz():
    """Random length-prefixed junk: both packages' recv_msg fail with
    the same ConnectionError/OSError type and never block."""
    rng = np.random.default_rng(42)
    for _ in range(200):
        n = int(rng.integers(0, 64))
        payload = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        data = struct.pack(">I", len(payload)) + payload
        got = _recv(recv_msg, data)
        assert got != "ok" and got == _recv(jrecv_msg, data), payload


def _pgm_cases():
    """(name, bytes) of every PGM case of `tests/test_fuzz.py`: its seeds
    and its 100 random `P5` + garbage files (seed 5)."""
    seeds = [b"", b"P5", b"P5\n", b"P2\n1 1\n255\n0",
             b"P5\n0 0\n255\n", b"P5\n4 4\n999\n" + b"\x00" * 16,
             b"P5\n-1 4\n255\n", b"P5\n4\n255\n\x00\x00\x00\x00"]
    out = [(f"seed{i}", s) for i, s in enumerate(seeds)]
    rng = np.random.default_rng(5)
    for i in range(100):
        n = int(rng.integers(0, 80))
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        out.append((f"rand{i}", b"P5" + data))
    return out


# Header tokens with a NUL byte: the native tokenizer used to read "2\0"
# as 2; numpy's int() refuses the token.
NUL_CASES = [("nul-width", b"P5\n2\x00 2\n255\n\xff\x00\x00\xff"),
             ("nul-maxval", b"P5\n2 2\n255\x00\n\xff\x00\x00\xff"),
             ("nul-height", b"P5 2 2\x00\x00 255 \xff\x00\x00\xff")]


def _write_cases(tmp_path, cases):
    paths = []
    for name, data in cases:
        p = tmp_path / f"{name}.pgm"
        p.write_bytes(data)
        paths.append(str(p))
    return paths


def _verdict(res):
    kind, val = res
    return (kind, val.tobytes().hex(), list(val.shape)) if kind == "ok" \
        else (kind,)


def test_pgm_reader_fuzz(tmp_path):
    """The port's `read_pgm` and `gol_tpu`'s on every case: the seeds all
    raise (ValueError/OSError); every case raises the same type or reads
    the same board."""
    for i, path in enumerate(_write_cases(tmp_path, _pgm_cases())):
        got = _outcome(pgm.read_pgm, path)
        want = _outcome(jpgm.read_pgm, path)
        if i < 8:
            assert got[0] in ("ValueError", "FileNotFoundError",
                              "IsADirectoryError", "OSError"), got
        assert _verdict(got) == _verdict(want), path


def test_pgm_nul_token_refused_as_gol_tpu_numpy_refuses(tmp_path):
    for path in _write_cases(tmp_path, NUL_CASES):
        got = _outcome(pgm.read_pgm, path)
        assert got[0] == "ValueError", (path, got)
        assert got == _outcome(jpgm._read_pgm_py, path, (0, 255))
        assert got == _outcome(pgm._read_pgm_np, path, (0, 255))


NATIVE_RUNNER = """
import json, sys
from gol_tpu_torch import native
out = []
for path in json.loads(sys.argv[1]):
    try:
        board = native.read_pgm(path)
        out.append(["ok", board.tobytes().hex(), list(board.shape)])
    except Exception as e:
        out.append([type(e).__name__])
print(json.dumps({"lib": str(native.library_path()), "verdicts": out}))
"""


def _native_verdicts(paths):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", NATIVE_RUNNER, json.dumps(paths)],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, \
        f"native reader process died ({proc.returncode}): {proc.stderr}"
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["lib"] != "None"
    return [tuple(v) for v in doc["verdicts"]]


@pytest.mark.parametrize("cases", ["fuzz", "nul"])
def test_native_pgm_reader_never_accepts_what_numpy_refuses(tmp_path,
                                                            cases):
    """Each case through `native.read_pgm` in a subprocess. Where it
    reads a board, the numpy reader reads the same board; where the
    numpy reader refuses, the native reader refuses too (its header
    errors are `HeaderParseError`, a ValueError, which `read_pgm` then
    re-parses in numpy)."""
    if not native.available():
        pytest.skip("no C++ compiler here: the native PGM reader cannot "
                    "be built")
    chosen = _pgm_cases() if cases == "fuzz" else NUL_CASES
    paths = _write_cases(tmp_path, chosen)
    native_v = _native_verdicts(paths)
    assert len(native_v) == len(paths)
    for path, nv in zip(paths, native_v):
        npv = _verdict(_outcome(pgm._read_pgm_np, path, (0, 255)))
        if nv[0] == "ok":
            assert npv == nv, path
        elif npv[0] != "ok":
            assert nv[0] in ("HeaderParseError", "ValueError",
                             "FileNotFoundError"), (path, nv)
        else:
            # Stricter than numpy is allowed only in the header.
            assert nv[0] == "HeaderParseError", (path, nv, npv)
    if cases == "nul":
        assert {v[0] for v in native_v} == {"HeaderParseError"}


def test_server_dispatch_fuzz():
    """Random well-formed JSON headers (junk methods, junk fields, wrong
    types) against a live port server: every request gets either an
    error reply or a dropped connection, and the server keeps serving."""
    from gol_tpu_torch.client import RemoteEngine
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.server import EngineServer
    from gol_tpu_torch.wire import send_msg

    srv = EngineServer(port=0, host="127.0.0.1", engine=Engine(device="cpu"))
    srv.start_background()
    rng = np.random.default_rng(77)
    methods = ["ServerDistributor", "Alivecount", "GetWorld", "CFput",
               "DrainFlags", "Ping", "Stats", "AbortRun", "NoSuch", "",
               None, 42]
    junk_values = [None, 0, -1, "x", [], {}, {"h": 1}, 1e308, True]
    try:
        for i in range(120):
            header = {"method": methods[int(rng.integers(len(methods)))]}
            for _ in range(int(rng.integers(0, 4))):
                key = ["params", "flag", "token", "start_turn",
                       "sub_workers", "world", "extra"][
                           int(rng.integers(7))]
                header[key] = junk_values[int(rng.integers(
                    len(junk_values)))]
            try:
                json.dumps(header)
            except (TypeError, ValueError):
                continue
            s = socket.create_connection(("127.0.0.1", srv.port),
                                         timeout=5)
            try:
                send_msg(s, header)
                resp, _ = recv_msg(s)
                assert isinstance(resp, dict)
            except (ConnectionError, OSError):
                pass  # a dropped connection is an acceptable rejection
            finally:
                s.close()
        eng = RemoteEngine(f"127.0.0.1:{srv.port}")
        assert eng.ping() == 0
        assert eng.stats()["devices"] >= 1
    finally:
        srv.shutdown()


def test_pgm_round_trip_fuzz(tmp_path):
    rng = np.random.default_rng(11)
    path = str(tmp_path / "rt.pgm")
    jpath = str(tmp_path / "jrt.pgm")
    for _ in range(25):
        h = int(rng.integers(1, 40))
        w = int(rng.integers(1, 40))
        board = (rng.random((h, w)) < 0.5).astype(np.uint8) * 255
        pgm.write_pgm(path, board)
        jpgm.write_pgm(jpath, board)
        assert open(path, "rb").read() == open(jpath, "rb").read()
        np.testing.assert_array_equal(pgm.read_pgm(path), board)
