"""PGM (P5) board I/O, byte-compatible with `gol_tpu/io/pgm.py`.

Reads of {0, 255} boards go through the native C++ codec (`native.py`)
when it is built, else through numpy; both accept the same files.
`read_pgm.served` counts which codec served each read. Writes are numpy
alone: the fsync dominates them, and the native write was no faster on
an H100 host (PERF.md). Contracts preserved:

* input path  `images/{W}x{H}.pgm`
* output path `out/{W}x{H}x{TURN}.pgm`
* P5 binary, maxval MUST be 255
* payload bytes strictly {0, 255}, or the gray levels `levels=` names
  (the Generations encoding, `models/generations.gray_levels`)
"""

from __future__ import annotations

import os
import threading

import numpy as np

MAGIC = b"P5"
MAXVAL = 255


def input_path(width: int, height: int, images_dir: str = "images") -> str:
    return os.path.join(images_dir, f"{width}x{height}.pgm")


def output_path(
    width: int, height: int, turn: int, out_dir: str = "out"
) -> str:
    return os.path.join(out_dir, f"{width}x{height}x{turn}.pgm")


def _read_token(buf: bytes, pos: int) -> tuple[bytes, int]:
    """Read one whitespace-delimited header token, skipping '#' comments."""
    n = len(buf)
    while pos < n:
        c = buf[pos : pos + 1]
        if c == b"#":
            while pos < n and buf[pos : pos + 1] != b"\n":
                pos += 1
        elif c.isspace():
            pos += 1
        else:
            break
    start = pos
    while pos < n and not buf[pos : pos + 1].isspace():
        pos += 1
    if start == pos:
        raise ValueError("truncated PGM header")
    return buf[start:pos], pos


def _allowed(levels) -> tuple:
    return (0, MAXVAL) if levels is None else \
        tuple(sorted({int(v) for v in levels}))


def _count_outside(board: np.ndarray, allowed: tuple) -> int:
    """Cells whose byte is not in `allowed`. Sequential count_nonzero
    passes: one transient bool temporary at a time, which matters for
    the 4 GB pixels of a 65536² board."""
    return int(board.size
               - sum(np.count_nonzero(board == v) for v in allowed))


def read_pgm(path: str, levels=None) -> np.ndarray:
    """Read a P5 PGM into an (H, W) uint8 array of {0, 255}, or of the
    byte values in `levels` when given: the header is tokenized, then
    exactly W*H payload bytes are taken after the single whitespace byte
    that ends it. The native codec holds the {0, 255} contract only, so
    `levels` reads take the numpy path."""
    from gol_tpu_torch import native

    if levels is None:
        try:
            board = native.read_pgm(path)
        except native.HeaderParseError:
            # The native tokenizer may be stricter than the format (a 64
            # KB header prefix): re-parse in Python, so a file is
            # accepted alike with and without the library. Payload
            # errors raise ValueError above and are final.
            board = None
        if board is not None:
            read_pgm.served["native"] += 1
            return board
    read_pgm.served["numpy"] += 1
    return _read_pgm_np(path, _allowed(levels))


read_pgm.served = {"native": 0, "numpy": 0}


def _read_pgm_np(path: str, allowed: tuple) -> np.ndarray:
    with open(path, "rb") as f:
        buf = f.read()
    magic, pos = _read_token(buf, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not a P5 PGM (magic {magic!r})")
    wtok, pos = _read_token(buf, pos)
    htok, pos = _read_token(buf, pos)
    mtok, pos = _read_token(buf, pos)
    width, height, maxval = int(wtok), int(htok), int(mtok)
    if width <= 0 or height <= 0:
        raise ValueError(f"{path}: non-positive dims {width}x{height}")
    if maxval != MAXVAL:
        raise ValueError(f"{path}: maxval must be {MAXVAL}, got {maxval}")
    pos += 1  # exactly one whitespace byte separates header from payload
    payload = buf[pos : pos + width * height]
    if len(payload) != width * height:
        raise ValueError(
            f"{path}: expected {width * height} payload bytes, "
            f"got {len(payload)}"
        )
    board = np.frombuffer(payload, dtype=np.uint8).reshape(height, width)
    bad = _count_outside(board, allowed)
    if bad:
        raise ValueError(f"{path}: {bad} cells not in {set(allowed)}")
    return board.copy()


def write_pgm(path: str, board: np.ndarray, levels=None) -> None:
    """Write an (H, W) uint8 {0, 255} board (or one of the byte values in
    `levels`) as P5, atomically: a tmp file per writer (pid + thread),
    fsync, then rename — readers see either the complete old file or the
    complete new one."""
    if board.dtype != np.uint8 or board.ndim != 2:
        raise ValueError(f"board must be 2-D uint8, got {board.dtype} "
                         f"shape {board.shape}")
    allowed = _allowed(levels)
    bad = _count_outside(board, allowed)
    if bad:
        raise ValueError(
            f"{bad} cells not in {set(allowed)} "
            "(pass pixels, not {0,1} cells)")
    height, width = board.shape
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(MAGIC + b"\n")
            f.write(f"{width} {height}\n".encode())
            f.write(f"{MAXVAL}\n".encode())
            f.write(board.tobytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
