"""Boards: the P5 PGM codec, the torus symmetries and tiling.

Life on a torus is equivariant under the torus's symmetries: a rotation
or reflection of a square board, and any translation. A board tiled
n x m times stays tiled at every turn. The cells use both to make their
inputs from one committed board and a seed.
"""

from __future__ import annotations

import os

import numpy as np


def read_pgm(path: str) -> np.ndarray:
    """An (H, W) uint8 array of a P5 file with maxval 255. Raises
    ValueError on a malformed file."""
    with open(path, "rb") as f:
        buf = f.read()
    tokens, pos = [], 0
    while len(tokens) < 4:
        while pos < len(buf) and (buf[pos:pos + 1].isspace()
                                  or buf[pos:pos + 1] == b"#"):
            if buf[pos:pos + 1] == b"#":
                while pos < len(buf) and buf[pos:pos + 1] != b"\n":
                    pos += 1
            else:
                pos += 1
        start = pos
        while pos < len(buf) and not buf[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: truncated header")
        tokens.append(buf[start:pos])
    if tokens[0] != b"P5" or int(tokens[3]) != 255:
        raise ValueError(f"{path}: not a P5 file of maxval 255")
    w, h = int(tokens[1]), int(tokens[2])
    payload = buf[pos + 1:pos + 1 + w * h]
    if len(payload) != w * h:
        raise ValueError(f"{path}: {len(payload)} payload bytes, "
                         f"expected {w * h}")
    return np.frombuffer(payload, dtype=np.uint8).reshape(h, w).copy()


def write_pgm(path: str, pixels: np.ndarray) -> None:
    """Write an (H, W) uint8 board as P5."""
    h, w = pixels.shape
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(pixels, dtype=np.uint8).tobytes())


def draw_symmetry(rng: np.random.Generator, height: int,
                  width: int) -> tuple:
    """(k, flip, dy, dx): k quarter turns (any k on a square board, 0
    or 2 otherwise), a transpose-free flip of the columns, then a
    translation by (dy, dx)."""
    k = int(rng.integers(4)) if height == width else 2 * int(rng.integers(2))
    return (k, bool(rng.integers(2)), int(rng.integers(height)),
            int(rng.integers(width)))


def apply_symmetry(board: np.ndarray, sym: tuple) -> np.ndarray:
    k, flip, dy, dx = sym
    out = np.rot90(board, k)
    if flip:
        out = out[:, ::-1]
    return np.ascontiguousarray(np.roll(out, (dy, dx), axis=(0, 1)))


def tile(board: np.ndarray, reps: tuple) -> np.ndarray:
    return np.tile(board, reps) if tuple(reps) != (1, 1) else board


def cells_from_alive(alive, height: int, width: int) -> tuple:
    """({0,1} board of an iterable of (x, y) cells, cells out of range or
    repeated)."""
    pts = np.asarray(alive, dtype=np.int64).reshape(-1, 2)
    inside = ((pts[:, 0] >= 0) & (pts[:, 0] < width)
              & (pts[:, 1] >= 0) & (pts[:, 1] < height))
    pts = pts[inside]
    board = np.zeros((height, width), dtype=np.uint8)
    board[pts[:, 1], pts[:, 0]] = 1
    bad = int((~inside).sum()) + len(pts) - int(board.sum())
    return board, bad
