"""Named pattern library (RLE sources from the public Life lexicon) and
helpers to drop a pattern onto a dense board or a sparse torus (a copy of
`gol_tpu/models/patterns.py`).

Beyond-reference: the Go system ships only PGM board dumps; here any
lexicon pattern loads by name or RLE text. The RLE strings below are the
canonical published encodings of century-old public patterns.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

from gol_tpu_torch.io.rle import parse_rle

GLIDER = """\
x = 3, y = 3
bob$2bo$3o!
"""

LWSS = """\
x = 5, y = 4
bo2bo$o4b$o3bo$4o!
"""

R_PENTOMINO_RLE = """\
x = 3, y = 3
b2o$2o$bo!
"""

GOSPER_GLIDER_GUN = """\
x = 36, y = 9
24bo$22bobo$12b2o6b2o12b2o$11bo3bo4b2o12b2o$2o8bo5bo3b2o$2o8bo3bob2o4\
bobo$10bo5bo7bo$11bo3bo$12b2o!
"""

BLINKER = """\
x = 3, y = 1
3o!
"""

PATTERNS = {
    "glider": GLIDER,
    "lwss": LWSS,
    "rpentomino": R_PENTOMINO_RLE,
    "gosper-gun": GOSPER_GLIDER_GUN,
    "blinker": BLINKER,
}


def pattern_cells(
    name_or_rle: str, at: Tuple[int, int] = (0, 0)
) -> List[Tuple[int, int]]:
    """Alive cells of a named pattern (or raw RLE text), offset by `at`.
    The JAX package's `SparseTorus` takes them as its seed."""
    text = PATTERNS.get(name_or_rle, name_or_rle)
    cells, _, _, _ = parse_rle(text)
    ox, oy = at
    return [(x + ox, y + oy) for x, y in cells]


def stamp(board: np.ndarray, name_or_rle: str,
          at: Tuple[int, int] = (0, 0),
          value: int = 1) -> np.ndarray:
    """Stamp a pattern onto a dense board in place (torus wrap) and
    return it. `value` is 1 for {0,1} boards, 255 for PGM pixels."""
    h, w = board.shape
    for x, y in pattern_cells(name_or_rle, at):
        board[y % h, x % w] = value
    return board
