"""Cell type and PGM→alive-cell-list parsing (a copy of
`gol_tpu/utils/cell.py`).

Test-support counterpart of reference `Local/util/cell.go:10-56`:
`Cell{X, Y}` with X = column, Y = row, and `ReadAliveCells` which parses a
P5 PGM into the unordered set of alive cells (value 255).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class Cell(NamedTuple):
    x: int  # column
    y: int  # row

    def __str__(self) -> str:
        return f"({self.x}, {self.y})"


def alive_cells_from_board(board: np.ndarray) -> List[Cell]:
    """Alive cells of an (H, W) board of {0, 255} (or {0, 1}) uint8, in
    row-major order; consumers treat the result as an unordered set."""
    ys, xs = np.nonzero(board)
    return [Cell(int(x), int(y)) for x, y in zip(xs, ys)]


def read_alive_cells(path: str, width: int, height: int) -> List[Cell]:
    """Parse a P5 PGM into its alive-cell list, checking the header's
    dimensions against the caller's expectation."""
    from gol_tpu_torch.io.pgm import read_pgm

    board = read_pgm(path)
    h, w = board.shape
    if (w, h) != (width, height):
        raise ValueError(
            f"{path}: header says {w}x{h}, expected {width}x{height}"
        )
    return alive_cells_from_board(board)
