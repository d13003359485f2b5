"""ASCII board rendering for failed-test diagnostics (a copy of
`gol_tpu/utils/visualise.py`).

Counterpart of reference `Local/util/visualise.go:21-108`: renders an
alive-cell list as a boxed ASCII grid, and renders the got-vs-want
side-by-side diff printed when a small-board test fails
(`Local/gol_test.go:45-52`).
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

_ALIVE = "#"
_DEAD = " "


def _to_grid(cells: Iterable[Tuple[int, int]], w: int, h: int) -> np.ndarray:
    grid = np.zeros((h, w), dtype=np.uint8)
    for x, y in cells:
        if not (0 <= x < w and 0 <= y < h):
            # Silently dropping a stray cell would make board_diff hide
            # exactly the boundary off-by-ones it exists to expose.
            raise ValueError(
                f"cell ({x}, {y}) outside {w}x{h} board")
        grid[y, x] = 1
    return grid


def alive_cells_to_string(
    cells: Iterable[Tuple[int, int]], w: int, h: int
) -> str:
    """Boxed ASCII rendering of an alive-cell list
    (reference `visualise.go:21-48`)."""
    grid = _to_grid(cells, w, h)
    top = "┌" + "─" * w + "┐"
    bottom = "└" + "─" * w + "┘"
    rows = [
        "│" + "".join(_ALIVE if v else _DEAD for v in row) + "│"
        for row in grid
    ]
    return "\n".join([top, *rows, bottom])


def board_to_string(board: np.ndarray) -> str:
    h, w = board.shape
    ys, xs = np.nonzero(board)
    return alive_cells_to_string(zip(xs.tolist(), ys.tolist()), w, h)


def board_diff(
    got: Sequence[Tuple[int, int]],
    want: Sequence[Tuple[int, int]],
    w: int,
    h: int,
) -> str:
    """Side-by-side got/want rendering with a mismatch mask, the small-board
    failure report of the reference (`visualise.go:50-108`)."""
    g = _to_grid(got, w, h)
    e = _to_grid(want, w, h)
    bad = g != e
    lines = [f"{'got':^{w + 2}} {'want':^{w + 2}} {'diff':^{w + 2}}"]
    lines.append(("┌" + "─" * w + "┐ ") * 3)
    for y in range(h):
        row_g = "".join(_ALIVE if v else _DEAD for v in g[y])
        row_e = "".join(_ALIVE if v else _DEAD for v in e[y])
        row_d = "".join("X" if v else _DEAD for v in bad[y])
        lines.append(f"│{row_g}│ │{row_e}│ │{row_d}│")
    lines.append(("└" + "─" * w + "┘ ") * 3)
    return "\n".join(lines)
