"""What the flows' comparisons share: the numbers compared, each with
its limit, and cell-by-cell comparisons of a board. Life's answers are
exact, so each number is a count of wrong answers or cells, and its
limit is 0."""

from __future__ import annotations

import numpy as np

from yardstick import board as bd


class Checks:
    """Numbers compared, each with its limit, in the order added."""

    def __init__(self) -> None:
        self.items: dict = {}
        self.answers = 0  # answers compared
        self.attempted = 0
        self.failed = 0

    def add(self, name: str, value, limit=0) -> None:
        self.items[name] = {"value": value, "limit": limit}

    @property
    def correct(self) -> bool:
        return self.answers > 0 and all(
            v["value"] <= v["limit"] for v in self.items.values())


def cells_wrong_alive(alive, want: np.ndarray) -> int:
    """Cells where a list of alive (x, y) cells and the reference
    differ, entries out of range or repeated counted too."""
    got, bad = bd.cells_from_alive(alive, *want.shape)
    return int((got != want).sum()) + bad


def cells_wrong_pgm(path, want: np.ndarray) -> int:
    """Cells where the PGM on disk differs from the reference; every
    cell when it is missing or malformed."""
    try:
        pix = bd.read_pgm(path)
    except (OSError, ValueError, TypeError):
        return int(want.size)
    if pix.shape != want.shape:
        return int(want.size)
    return int(((pix != 0) & (pix != 255)).sum()
               + ((pix == 255) != (want == 1)).sum())
