"""Plain reference of a Life-like rule on a huge torus: a coordinate list.

The live cells are int64 keys `y * size + x`. Each turn every live cell
offers itself and its eight neighbours (offsets taken mod `size`), and
`torch.unique(..., return_counts=True)` counts how often each key was
offered: a key's count is its live neighbours, plus one if it is alive.
The rule's birth and survival sets then pick the next live keys. The
reference records the live count at every turn and the final cells; it
knows nothing of packed words, windows or kernels, and imports neither
JAX nor either package of this repository.

A seed board (an (h0, w0) array whose non-zero cells live) is stamped as
the sparse engine's contract says: centred, its cell (0, 0) at torus
cell ((size - w0) // 2, (size - h0) // 2).

    python tools/sparse_reference.py --size 1048576 --turns 1200
        # the R-pentomino: its count at every 100th turn and at the end

`benchmark/reference/sparse.py` loads this file by path and adds the
benchmark's `make_board` and `oracle`.
"""

from __future__ import annotations

import argparse
import re
import sys
import time

import numpy as np
import torch

# The R-pentomino, rows of a 3 x 3 box ('O' lives).
R_PENTOMINO_ROWS = (".OO", "OO.", ".O.")

_DY = torch.tensor([-1, -1, -1, 0, 0, 0, 1, 1, 1], dtype=torch.int64)
_DX = torch.tensor([-1, 0, 1, -1, 0, 1, -1, 0, 1], dtype=torch.int64)


def parse_rule(rule: str) -> tuple:
    """(birth counts, survival counts) of a rulestring "B3/S23"."""
    m = re.fullmatch(r"B([0-8]*)/S([0-8]*)", rule.strip(), re.IGNORECASE)
    if m is None:
        raise ValueError(f"not a B/S rulestring: {rule!r}")
    born, survive = ({int(c) for c in g} for g in m.groups())
    if 0 in born:
        raise ValueError("a rule that births on 0 neighbours fills the "
                         "torus; a coordinate list cannot hold it")
    return born, survive


def rows_board(rows) -> np.ndarray:
    """A {0, 1} uint8 board from rows of '.' and 'O'."""
    return np.array([[c == "O" for c in r] for r in rows], dtype=np.uint8)


def stamp(board: np.ndarray, size: int) -> torch.Tensor:
    """Sorted keys of a seed board's live cells, stamped centred."""
    h0, w0 = board.shape
    ys, xs = np.nonzero(board)
    offx, offy = (size - w0) // 2, (size - h0) // 2
    keys = ((torch.from_numpy(ys.astype(np.int64)) + offy) % size * size
            + (torch.from_numpy(xs.astype(np.int64)) + offx) % size)
    return torch.unique(keys)


def step(keys: torch.Tensor, size: int, born_mask: torch.Tensor,
         survive_mask: torch.Tensor) -> torch.Tensor:
    """One turn of a sorted key list; returns the next sorted key list."""
    if keys.numel() == 0:
        return keys
    y = keys // size
    x = keys % size
    ny = (y.unsqueeze(1) + _DY) % size
    nx = (x.unsqueeze(1) + _DX) % size
    offered, counts = torch.unique((ny * size + nx).reshape(-1),
                                   return_counts=True)
    at = torch.searchsorted(keys, offered).clamp_(max=keys.numel() - 1)
    alive = keys[at] == offered
    neighbours = counts - alive.to(counts.dtype)
    nxt = torch.where(alive, survive_mask[neighbours], born_mask[neighbours])
    return offered[nxt]


class History:
    """A run of the reference: `counts[t]`, the live count after t
    turns, and `final`, the sorted keys after the last turn."""

    def __init__(self, board: np.ndarray, size: int, turns: int,
                 rule: str = "B3/S23") -> None:
        born, survive = parse_rule(rule)
        born_mask = torch.tensor([n in born for n in range(10)])
        survive_mask = torch.tensor([n in survive for n in range(10)])
        self.size, self.turns = size, turns
        keys = stamp(board, size)
        counts = [keys.numel()]
        t0 = time.monotonic()
        # A few hundred keys a turn: one thread beats waking a pool.
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for _ in range(turns):
                keys = step(keys, size, born_mask, survive_mask)
                counts.append(keys.numel())
        finally:
            torch.set_num_threads(threads)
        self.seconds = time.monotonic() - t0
        self.counts = counts
        self.final = keys

    def count_at(self, turn: int) -> int:
        return self.counts[turn]

    def cells(self) -> set:
        """The final live cells as torus (x, y) pairs."""
        k = self.final.tolist()
        return {(v % self.size, v // self.size) for v in k}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1 << 20)
    ap.add_argument("--turns", type=int, default=1200)
    ap.add_argument("--rule", default="B3/S23")
    args = ap.parse_args(argv)
    hist = History(rows_board(R_PENTOMINO_ROWS), args.size, args.turns,
                   args.rule)
    for t in range(0, args.turns + 1, 100):
        print(f"turn {t}: {hist.count_at(t)} cells")
    print(f"turn {args.turns}: {hist.count_at(args.turns)} cells "
          f"({hist.seconds:.2f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
