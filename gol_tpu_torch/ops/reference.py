"""Independent numpy oracle (a copy of `gol_tpu/ops/reference.py`) used
only to generate/verify golden fixtures.

Deliberately structured differently from the kernels (explicit padded
window slicing rather than roll-sums or bit-planes) so a bug in one is
unlikely to hide in the other. Golden boards/counts produced by this module play the role of the
reference's committed `Local/check/` fixtures (SURVEY §4 notes they are
regenerable — GoL is deterministic).
"""

from __future__ import annotations

import numpy as np


def step_np(board01: np.ndarray) -> np.ndarray:
    """One torus turn on an (H, W) uint8 {0,1} board."""
    p = np.pad(board01, 1, mode="wrap")
    h, w = board01.shape
    counts = np.zeros((h, w), dtype=np.int32)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            counts += p[dy : dy + h, dx : dx + w]
    alive = board01 == 1
    nxt = np.where(
        alive, (counts == 2) | (counts == 3), counts == 3
    )
    return nxt.astype(np.uint8)


def run_turns_np(board01: np.ndarray, num_turns: int) -> np.ndarray:
    if board01.size and board01.max() > 1:
        # Passing the {0,255} PIXEL format here would sum 255s into the
        # neighbour counts and silently produce an all-dead "golden" —
        # the oracle must fail loudly, never fabricate fixtures.
        raise ValueError(
            f"oracle wants a {{0,1}} board, got max {board01.max()}")
    b = board01.copy()
    for _ in range(num_turns):
        b = step_np(b)
    return b
