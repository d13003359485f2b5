"""The plain reference of the `sparse-2p20` configuration: Life on a
huge torus as a coordinate list, and the configuration's seed board.

The stepping is the checkout's `tools/sparse_reference.py`, loaded by
path: live cells as int64 keys `y * size + x`, each turn's neighbour
counts from `torch.unique(..., return_counts=True)`, the count at every
turn and the final cells, with no knowledge of packed words, windows or
kernels, and no import of JAX or the program. A checkout without that
file cannot run the configuration: loading this module raises.

`make_board` draws the run's seed board: the configuration's pattern
under one of its 8 rotations and reflections at an offset in the seed
board, both from the seed. `oracle` steps a seed board for the
configuration's turns on the host (the list holds a few hundred keys; a
turn is a handful of small operations, which a card would only launch).
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

_TOOLS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tools", "sparse_reference.py")


def _load_tools():
    spec = importlib.util.spec_from_file_location("sparse_reference", _TOOLS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


coords = _load_tools()


def oriented(rows, sym: int) -> np.ndarray:
    """A pattern under symmetry `sym` of 8: `sym % 4` counterclockwise
    quarter turns (`np.rot90`), then, for `sym >= 4`, its columns
    reversed."""
    pat = np.rot90(coords.rows_board(rows), sym % 4)
    return pat[:, ::-1] if sym >= 4 else pat


def make_board(cfg: dict, rng, root: str = "") -> np.ndarray:
    """A {0, 1} seed board of `cfg["seed_board"]` = [height, width]:
    `cfg["pattern"]["rows"]` under a seeded rotation or reflection, at a
    seeded offset."""
    pat = oriented(cfg["pattern"]["rows"], int(rng.integers(8)))
    ph, pw = pat.shape
    h0, w0 = cfg["seed_board"]
    oy, ox = int(rng.integers(h0 - ph + 1)), int(rng.integers(w0 - pw + 1))
    board = np.zeros((h0, w0), dtype=np.uint8)
    board[oy:oy + ph, ox:ox + pw] = pat
    return board


def oracle(board: np.ndarray, cfg: dict, device=None):
    """The seed board's history (`coords.History`) on the configuration's
    torus for its turns, on the host whatever `device` the run used."""
    return coords.History(board, int(cfg["width"]), int(cfg["turns"]),
                          cfg["rule"])
