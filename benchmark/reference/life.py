"""Plain reference for life-like rules on a torus, in plain PyTorch, and
the configuration's input board.

It imports nothing of the program. A board here is a (H, W) uint8
array of {0, 1}. `make_board` builds a run's input from the
configuration and the seed; `oracle` gives the `History` of that board:
it steps the whole board until a state repeats, and from the cycle it
answers for any turn: the state and the alive count. Every finite torus
repeats; a board that does not within the configuration's
`cycle_limit` turns raises, and the run that needed it is not judged
correct.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from yardstick import board as bd

# Turns stepped between two looks for a repeated state.
CHECK_EVERY = 32


def parse_rule(rule: str) -> tuple:
    """(birth counts, survival counts) of a "B3/S23" string."""
    born, survive = rule.upper().split("/")
    if not (born.startswith("B") and survive.startswith("S")):
        raise ValueError(f"not a B/S rule: {rule!r}")
    return (frozenset(int(c) for c in born[1:]),
            frozenset(int(c) for c in survive[1:]))


def step(board: torch.Tensor, rule: tuple, wrap: bool = True) -> torch.Tensor:
    """One turn. `wrap=False` treats every cell beyond the edge as dead
    (a plane, not a torus): the control that breaks the torus."""
    if wrap:
        p = torch.cat([board[-1:], board, board[:1]], 0)
        p = torch.cat([p[:, -1:], p, p[:, :1]], 1)
    else:
        p = F.pad(board, (1, 1, 1, 1))
    h, w = board.shape
    n = torch.zeros_like(board)
    for dy in range(3):
        for dx in range(3):
            if dy != 1 or dx != 1:
                n += p[dy:dy + h, dx:dx + w]
    born, survive = rule
    nxt = torch.zeros_like(board, dtype=torch.bool)
    for c in born:
        nxt |= (n == c) & (board == 0)
    for c in survive:
        nxt |= (n == c) & (board == 1)
    return nxt.to(torch.uint8)


def pattern(rows) -> np.ndarray:
    """{0, 1} array of a pattern drawn as strings of "O" (alive) and
    "." (dead)."""
    return np.array([[c == "O" for c in r] for r in rows], dtype=np.uint8)


def make_board(cfg: dict, rng: np.random.Generator, root: str) -> np.ndarray:
    """The run's input: the configuration's `image` under one of the
    torus's rotations and reflections drawn from the seed, tiled
    `tile` times, the `plant` pattern set into one tile drawn from the
    seed, and the whole translated by an amount drawn from the seed.
    The plant sits in the tile's interior, so it stays whole on the
    tiled torus."""
    base = (bd.read_pgm(os.path.join(root, cfg["image"])) != 0).astype(
        np.uint8)
    h, w = base.shape
    k, flip, dy, dx = bd.draw_symmetry(rng, h, w)
    reps = tuple(cfg["tile"])
    ti, tj = int(rng.integers(reps[0])), int(rng.integers(reps[1]))
    planted = base.copy()
    plant = cfg.get("plant")
    if plant:
        p = pattern(plant["rows"])
        y, x = plant["at"]
        if not (0 < y and y + p.shape[0] < h and 0 < x
                and x + p.shape[1] < w):
            raise ValueError("the plant must lie inside the image")
        planted[y:y + p.shape[0], x:x + p.shape[1]] = p
    board = bd.tile(bd.apply_symmetry(base, (k, flip, 0, 0)), reps).copy()
    board[ti * h:(ti + 1) * h, tj * w:(tj + 1) * w] = bd.apply_symmetry(
        planted, (k, flip, 0, 0))
    board = np.roll(board, (dy, dx), axis=(0, 1))
    if board.shape != (cfg["height"], cfg["width"]):
        raise ValueError(f"the board is {board.shape}, the configuration "
                         f"says {(cfg['height'], cfg['width'])}")
    return np.ascontiguousarray(board)


def oracle(board01: np.ndarray, cfg: dict, device="cpu") -> "History":
    """The reference's answers for a run of the configuration on
    `board01`."""
    return History(board01, cfg["rule"], device=device,
                   limit=int(cfg["cycle_limit"]))


class History:
    """The board's alive counts at every turn up to its first repeated
    state, and from there on by its cycle (`t0`, `period`).

    A state is known by a 64-bit hash: the sum, modulo 2**64, of a
    random 64-bit weight for each live cell, taken on the device. Two
    different boards share it with a chance of about 2**-64, so a
    history of 1e5 turns takes a false repeat with a chance below
    1e-9."""

    def __init__(self, board01: np.ndarray, rule: str, device="cpu",
                 limit: int = 200_000, wrap: bool = True) -> None:
        self.rule = parse_rule(rule)
        self.wrap = wrap
        self.device = torch.device(device)
        self.start = torch.from_numpy(
            np.ascontiguousarray(board01, dtype=np.uint8)).to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(0x5EED)
        weights = torch.randint(-2**63, 2**63 - 1, (self.start.numel(),),
                                generator=gen, device=self.device,
                                dtype=torch.int64)
        seen: dict = {}
        counts: list = []
        b, stepped = self.start, 0
        found = None
        while found is None:
            hashes, sums = [], []
            for _ in range(CHECK_EVERY):
                live = b.reshape(-1).to(torch.bool)
                hashes.append(torch.where(live, weights, 0).sum())
                sums.append(live.sum())
                b = step(b, self.rule, wrap)
            for key, n in zip(torch.stack(hashes).tolist(),
                              torch.stack(sums).tolist()):
                t = len(counts)
                if key in seen:
                    found = (seen[key], t)
                    break
                if t > limit:
                    raise RuntimeError(
                        f"no repeated state within {limit} turns")
                seen[key] = t
                counts.append(int(n))
            stepped += CHECK_EVERY
        self.t0, t_rep = found
        self.period = t_rep - self.t0
        self.counts = counts
        # The newest state, at a turn past the cycle's start: the
        # cycle's states follow from it.
        self._last, self._last_turn = b, stepped
        self._cache = None

    def _turn(self, turn: int) -> int:
        if turn < self.t0:
            return turn
        return self.t0 + (turn - self.t0) % self.period

    def count_at(self, turn: int) -> int:
        return self.counts[self._turn(turn)]

    def state_at(self, turn: int) -> np.ndarray:
        """The {0, 1} board at `turn`, on the host."""
        if self._cache is not None and self._cache[0] == turn:
            return self._cache[1]
        if turn >= self.t0:
            b = self._last
            for _ in range((turn - self._last_turn) % self.period):
                b = step(b, self.rule, self.wrap)
        else:
            b = self.start
            for _ in range(turn):
                b = step(b, self.rule, self.wrap)
        out = b.cpu().numpy()
        self._cache = (turn, out)
        return out
