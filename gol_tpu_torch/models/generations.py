"""Generations cellular-automaton family — multi-state rules such as
Brian's Brain ('/2/3') and Star Wars ('345/2/4') — the counterpart of
`gol_tpu/models/generations.py`.

A Generations cell is 0 (dead), 1 (alive, "firing") or 2..C-1 (dying):
dead cells are born per the birth counts of ALIVE neighbours, alive cells
survive per the survival counts or start dying, dying cells count up each
turn and then die. C = 2 is exactly the life-like family.

Three representations, as in the JAX package:

* gen8: one uint8 state per cell (`run_turns`), plain torch for every C
  and width — the JAX package leaves it to XLA too;
* gen3: two packed planes, alive `a` and dying `d`, for C = 3 on widths
  that are a whole number of 32-cell words;
* gen4: two packed planes holding the state in binary (b0 = bit 0,
  b1 = bit 1; alive = b0 & ~b1), for C = 4 on such widths.

The packed pairs step by the Hopper kernels K4/K5 (`ops/cuda_stencil.py`)
on a CUDA device and by their plain versions on the CPU; the routing by
shape is `parallel/halo.planes_run_kind`. Planes are the int32 carrier of
`ops/bitpack.py`, stacked as one (2, H, W/32) tensor.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Optional, Tuple

import numpy as np
import torch

from gol_tpu_torch.ops.bitpack import (
    gen3_transition,
    gen4_transition,
    neighbour_count_bits,
    pack_np,
    rule_masks,
    unpack_np,
    words_from_numpy,
    words_to_numpy,
)
from gol_tpu_torch.parallel.halo import planes_run_turns

_RULE_RE = re.compile(r"^(?P<s>[0-8]*)/(?P<b>[0-8]*)/(?P<c>\d+)$")


@dataclasses.dataclass(frozen=True)
class GenerationsRule:
    """'survival/birth/states' rule, canonicalised and hashable."""

    rulestring: str = "/2/3"  # Brian's Brain

    def __post_init__(self) -> None:
        m = _RULE_RE.match(self.rulestring)
        if m is None:
            raise ValueError(
                f"bad Generations rulestring {self.rulestring!r}; "
                "want 'survival/birth/states', e.g. '/2/3'")
        c = int(m.group("c"))
        if c < 2:
            raise ValueError(f"need at least 2 states, got {c}")
        if c > 256:
            # States live in uint8 boards; a dying counter past 255
            # would wrap and kill cells at the wrong turn.
            raise ValueError(f"at most 256 states, got {c}")
        canon = (f"{''.join(sorted(set(m.group('s'))))}/"
                 f"{''.join(sorted(set(m.group('b'))))}/{c}")
        object.__setattr__(self, "rulestring", canon)

    @property
    def survive(self) -> frozenset:
        return frozenset(int(ch) for ch in self.rulestring.split("/")[0])

    @property
    def born(self) -> frozenset:
        return frozenset(int(ch) for ch in self.rulestring.split("/")[1])

    @property
    def states(self) -> int:
        return int(self.rulestring.split("/")[2])

    def masks(self) -> Tuple[int, int]:
        """(born_mask, survive_mask): bit i set iff a dead cell with i
        alive neighbours is born / an alive one survives — the kernels'
        rule arguments, as `LifeLikeRule.masks`."""
        return (sum(1 << i for i in self.born),
                sum(1 << i for i in self.survive))


BRIANS_BRAIN = GenerationsRule("/2/3")
STAR_WARS = GenerationsRule("345/2/4")


# ------------------------------------------------------- pixel encoding
#
# dead = 0, alive = 255 (so a {0,255} life PGM seeds alive cells), and
# dying states fade toward black: gray(s) = 255 - (s-1)*255 // (C-1) for
# s >= 2. The levels are distinct for every C <= 256.


def gray_levels(rule: GenerationsRule) -> np.ndarray:
    """(states,) uint8: the gray value encoding each state."""
    c = rule.states
    levels = np.zeros(c, dtype=np.uint8)
    levels[1] = 255
    for s in range(2, c):
        levels[s] = 255 - ((s - 1) * 255) // (c - 1)
    return levels


def to_pixels_gen(state: np.ndarray, rule: GenerationsRule) -> np.ndarray:
    """uint8 state board -> gray pixel board (host)."""
    return gray_levels(rule)[np.asarray(state)]


def from_pixels_gen(pixels: np.ndarray,
                    rule: GenerationsRule) -> np.ndarray:
    """Gray pixel board -> uint8 state board (host); rejects gray values
    that encode no state of the rule."""
    levels = gray_levels(rule)
    inverse = np.full(256, 255, dtype=np.uint8)  # 255 = invalid marker
    inverse[levels] = np.arange(rule.states, dtype=np.uint8)
    state = inverse[np.asarray(pixels, dtype=np.uint8)]
    # With 256 states every byte is a level and 255 is a real state.
    bad = (state == 255) if rule.states <= 255 else np.zeros(1, bool)
    if bad.any():
        vals = sorted(set(np.asarray(pixels)[bad].tolist()))[:8]
        raise ValueError(
            f"pixels contain gray values {vals} that encode no state of "
            f"{rule.rulestring} (levels: {levels.tolist()})")
    return state


# ------------------------------------------------------------ gen8 path


@functools.lru_cache(maxsize=64)
def rule_luts(rule: GenerationsRule,
              device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(born_lut, surv_lut): (9,) uint8 tables on `device`, 1 where a
    neighbour count births (survives). Built once per rule and device:
    a table built per turn is a copy from pageable host memory, which
    blocks the host behind the kernels already queued."""
    born = [1 if i in rule.born else 0 for i in range(9)]
    surv = [1 if i in rule.survive else 0 for i in range(9)]
    return (torch.tensor(born, dtype=torch.uint8, device=device),
            torch.tensor(surv, dtype=torch.uint8, device=device))


def apply_generations_rule(state: torch.Tensor, n: torch.Tensor,
                           rule: GenerationsRule,
                           luts: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None
                           ) -> torch.Tensor:
    """The transition given the 8-neighbour ALIVE counts `n`: dead -> 1
    if born; alive -> 1 if surviving else the first dying state (death
    for C == 2); dying -> next state, death after C-1. `luts` are
    `rule_luts(rule, state.device)`, looked up when not given.

    Equality form in uint8: `state + 1 < c` would break at c == 256
    (uint8 255 + 1 wraps to 0); valid states are < c, so `state + 1` in
    the branch taken never wraps."""
    born_lut, surv_lut = (luts if luts is not None
                          else rule_luts(rule, state.device))
    c = rule.states
    idx = n.long()  # a uint8 index would be read as a mask
    zero = torch.zeros_like(state)
    dying_next = torch.where(state == c - 1, zero, state + 1)
    alive_next = torch.where(surv_lut[idx] == 1, zero + 1, zero + 2 % c)
    return torch.where(state == 0, born_lut[idx],
                       torch.where(state == 1, alive_next, dying_next))


def state_alive_count(state: torch.Tensor) -> int:
    """Cells in state 1 (the firing population): per-row int32 sums,
    summed in int64 (a flat int32 sum would wrap past 2^31 cells)."""
    rows = (state == 1).sum(dim=-1, dtype=torch.int32)
    return int(rows.sum(dtype=torch.int64))


def _step(state: torch.Tensor, rule: GenerationsRule,
          luts: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """One torus turn of an (H, W) uint8 state board."""
    alive = (state == 1).to(torch.uint8)
    vert = (torch.roll(alive, 1, dims=0) + alive
            + torch.roll(alive, -1, dims=0))
    n = (vert + torch.roll(vert, 1, dims=1) + torch.roll(vert, -1, dims=1)
         - alive)
    return apply_generations_rule(state, n, rule, luts)


def run_turns(state: torch.Tensor, num_turns: int,
              rule: GenerationsRule) -> torch.Tensor:
    """Advance a uint8 state board `num_turns` turns."""
    luts = rule_luts(rule, state.device)
    for _ in range(num_turns):
        state = _step(state, rule, luts)
    return state


# ------------------------------------------------------ packed C = 3, 4
#
# C = 3 planes: a = alive, d = dying. Counts are of the alive plane only:
#     a' = (~a & ~d & born(n)) | (a & survive(n));  d' = a & ~survive(n)
# C = 4 planes: binary states (alive = b0 & ~b1), dying chain 2 -> 3 -> 0:
#     b0' = (dead & born(n)) | (alive & survive(n)) | dying1
#     b1' = (alive & ~survive(n)) | dying1            (dying1 = ~b0 & b1)


def _packed_step3(a: torch.Tensor, d: torch.Tensor, rule: GenerationsRule):
    n0, n1, n2, n3 = neighbour_count_bits(
        torch.roll(a, 1, dims=-2), a, torch.roll(a, -1, dims=-2))
    born, surv = rule_masks(n0, n1, n2, n3, rule.born, rule.survive)
    return gen3_transition(a, d, born, surv)


def _packed_run_turns3_scan(a, d, num_turns: int, rule: GenerationsRule):
    """The two-plane scan: one `_packed_step3` per turn."""
    for _ in range(num_turns):
        a, d = _packed_step3(a, d, rule)
    return a, d


def _packed_step4(b0: torch.Tensor, b1: torch.Tensor,
                  rule: GenerationsRule):
    a = b0 & ~b1
    n0, n1, n2, n3 = neighbour_count_bits(
        torch.roll(a, 1, dims=-2), a, torch.roll(a, -1, dims=-2))
    born, surv = rule_masks(n0, n1, n2, n3, rule.born, rule.survive)
    return gen4_transition(b0, b1, born, surv)


def _packed_run_turns4_scan(b0, b1, num_turns: int, rule: GenerationsRule):
    for _ in range(num_turns):
        b0, b1 = _packed_step4(b0, b1, rule)
    return b0, b1


def _dispatch_two_planes(p0, p1, num_turns: int, rule, family: str):
    """Stack the planes and step them by the kernel their shape selects
    (`parallel/halo.planes_run_kind`): K4 when both planes fit one
    block's shared memory, else K5 sweeps. Every shape has a kernel, so
    the TPU's platform and wp >= 2 gates have no counterpart."""
    if num_turns == 0:
        return p0, p1
    out = planes_run_turns(torch.stack([p0, p1]), num_turns, rule, family)
    return out[0], out[1]


def packed_run_turns3(a, d, num_turns: int, rule: GenerationsRule):
    """Advance packed (alive, dying) planes `num_turns` turns."""
    return _dispatch_two_planes(a, d, num_turns, rule, "gen3")


def packed_run_turns4(b0, b1, num_turns: int, rule: GenerationsRule):
    """Advance binary-encoded 4-state planes `num_turns` turns."""
    return _dispatch_two_planes(b0, b1, num_turns, rule, "gen4")


def pack_state4(state: np.ndarray, device="cpu"):
    """uint8 4-state board -> (b0, b1) packed int32 planes on `device`."""
    s = np.asarray(state, dtype=np.uint8)
    return (words_from_numpy(pack_np(s & 1), device),
            words_from_numpy(pack_np((s >> 1) & 1), device))


def unpack_state4(b0: torch.Tensor, b1: torch.Tensor) -> np.ndarray:
    """(b0, b1) packed planes -> uint8 4-state board on the host."""
    return (unpack_np(words_to_numpy(b0))
            + 2 * unpack_np(words_to_numpy(b1))).astype(np.uint8)


def pack_state3(state: np.ndarray, device="cpu") -> torch.Tensor:
    """uint8 3-state board -> stacked (alive, dying) planes
    (2, H, W/32) on `device`."""
    s = np.asarray(state, dtype=np.uint8)
    return words_from_numpy(np.stack([pack_np(s == 1), pack_np(s == 2)]),
                            device)


class GenerationsTorus:
    """A multi-state board on a torus with the macro-run surface of the
    JAX package's (`run`, `board`, `alive_count`, `turn`). Three- and
    four-state rules on 32-aligned widths run as packed planes through
    K4/K5; every other configuration runs the uint8 gen8 path.

    `device` is explicit: None means CUDA and raises without it."""

    def __init__(self, board: np.ndarray,
                 rule: GenerationsRule = BRIANS_BRAIN,
                 device=None) -> None:
        from gol_tpu_torch.engine import resolve_device

        board = np.asarray(board, dtype=np.uint8)
        if board.ndim != 2:
            raise ValueError("board must be 2-D")
        if int(board.max(initial=0)) >= rule.states:
            raise ValueError(
                f"board has states >= {rule.states} ({rule.rulestring})")
        self.device = resolve_device(device)
        self.rule = rule
        self.turn = 0
        aligned = board.shape[1] % 32 == 0
        self._packed = rule.states == 3 and aligned
        self._packed4 = rule.states == 4 and aligned
        if self._packed:
            self._planes = pack_state3(board, self.device)
        elif self._packed4:
            self._planes = torch.stack(pack_state4(board, self.device))
        else:
            self._state = torch.from_numpy(board.copy()).to(self.device)

    def run(self, turns: int) -> None:
        if self._packed or self._packed4:
            self._planes = planes_run_turns(
                self._planes, turns, self.rule,
                "gen3" if self._packed else "gen4")
        else:
            self._state = run_turns(self._state, turns, self.rule)
        self.turn += turns

    @property
    def board(self) -> np.ndarray:
        if self._packed:
            a, d = (unpack_np(words_to_numpy(p)) for p in self._planes)
            return (a + 2 * d).astype(np.uint8)
        if self._packed4:
            return unpack_state4(self._planes[0], self._planes[1])
        return self._state.cpu().numpy()

    def alive_count(self) -> int:
        """Cells in state 1 (the firing population)."""
        from gol_tpu_torch.ops.bitpack import packed_alive_count

        if self._packed:
            return packed_alive_count(self._planes[0])
        if self._packed4:
            return packed_alive_count(self._planes[0] & ~self._planes[1])
        return state_alive_count(self._state)
