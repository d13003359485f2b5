"""Life-like cellular automaton rule family (a copy of
`gol_tpu/models/lifelike.py`, so the port never imports the JAX package).

Any outer-totalistic life-like rule "B{digits}/S{digits}" is two 9-entry
lookup tables (born-by-neighbour-count, survive-by-neighbour-count). The
Hopper kernels take them as two 9-bit masks (`masks`), so one build of
the kernels serves every rule in the family.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Tuple

_RULE_RE = re.compile(r"^B(?P<b>[0-8]*)/S(?P<s>[0-8]*)$")


@dataclasses.dataclass(frozen=True)
class LifeLikeRule:
    """An outer-totalistic rule, hashable so it can be a jit static arg."""

    rulestring: str = "B3/S23"

    def __post_init__(self) -> None:
        m = _RULE_RE.match(self.rulestring)
        if m is None:
            raise ValueError(
                f"bad rulestring {self.rulestring!r}; want e.g. 'B3/S23'"
            )
        # Canonicalize (sorted, deduplicated digits) so semantically equal
        # rules compare/hash equal — 'B3/S32' IS Conway, and equality is
        # what gates engine reuse and checkpoint-rule guards.
        canon = (f"B{''.join(sorted(set(m.group('b'))))}"
                 f"/S{''.join(sorted(set(m.group('s'))))}")
        object.__setattr__(self, "rulestring", canon)

    @property
    def born(self) -> frozenset:
        m = _RULE_RE.match(self.rulestring)
        return frozenset(int(c) for c in m.group("b"))

    @property
    def survive(self) -> frozenset:
        m = _RULE_RE.match(self.rulestring)
        return frozenset(int(c) for c in m.group("s"))

    def luts(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(born_lut, survive_lut): 9-tuples of 0/1 indexed by live-neighbour
        count."""
        born = tuple(1 if i in self.born else 0 for i in range(9))
        survive = tuple(1 if i in self.survive else 0 for i in range(9))
        return born, survive

    def masks(self) -> Tuple[int, int]:
        """(born_mask, survive_mask): bit i set iff a cell with i live
        neighbours is born / survives — the kernels' rule arguments."""
        return (sum(1 << i for i in self.born),
                sum(1 << i for i in self.survive))

    @property
    def is_conway(self) -> bool:
        return self.born == frozenset({3}) and self.survive == frozenset({2, 3})


CONWAY = LifeLikeRule("B3/S23")
HIGHLIFE = LifeLikeRule("B36/S23")
DAY_AND_NIGHT = LifeLikeRule("B3678/S34678")
SEEDS = LifeLikeRule("B2/S")
