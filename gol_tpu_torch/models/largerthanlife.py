"""Larger-than-Life / HROT family — life-like rules at radius > 1 (a copy
of `gol_tpu/models/largerthanlife.py`, so the port never imports the JAX
package).

The first family to need the conv/FFT kernel tier (`ops/conv.py`): a
cell's fate depends on the population of a radius-r neighborhood
(box, diamond, or disc — up to (2r+1)² − 1 = 4224 neighbors at r=32),
far beyond the radius-1 bitplane kernels. The update is still an
integer threshold: birth when a dead cell's count falls in any B
range, survival when a live cell's count (including itself iff M1)
falls in any S range.

Rulestring format is Golly's Larger-than-Life form, comma-separated
tokens in canonical order:

    R<r>,C<states>,M<0|1>,S<ranges>,B<ranges>[,N<M|N|C>]

e.g. Bosco's Rule ``R5,C0,M1,S33..57,B34..45,NM``. `C` must encode a
2-state rule (0 or 2 — the multi-state HROT decay chain belongs to
the Generations family, not here). A <ranges> token is one or more
``lo..hi`` spans (or single counts) joined by ``+`` — the HROT
multi-range extension without colliding with the comma separator.
Neighborhoods: NM Moore box (default), NN von Neumann diamond,
NC circular (dy² + dx² <= r²).

Every torch update dispatches through a kernel tier (`ops/conv.py`; the
Moore box on the card runs kernel K7); `step_np` is the independent
numpy oracle (summed-area table for boxes, direct tap accumulation
otherwise) that the tests and `chip_smoke.py` gate bit-identical
against.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Tuple

import numpy as np

_TOKEN_RE = re.compile(
    r"^R(?P<r>\d+),C(?P<c>\d+),M(?P<m>[01]),"
    r"S(?P<s>[0-9.+]*),B(?P<b>[0-9.+]*)(?:,N(?P<n>[MNC]))?$")


def _parse_ranges(token: str, limit: int) -> Tuple[Tuple[int, int], ...]:
    """'33..57+60' -> ((33, 57), (60, 60)), validated against the
    neighborhood size and canonically sorted/merged."""
    if not token:
        return ()
    spans = []
    for part in token.split("+"):
        if ".." in part:
            lo_s, hi_s = part.split("..", 1)
        else:
            lo_s = hi_s = part
        if not lo_s.isdigit() or not hi_s.isdigit():
            raise ValueError(f"bad count range {part!r}")
        lo, hi = int(lo_s), int(hi_s)
        if lo > hi:
            raise ValueError(f"empty count range {part!r}")
        if hi > limit:
            raise ValueError(
                f"count range {part!r} exceeds the neighborhood "
                f"size {limit}")
        spans.append((lo, hi))
    spans.sort()
    merged = [spans[0]]
    for lo, hi in spans[1:]:
        if lo <= merged[-1][1] + 1:
            merged[-1] = (merged[-1][0], max(hi, merged[-1][1]))
        else:
            merged.append((lo, hi))
    return tuple(merged)


def _fmt_ranges(spans: Tuple[Tuple[int, int], ...]) -> str:
    return "+".join(f"{lo}..{hi}" if lo != hi else f"{lo}"
                    for lo, hi in spans)


@dataclasses.dataclass(frozen=True)
class LargerThanLifeRule:
    """Canonicalised, hashable LtL rule."""

    rulestring: str = "R5,C0,M1,S33..57,B34..45,NM"  # Bosco's Rule

    def __post_init__(self) -> None:
        m = _TOKEN_RE.match(self.rulestring.strip())
        if m is None:
            raise ValueError(
                f"bad Larger-than-Life rulestring {self.rulestring!r}; "
                "want 'R<r>,C<c>,M<0|1>,S<ranges>,B<ranges>[,N<M|N|C>]' "
                "e.g. 'R5,C0,M1,S33..57,B34..45,NM'")
        r = int(m.group("r"))
        if not 1 <= r <= 128:
            raise ValueError(f"radius {r} out of range 1..128")
        c = int(m.group("c"))
        if c not in (0, 2):
            raise ValueError(
                f"C{c}: only 2-state LtL rules here (decaying "
                "multi-state chains are the Generations family)")
        kind = m.group("n") or "M"
        middle = m.group("m") == "1"
        # Neighborhood size bounds the meaningful count values; the
        # survival count includes the center iff M1.
        area = int(_kind_mask(r, kind).sum())
        s = _parse_ranges(m.group("s"), area - 1 + (1 if middle else 0))
        b = _parse_ranges(m.group("b"), area - 1)
        canon = (f"R{r},C0,M{1 if middle else 0},"
                 f"S{_fmt_ranges(s)},B{_fmt_ranges(b)},N{kind}")
        object.__setattr__(self, "rulestring", canon)

    # Parsed views (recomputed from the canonical string — the
    # dataclass stays a single hashable field, like LifeLikeRule).

    @property
    def _groups(self):
        return _TOKEN_RE.match(self.rulestring).groupdict()

    @property
    def radius(self) -> int:
        return int(self._groups["r"])

    @property
    def middle(self) -> bool:
        return self._groups["m"] == "1"

    @property
    def kind(self) -> str:
        return self._groups["n"] or "M"

    @property
    def survive_ranges(self) -> Tuple[Tuple[int, int], ...]:
        return _parse_ranges(self._groups["s"], 1 << 30)

    @property
    def born_ranges(self) -> Tuple[Tuple[int, int], ...]:
        return _parse_ranges(self._groups["b"], 1 << 30)

    @property
    def kernel_key(self):
        """Hashable kernel description for `ops/conv.kernel_from_key`:
        the counted neighborhood INCLUDES the center iff M1 (a dead
        cell contributes 0 there, so birth counts are unchanged)."""
        return ("ltl", self.radius, self.kind, self.middle)

    def neighborhood_size(self) -> int:
        """Number of counted cells (center included iff M1)."""
        kern = _kind_mask(self.radius, self.kind)
        return int(kern.sum()) - (0 if self.middle else 1)

    def luts(self) -> Tuple[np.ndarray, np.ndarray]:
        """(survive_lut, born_lut): uint8 {0,1} tables indexed by the
        neighborhood count, length neighborhood_size() + 1."""
        n = self.neighborhood_size() + 1
        survive = np.zeros(n, dtype=np.uint8)
        born = np.zeros(n, dtype=np.uint8)
        for lo, hi in self.survive_ranges:
            survive[lo:min(hi, n - 1) + 1] = 1
        for lo, hi in self.born_ranges:
            born[lo:min(hi, n - 1) + 1] = 1
        return survive, born


def _kind_mask(r: int, kind: str) -> np.ndarray:
    """Full neighborhood mask INCLUDING the center (bool)."""
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    if kind == "M":
        return np.ones((2 * r + 1, 2 * r + 1), dtype=bool)
    if kind == "N":
        return (np.abs(dy) + np.abs(dx)) <= r
    if kind == "C":
        return (dy * dy + dx * dx) <= r * r
    raise ValueError(f"unknown neighborhood kind {kind!r}")


BOSCO = LargerThanLifeRule("R5,C0,M1,S33..57,B34..45,NM")
# Conway as an LtL rule (R1, Moore, center-exclusive) — the family
# cross-check the tests exploit: B3/S23 == R1,C0,M0,S2..3,B3,NM.
CONWAY_LTL = LargerThanLifeRule("R1,C0,M0,S2..3,B3,NM")
# "Majority" voting rule at r=4: smooth blob dynamics, exercises M1
# (a dead cell sees at most 80 of the 81-cell box, hence B's ceiling).
MAJORITY_R4 = LargerThanLifeRule("R4,C0,M1,S41..81,B41..80,NM")


def step_np(board: np.ndarray, rule: LargerThanLifeRule) -> np.ndarray:
    """Independent numpy oracle for one LtL turn on a {0,1} board —
    shares NO code with the torch tiers (summed-area table for Moore
    boxes, direct np.roll tap accumulation for diamond/disc)."""
    from gol_tpu_torch.ops.conv import box_counts_np, counts_np
    from gol_tpu_torch.ops.conv import neighborhood_kernel

    board = np.asarray(board, dtype=np.uint8)
    if rule.kind == "M":
        counts = box_counts_np(board, rule.radius, middle=rule.middle)
    else:
        kern = neighborhood_kernel(rule.radius, rule.kind, rule.middle)
        counts = np.rint(counts_np(board, kern)).astype(np.int64)
    survive, born = rule.luts()
    counts = np.clip(counts, 0, len(survive) - 1)
    return np.where(board == 1, survive[counts],
                    born[counts]).astype(np.uint8)


def run_turns_np(board: np.ndarray, turns: int,
                 rule: LargerThanLifeRule) -> np.ndarray:
    out = np.asarray(board, dtype=np.uint8)
    for _ in range(int(turns)):
        out = step_np(out, rule)
    return out
