"""Run Length Encoded (RLE) pattern format — the Life community's
standard interchange format (conwaylife.com wiki spec); a copy of
`gol_tpu/io/rle.py`. Beyond-reference capability: the Go system only
reads/writes its PGM board dumps (`Local/gol/io.go:42-121`); RLE lets the
CLI seed the dense engine with any published pattern (`--rle`).

Format: optional `#`-prefixed comment lines; a header
`x = <w>, y = <h>[, rule = B…/S…]`; then runs of `b` (dead), `o` (alive)
and `$` (end of row) with optional run counts, terminated by `!`.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

from gol_tpu_torch.models.lifelike import LifeLikeRule

_HEADER_RE = re.compile(
    r"^x\s*=\s*(?P<x>\d+)\s*,\s*y\s*=\s*(?P<y>\d+)"
    r"(?:\s*,\s*rule\s*=\s*(?P<rule>[BbSs0-8/]+))?\s*$"
)


class RleError(ValueError):
    pass


def _parse_rule(rs: str) -> LifeLikeRule:
    """Rule from an RLE header: 'B3/S23', 'S23/B3', or the traditional
    letterless 'survival/birth' form '23/3'. Anything else → RleError."""
    rs = rs.upper()
    parts = rs.split("/")
    if "B" in rs or "S" in rs:
        b = next((p[1:] for p in parts if p.startswith("B")), None)
        s = next((p[1:] for p in parts if p.startswith("S")), None)
        if b is None or s is None or len(parts) != 2:
            raise RleError(f"bad RLE rule {rs!r}")
    else:
        if len(parts) != 2:
            raise RleError(f"bad RLE rule {rs!r}")
        s, b = parts  # traditional order is survival/birth
    try:
        return LifeLikeRule(f"B{b}/S{s}")
    except ValueError as e:
        raise RleError(f"bad RLE rule {rs!r}: {e}") from e


def parse_rle(
    text: str,
) -> Tuple[List[Tuple[int, int]], int, int, Optional[LifeLikeRule]]:
    """Parse RLE text → (alive cells as (x, y), width, height, rule).

    `rule` is None when the header omits it. Cells outside the declared
    extent, missing terminators, and unknown tags raise RleError."""
    header = None
    data_lines: List[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if header is None:
            m = _HEADER_RE.match(line)
            if m is None:
                raise RleError(f"bad RLE header line: {line!r}")
            header = m
            continue
        data_lines.append(line)
    if header is None:
        raise RleError("no RLE header ('x = …, y = …') found")
    width, height = int(header.group("x")), int(header.group("y"))
    rule = None
    if header.group("rule"):
        rule = _parse_rule(header.group("rule"))

    cells: List[Tuple[int, int]] = []
    x = y = 0
    run = 0
    done = False
    for line in data_lines:
        if done:
            break
        for ch in line:
            if done:
                break
            if ch.isdigit():
                run = run * 10 + int(ch)
            elif ch in "bo":
                n = run or 1
                if ch == "o":
                    cells.extend((x + i, y) for i in range(n))
                x += n
                run = 0
            elif ch == "$":
                y += (run or 1)
                x = 0
                run = 0
            elif ch == "!":
                done = True
            elif ch.isspace():
                continue
            else:
                raise RleError(f"unknown RLE tag {ch!r}")
    if not done:
        raise RleError("RLE data not terminated with '!'")
    for cx, cy in cells:
        if cx >= width or cy >= height:
            raise RleError(
                f"cell ({cx}, {cy}) outside declared {width}x{height}")
    return cells, width, height, rule


def read_rle(path: str):
    with open(path, "r", encoding="utf-8") as f:
        return parse_rle(f.read())


def rle_board(text: str) -> np.ndarray:
    """RLE text → dense {0,1} uint8 board of the declared extent."""
    cells, w, h, _ = parse_rle(text)
    board = np.zeros((h, w), dtype=np.uint8)
    for x, y in cells:
        board[y, x] = 1
    return board


def to_rle(board: np.ndarray, rule: Optional[LifeLikeRule] = None) -> str:
    """Dense {0,1} board → RLE text (round-trips through parse_rle)."""
    h, w = board.shape
    rule_part = f", rule = {rule.rulestring}" if rule is not None else ""
    out = [f"x = {w}, y = {h}{rule_part}"]
    if h == 0 or w == 0:
        return "\n".join(out + ["!"]) + "\n"
    runs: List[str] = []

    def emit(n: int, tag: str) -> None:
        if n <= 0:
            return
        runs.append((str(n) if n > 1 else "") + tag)

    for y in range(h):
        row = board[y]
        x = 0
        while x < w:
            v = row[x]
            n = 1
            while x + n < w and row[x + n] == v:
                n += 1
            # trailing dead cells in a row are implicit
            if v or x + n < w:
                emit(n, "o" if v else "b")
            x += n
        emit(1, "$") if y + 1 < h else emit(1, "!")
    # wrap data at ≤70 chars per the spec
    lines, cur = [], ""
    for r in runs:
        if len(cur) + len(r) > 70:
            lines.append(cur)
            cur = ""
        cur += r
    lines.append(cur)
    out.extend(lines)
    return "\n".join(out) + "\n"
