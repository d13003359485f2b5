"""Error check helper (a copy of `gol_tpu/utils/check.py`) — counterpart of reference `Local/util/check.go:3-7`
(panic-on-error); in Python we simply raise."""

from __future__ import annotations


def check(condition: bool, message: str = "check failed") -> None:
    if not condition:
        raise RuntimeError(message)
