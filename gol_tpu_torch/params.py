"""Run parameters (a copy of `gol_tpu/params.py`).

Mirrors the reference `gol.Params` struct (`Local/gol/gol.go:4-10`): the
one config object, forwarded verbatim from CLI to engine. `threads` is
kept for API parity with the reference's per-worker fan-out; the port
runs one device, so it is validated and otherwise unused.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Params:
    threads: int = 8
    image_width: int = 512
    image_height: int = 512
    turns: int = 100

    def __post_init__(self) -> None:
        if self.image_width <= 0 or self.image_height <= 0:
            raise ValueError(
                f"board must be non-empty, got "
                f"{self.image_width}x{self.image_height}"
            )
        if self.turns < 0:
            raise ValueError(f"turns must be >= 0, got {self.turns}")
        if self.threads <= 0:
            raise ValueError(f"threads must be >= 1, got {self.threads}")
