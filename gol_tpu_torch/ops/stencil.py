"""Whole-board uint8 torus stencil in plain torch — the counterpart of
`gol_tpu/ops/stencil.py`.

Serves boards whose width is not a whole number of 32-cell words (the
16² golden), exactly as the JAX package leaves that path to XLA: there is
no kernel behind it. Boards are uint8 {0,1} ("cells") internally; {0,255}
("pixels") only at the I/O boundary (`from_pixels`/`to_pixels`).
"""

from __future__ import annotations

import torch

from gol_tpu_torch.models.lifelike import CONWAY, LifeLikeRule


def from_pixels(pixels: torch.Tensor) -> torch.Tensor:
    """{0,255} uint8 pixels → {0,1} uint8 cells."""
    return (pixels != 0).to(torch.uint8)


def to_pixels(cells: torch.Tensor) -> torch.Tensor:
    """{0,1} uint8 cells → {0,255} uint8 pixels."""
    return cells.to(torch.uint8) * 255


def neighbour_counts(cells: torch.Tensor) -> torch.Tensor:
    """8-neighbour live counts on the torus, separable roll-sum, on any
    tensor whose last two dims are (rows, cols)."""
    vert = (cells + torch.roll(cells, 1, dims=-2)
            + torch.roll(cells, -1, dims=-2))
    return (vert + torch.roll(vert, 1, dims=-1)
            + torch.roll(vert, -1, dims=-1) - cells)


def apply_rule(cells: torch.Tensor, counts: torch.Tensor,
               rule: LifeLikeRule = CONWAY) -> torch.Tensor:
    """Branch-free life-like rule application on {0,1} cells."""
    born_lut, survive_lut = rule.luts()
    idx = counts.long()
    born = torch.tensor(born_lut, dtype=torch.uint8, device=cells.device)[idx]
    survive = torch.tensor(survive_lut, dtype=torch.uint8,
                           device=cells.device)[idx]
    return torch.where(cells == 1, survive, born)


def step(cells: torch.Tensor, rule: LifeLikeRule = CONWAY) -> torch.Tensor:
    """One whole-board torus turn on {0,1} uint8 cells."""
    return apply_rule(cells, neighbour_counts(cells), rule)


def run_turns(cells: torch.Tensor, num_turns: int,
              rule: LifeLikeRule = CONWAY) -> torch.Tensor:
    """Advance `num_turns` turns."""
    for _ in range(num_turns):
        cells = step(cells, rule)
    return cells


def row_alive_counts(cells: torch.Tensor) -> torch.Tensor:
    """(..., H) int32 per-row live counts: each row holds at most W cells,
    so int32 is exact for any width a device can hold."""
    return cells.sum(dim=-1, dtype=torch.int32)


def alive_count_exact(cells: torch.Tensor) -> int:
    """Overflow-proof alive count: a 65536² board has 2^32 cells, past
    int32, so per-row int32 counts are summed in int64."""
    return int(row_alive_counts(cells).sum(dtype=torch.int64))
