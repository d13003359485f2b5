"""Peaks of the card and the least time a step of Life can take.

The floor of work per cell update. A cell's next state depends on nine
cells, and no linear map gives it, so some instruction outside the
tensor cores writes each new state. Such an instruction writes at most
32 bits a thread, so it yields at most 32 new states: at least 1/32 of
a thread-instruction per cell update, whatever the method (bit-sliced
logic, adders, tables). An SM issues at most one warp instruction a
clock on each of its 4 schedulers, 128 thread-instructions a clock, so
no method updates more than 128 x 32 = 4,096 cells a clock on an SM.
A tensor-core method needs at least the nine products of the
neighbourhood sum per cell, and 1,979e12 int8 operations a second give
it fewer cells a second than that. The issue rate, not the logic
pipe's 64 a clock, is the peak, because the floor counts any
instruction.

The floor of bytes. A call reads the board and writes it once: two
bits a cell, at the published HBM bandwidth.
"""

from __future__ import annotations

# Published figures (NVIDIA's H100 SXM data sheet): boost clock, HBM
# bandwidth. The SM count is read from the card.
CARDS = {
    "NVIDIA H100 80GB HBM3": {"boost_hz": 1.98e9, "hbm_bytes_per_s": 3.35e12},
}

WARP_ISSUE_PER_CLK_PER_SM = 4
THREADS_PER_WARP = 32
CELLS_PER_THREAD_INSTRUCTION = 32


def card(name: str):
    return CARDS.get(name)


def cell_updates_ceiling(spec: dict, sms: int) -> float:
    """Cell updates a second that no method exceeds on the card."""
    return (sms * WARP_ISSUE_PER_CLK_PER_SM * THREADS_PER_WARP
            * CELLS_PER_THREAD_INSTRUCTION * spec["boost_hz"])


def least_seconds(cell_updates: float, calls: int, board_cells: int,
                  spec: dict, sms: int) -> tuple:
    """(seconds, "operations" | "bytes"): the least time for
    `cell_updates` made by `calls` calls that each read and write a
    board of `board_cells` one-bit cells."""
    t_ops = cell_updates / cell_updates_ceiling(spec, sms)
    t_bytes = calls * 2 * board_cells / 8 / spec["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
