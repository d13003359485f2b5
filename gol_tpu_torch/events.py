"""Typed event API — the observability contract of the framework (a copy
of `gol_tpu/events.py`, texts identical).

Re-design of the reference event surface (`Local/gol/event.go:9-131`):
the `Event` interface (a Stringer plus `GetCompletedTurns`) and six concrete
events. Events flow over a `queue.Queue` from the distributor to the
SDL/ASCII view and to tests; the channel-close of the Go version is modelled
by the `CLOSE` sentinel pushed after the final event
(`Local/gol/distributor.go:226`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Tuple


class State(enum.Enum):
    """Reference `State` enum (`Local/gol/event.go:70-90`)."""

    PAUSED = "Paused"
    EXECUTING = "Executing"
    QUITTING = "Quitting"

    def __str__(self) -> str:  # matches Go String()
        return self.value


@dataclasses.dataclass(frozen=True)
class Event:
    """Base event; `completed_turns` mirrors GetCompletedTurns()."""

    completed_turns: int

    def __str__(self) -> str:
        return ""


@dataclasses.dataclass(frozen=True)
class AliveCellsCount(Event):
    """Emitted every 2 s by the telemetry ticker
    (reference `Local/gol/distributor.go:154-167`)."""

    cells_count: int = 0

    def __str__(self) -> str:
        return f"{self.cells_count} Alive Cells"


@dataclasses.dataclass(frozen=True)
class ImageOutputComplete(Event):
    """A PGM snapshot hit disk (`Local/gol/event.go:33-45`)."""

    filename: str = ""

    def __str__(self) -> str:
        return f"File {self.filename} output complete"


@dataclasses.dataclass(frozen=True)
class StateChange(Event):
    """Executing / Paused / Quitting transition (`event.go:47-68`)."""

    new_state: State = State.EXECUTING

    def __str__(self) -> str:
        return f"State change to {self.new_state}"


@dataclasses.dataclass(frozen=True)
class CellFlipped(Event):
    """A single cell changed value; feeds the live view
    (`event.go:92-100`; defined-but-unemitted in the reference — we emit it
    when a live view is attached)."""

    cell: Tuple[int, int] = (0, 0)  # (x, y)


@dataclasses.dataclass(frozen=True)
class CellsFlipped(Event):
    """Batched CellFlipped — one event per turn instead of one per cell,
    so the live view costs one host transfer per rendered frame."""

    cells: Tuple[Tuple[int, int], ...] = ()


@dataclasses.dataclass(frozen=True)
class TurnComplete(Event):
    """End-of-turn marker for the live view (`event.go:102-110`)."""


@dataclasses.dataclass(frozen=True)
class FinalTurnComplete(Event):
    """Terminal event carrying the alive-cell set; the test-harness hook
    (`event.go:112-124`, consumed at `Local/gol_test.go:32-37`).

    `alive_count` is always populated. For boards beyond
    GOL_MAX_EVENT_CELLS total cells (default 2^24) the `alive` tuple is
    left EMPTY — materialising ~10^9 coordinate tuples for a 65536²
    board would exhaust controller memory; at every reference scale the
    full list is present and `alive_count == len(alive)`."""

    alive: Tuple[Tuple[int, int], ...] = ()  # (x, y) pairs
    alive_count: int = -1  # -1 only for hand-built legacy instances

    def count(self) -> int:
        return self.alive_count if self.alive_count >= 0 else len(self.alive)


@dataclasses.dataclass(frozen=True)
class EngineLost(Event):
    """The controller lost its remote engine mid-run (connection failure
    or missed heartbeats). Framework extension beyond the reference —
    its only failure story is `log.Fatal` on dial errors
    (`Local/gol/distributor.go:96-98`); here the controller announces the
    loss and tries to reattach (see `GOL_RECONNECT`)."""

    def __str__(self) -> str:
        return "Engine connection lost"


@dataclasses.dataclass(frozen=True)
class EngineReattached(Event):
    """The controller reattached to a recovered engine and resumed the run
    from the engine's authoritative (world, turn) — the automated version
    of the reference's manual CONT=yes reattach."""

    def __str__(self) -> str:
        return "Engine connection restored"


class _Close:
    """Sentinel marking the end of the event stream (Go channel close)."""

    def __repr__(self) -> str:
        return "<events closed>"


CLOSE = _Close()


def drain(events_queue) -> List[Event]:
    """Collect every event until CLOSE. Test helper mirroring the
    `for event := range events` pattern (`Local/gol_test.go:32`)."""
    out: List[Event] = []
    while True:
        ev = events_queue.get()
        if ev is CLOSE:
            return out
        out.append(ev)
