"""Faults planted under the timed path: the engine's stepping function,
as `gol_tpu_torch.engine` picks it for a board. Only the control runs
(`control.py`) and the tests plant them; a benchmark run never does.

- `control`: the plain reference put in the program's place, with the
  configuration's one guarantee it can break broken: the torus (cells
  beyond an edge are dead);
- `stale`: a step that returns its board unchanged;
- `frozen`: from the end of the set-up on (`Plant.trip`, which the flow
  calls through `Env.on_warm`), a step that does its work and returns
  its board unchanged: the turn advances at the same pace and the
  published counts are the frozen board's;
- `half`: the bottom half of the board left unstepped;
- `flip`: one cell of each stepped board altered where it is produced;
- `token`: the alive count each chunk publishes altered by one.
"""

from __future__ import annotations

import contextlib

FAULTS = ("control", "stale", "frozen", "half", "flip", "token")


class Plant:
    """A planted fault's handle: `trip` arms what waits for the end of
    the set-up."""

    def __init__(self) -> None:
        self.tripped = False

    def trip(self) -> None:
        self.tripped = True


def _popcount(words):
    import torch

    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    return ((words.unsqueeze(-1) >> shifts) & 1).sum(dtype=torch.int64)


@contextlib.contextmanager
def planted(name: str, reference, rule: str):
    """Plant fault `name` for the body of the `with`, which gets its
    `Plant`."""
    from gol_tpu_torch import engine

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    real = engine.select_representation
    parsed = reference.parse_rule(rule)
    handle = Plant()

    def control(cells, k, _rule):
        for _ in range(k):
            cells = reference.step(cells, parsed, wrap=False)
        return cells

    def select(width):
        packed, run = real(width)
        if name == "control":
            return False, control
        if not packed:
            raise ValueError("faults other than the control need a packed "
                             "board")

        def faulty(cells, k, rule_, count=None):
            if name == "stale":
                out = cells.clone()
            else:
                out = run(cells, k, rule_, count=count)
            if name == "frozen" and handle.tripped:
                out = cells.clone()
            if name == "half":
                h = out.shape[-2] // 2
                out[..., h:, :] = cells[..., h:, :]
            elif name == "flip":
                out[..., 0, 0] ^= 1
            if count is not None:
                if name in ("stale", "frozen", "half"):
                    count.fill_(_popcount(out))
                elif name == "token":
                    count += 1
            return out

        return True, faulty

    engine.select_representation = select
    try:
        yield handle
    finally:
        engine.select_representation = real
