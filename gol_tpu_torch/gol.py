"""Top-level entry: `run(params, events, key_presses)` — the counterpart of
`gol_tpu/gol.py` (reference `gol.Run`, `Local/gol/gol.go:12-40`).

`run` starts the distributor on a daemon thread and returns it; callers
consume `events` until the CLOSE sentinel.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Optional

from gol_tpu_torch.distributor import distributor
from gol_tpu_torch.params import Params

_log = logging.getLogger(__name__)


def run(
    p: Params,
    events: "queue.Queue",
    key_presses: Optional["queue.Queue"] = None,
    engine=None,
    images_dir: Optional[str] = None,
    out_dir: Optional[str] = None,
    live_view: bool = False,
    rule=None,
    device=None,
) -> threading.Thread:
    """Start a run. `engine` injects an engine (tests pass
    `Engine(device="cpu")`); otherwise the process's default engine runs
    on `device`, CUDA when None. `live_view` adds the CellsFlipped /
    TurnComplete feed. The returned thread's `exception` holds the run's
    failure, if any."""
    def _target() -> None:
        try:
            distributor(p, events, key_presses, engine, images_dir,
                        out_dir, live_view, rule, device)
        except BaseException as e:
            t.exception = e
            _log.exception("distributor failed")

    t = threading.Thread(target=_target, daemon=True,
                         name="gol-distributor")
    t.exception = None
    t.start()
    return t
