"""View/event loop — counterpart of `gol_tpu/sdl/loop.py` and of the
reference's `Local/sdl/loop.go:9-49`.

Consumes the events queue (CellFlipped/CellsFlipped → pixel flips,
TurnComplete → render, anything with a non-empty str() → printed as
`Completed Turns <n>  <event>`, matching `loop.go:42-44`), forwards
keyboard input (s/p/q/k, and 'c' for a manifest checkpoint) to the
key_presses queue, and returns when the event stream closes
(`loop.go:31-34`).
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Optional

from gol_tpu_torch import events as ev
from gol_tpu_torch.distributor import live_view_shape
from gol_tpu_torch.params import Params
from gol_tpu_torch.sdl.window import Window


def _stdin_key_reader(key_presses: "queue.Queue", stop: threading.Event):
    """Stdin reader thread: forwards s/p/q/k/c keystrokes. Terminal mode is
    owned by `start()` (set + restored there). select() gates every
    read(1) so the thread actually exits when `stop` is set — a reader
    parked in a blocking read would outlive its run and steal the user's
    next keystroke (or race a later `start()`'s reader for stdin)."""
    import select

    while not stop.is_set():
        try:
            ready, _, _ = select.select([sys.stdin], [], [], 0.2)
        except (OSError, ValueError):  # stdin closed under us
            return
        if not ready:
            continue
        ch = sys.stdin.read(1)
        if not ch:
            return
        if ch in ("s", "p", "q", "k", "c"):
            key_presses.put(ch)
        if ch in ("q", "k"):
            return


class _RawTerminal:
    """cbreak-mode guard: restores the user's terminal settings on exit
    even if the reader thread is still parked in read(1)."""

    def __init__(self) -> None:
        self._old = None
        self._fd = None

    def __enter__(self):
        if sys.stdin.isatty():
            import termios
            import tty

            self._fd = sys.stdin.fileno()
            self._old = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
        return self

    def __exit__(self, *exc):
        if self._old is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._old)
        return False


def start(
    p: Params,
    events_q: "queue.Queue",
    key_presses: Optional["queue.Queue"] = None,
    window: Optional[Window] = None,
    headless: bool = False,
) -> None:
    """Blocks until the event stream closes (reference `sdl.Start`). The
    window it opens has the live feed's frame size: the board's, or the
    downsampled view's above GOL_LIVE_MAX_CELLS."""
    win = None
    if not headless:
        if window is None:
            rows, cols = live_view_shape(p.image_width, p.image_height)
            window = Window(cols, rows)
        win = window

    stop = threading.Event()
    term = _RawTerminal()
    if key_presses is not None and sys.stdin.isatty():
        term.__enter__()
        threading.Thread(
            target=_stdin_key_reader, args=(key_presses, stop), daemon=True
        ).start()

    try:
        while True:
            if win is not None:
                key = win.poll_event()
                if key == "quit":
                    key = "q"
                if key and key_presses is not None:
                    key_presses.put(key)
            try:
                e = events_q.get(timeout=0.05)
            except queue.Empty:
                continue
            if e is ev.CLOSE:
                return
            if isinstance(e, ev.CellFlipped) and win is not None:
                win.flip_pixel(*e.cell)
            elif isinstance(e, ev.CellsFlipped) and win is not None:
                for cell in e.cells:
                    win.flip_pixel(*cell)
            elif isinstance(e, ev.TurnComplete) and win is not None:
                win.render_frame(f"Completed Turns {e.completed_turns}")
            else:
                text = str(e)
                if text:
                    print(f"Completed Turns {e.completed_turns:<8}{text}")
    finally:
        stop.set()
        term.__exit__()
        if win is not None:
            win.close()
