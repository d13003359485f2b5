"""Headless CLI — the counterpart of `gol_tpu/main.py` without its live
window and its observability, checkpoint and RLE options.

    python -m gol_tpu_torch -w 512 -h 512 --turns 100 --headless
    python -m gol_tpu_torch -w 64 -h 64 --turns 100 --headless --device cpu
    python -m gol_tpu_torch -w 64 -h 64 --turns 100 --headless --rule /2/3 \
        --device cpu

Events print as `Completed Turns <n>  <event>`; on a terminal the keys
s/p/q/k go to the run.
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading

from gol_tpu_torch import events as ev
from gol_tpu_torch.gol import run
from gol_tpu_torch.params import Params


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Game of Life on one CUDA GPU (PyTorch port)",
        add_help=False)
    ap.add_argument("--help", action="help")
    ap.add_argument("-t", "--threads", type=int, default=8,
                    help="reference thread count (kept for parity)")
    ap.add_argument("-w", "--width", type=int, default=512)
    ap.add_argument("-h", "--height", type=int, default=512)
    ap.add_argument("--turns", type=int, default=10_000_000_000)
    ap.add_argument("--headless", action="store_true",
                    help="print events instead of drawing (the port's "
                         "only view)")
    ap.add_argument("--rule", metavar="RULE", default="",
                    help="life-like rulestring, e.g. 'B36/S23', or "
                         "Generations 'survival/birth/states', e.g. "
                         "'/2/3' (Brian's Brain) or '345/2/4' (Star "
                         "Wars); default Conway")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the engine (default cuda)")
    return ap.parse_args(argv)


def _stdin_key_reader(key_presses: "queue.Queue",
                      stop: threading.Event) -> None:
    """Forward s/p/q/k keystrokes; select() lets the thread see `stop`."""
    import select

    while not stop.is_set():
        try:
            ready, _, _ = select.select([sys.stdin], [], [], 0.2)
        except (OSError, ValueError):
            return
        if not ready:
            continue
        ch = sys.stdin.read(1)
        if not ch:
            return
        if ch in ("s", "p", "q", "k"):
            key_presses.put(ch)
        if ch in ("q", "k"):
            return


def _print_events(events_q: "queue.Queue",
                  key_presses: "queue.Queue") -> None:
    """Print events until CLOSE, with keys read from a terminal stdin."""
    stop = threading.Event()
    old = None
    if sys.stdin.isatty():
        import termios
        import tty

        old = termios.tcgetattr(sys.stdin.fileno())
        tty.setcbreak(sys.stdin.fileno())
        threading.Thread(target=_stdin_key_reader,
                         args=(key_presses, stop), daemon=True).start()
    try:
        while True:
            e = events_q.get()
            if e is ev.CLOSE:
                return
            text = str(e)
            if text:
                print(f"Completed Turns {e.completed_turns:<8}{text}")
    finally:
        stop.set()
        if old is not None:
            import termios

            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN, old)


def main(argv=None) -> int:
    args = parse_args(argv)
    rule = None
    if args.rule:
        from gol_tpu_torch.models import parse_rule

        rule = parse_rule(args.rule)  # fail fast on a malformed string
    p = Params(threads=args.threads, image_width=args.width,
               image_height=args.height, turns=args.turns)
    events_q: "queue.Queue" = queue.Queue(maxsize=10000)
    key_presses: "queue.Queue" = queue.Queue(maxsize=10)
    t = run(p, events_q, key_presses, rule=rule, device=args.device)
    _print_events(events_q, key_presses)
    t.join(30)
    return 1 if t.exception is not None else 0


if __name__ == "__main__":
    sys.exit(main())
