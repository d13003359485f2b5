"""Headless CLI — the counterpart of `gol_tpu/main.py` without its live
window and its observability and RLE options.

    python -m gol_tpu_torch -w 512 -h 512 --turns 100 --headless
    python -m gol_tpu_torch -w 64 -h 64 --turns 100 --headless --device cpu
    python -m gol_tpu_torch -w 64 -h 64 --turns 100 --headless --rule /2/3 \
        --device cpu
    python -m gol_tpu_torch -w 512 -h 512 --turns 100000 --headless \
        --checkpoint ckpt --ckpt-every 4096
    python -m gol_tpu_torch --turns 100000 --headless --resume ckpt

Events print as `Completed Turns <n>  <event>`; on a terminal the keys
s/p/q/k/c go to the run ('c' writes a manifest checkpoint).
"""

from __future__ import annotations

import argparse
import os
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
    ap.add_argument("--checkpoint", metavar="DIR", default="",
                    help="checkpoint directory (sets GOL_CKPT): the "
                         "engine writes gol-ckpt/1 manifest checkpoints "
                         "here when --ckpt-every is set, plus the legacy "
                         "time-based autosave; 'c' writes one on demand")
    ap.add_argument("--ckpt-every", metavar="TURNS", type=int, default=0,
                    help="manifest checkpoint cadence in TURNS (sets "
                         "GOL_CKPT_EVERY_TURNS; 0 = off; requires "
                         "--checkpoint)")
    ap.add_argument("--ckpt-keep", metavar="N", type=int, default=0,
                    help="retention: keep the newest N checkpoints "
                         "(sets GOL_CKPT_KEEP; default 3)")
    ap.add_argument("--journal", metavar="DIR", default="",
                    help="journal the run into a hash-chained "
                         "gol-journal/1 log under DIR (sets GOL_JOURNAL)")
    ap.add_argument("--journal-digest-every", metavar="TURNS", type=int,
                    default=0,
                    help="journal a board digest every TURNS (sets "
                         "GOL_JOURNAL_DIGEST_EVERY; default 512)")
    ap.add_argument("--resume", metavar="DIR|MANIFEST|NPZ", nargs="?",
                    const="", default=None,
                    help="resume from a checkpoint of either package "
                         "before running: a directory (newest durable "
                         "manifest wins), a ckpt-*.json manifest (payload "
                         "SHA-256 verified; its rule and board size are "
                         "adopted), or a legacy .npz; bare --resume uses "
                         "--checkpoint / GOL_CKPT. With SER set the "
                         "SERVER adopts the checkpoint from its own "
                         "configured directory (RestoreRun)")
    return ap.parse_args(argv)


def _stdin_key_reader(key_presses: "queue.Queue",
                      stop: threading.Event) -> None:
    """Forward s/p/q/k/c keystrokes; select() lets the thread see
    `stop`."""
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
        if ch in ("s", "p", "q", "k", "c"):
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


def _resume(args, rule):
    """Restore the checkpoint `args.resume` names into the engine the
    run will use; returns (rule, restored turn). A manifest's rule and
    board size are adopted unless given. With SER set the server adopts
    it from its own configured directory."""
    from gol_tpu_torch import ckpt as ckpt_mod
    from gol_tpu_torch.distributor import _resolve_engine
    from gol_tpu_torch.models import parse_rule

    if os.environ.get("SER"):
        return rule, _resolve_engine(rule).restore_run(args.resume)
    ref = args.resume or os.environ.get(ckpt_mod.CKPT_DIR_ENV, "")
    if not ref:
        raise ValueError("--resume needs DIR|MANIFEST|NPZ (or "
                         "--checkpoint / GOL_CKPT to name the directory)")
    kind, target = ckpt_mod.resolve(ref)
    if kind == "manifest":
        m = ckpt_mod.read_manifest(target)
        if rule is None:
            rule = parse_rule(m["rule"])
        if m.get("board"):
            # The out/WxHxT.pgm name describes the RESTORED board.
            args.width = int(m["board"]["w"])
            args.height = int(m["board"]["h"])
    eng = _resolve_engine(rule, args.device)
    return rule, eng.restore_run(target)


def main(argv=None) -> int:
    args = parse_args(argv)
    rule = None
    if args.rule:
        from gol_tpu_torch.models import parse_rule

        rule = parse_rule(args.rule)  # fail fast on a malformed string
    from gol_tpu_torch import ckpt as ckpt_mod

    ckpt_mod.export_flags(args)
    if args.resume is not None:
        try:
            rule, turn = _resume(args, rule)
        except (OSError, ValueError, RuntimeError) as e:
            print(f"gol_tpu_torch: {e}", file=sys.stderr)
            return 2
        # Reattach to the restored engine-held state — the CONT=yes
        # contract — instead of seeding a fresh board from images/.
        os.environ["CONT"] = "yes"
        print(f"resuming at turn {turn}", flush=True)
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
