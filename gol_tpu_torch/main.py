"""Headless CLI — the counterpart of `gol_tpu/main.py` without its live
window, its observability options and `--sparse` (ROADMAP A10).

    python -m gol_tpu_torch -w 512 -h 512 --turns 100 --headless
    python -m gol_tpu_torch -w 64 -h 64 --turns 100 --headless --device cpu
    python -m gol_tpu_torch -w 64 -h 64 --turns 100 --headless --rule /2/3 \
        --device cpu
    python -m gol_tpu_torch -w 512 -h 512 --turns 100 --headless \
        --rule R5,C0,M1,S33..57,B34..45,NM
    python -m gol_tpu_torch -w 32 -h 32 --turns 8 --headless --rle glider
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
                    help="life-like rulestring, e.g. 'B36/S23'; "
                         "Generations 'survival/birth/states', e.g. "
                         "'/2/3' (Brian's Brain) or '345/2/4' (Star "
                         "Wars); Larger-than-Life "
                         "'R5,C0,M1,S33..57,B34..45,NM' (Bosco); or "
                         "Lenia 'lenia:r=13,mu=0.15,sigma=0.015,dt=0.1' "
                         "(Orbium); default Conway. With SER set, the "
                         "remote engine's own rule governs the run")
    ap.add_argument("--rle", metavar="NAME|FILE", default="",
                    help="seed the board from an RLE pattern instead of "
                         "images/WxH.pgm: a library name (glider, lwss, "
                         "rpentomino, gosper-gun, blinker) or a .rle file, "
                         "stamped centred on an empty WxH torus")
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


def _parse_rle_arg(name_or_path: str):
    """(cells, pw, ph, rle_declared_rule_or_None) from a library pattern
    name or a .rle file path."""
    from gol_tpu_torch.io.rle import parse_rle, read_rle
    from gol_tpu_torch.models.patterns import PATTERNS

    if name_or_path in PATTERNS:
        return parse_rle(PATTERNS[name_or_path])
    return read_rle(name_or_path)


def _stage_rle_board(name_or_path: str, width: int, height: int):
    """Stamp an RLE pattern (library name or file path) centred on an
    empty width x height board and write it as `WxH.pgm` in a fresh temp
    images dir, removed at exit. Returns (images_dir,
    rle_declared_rule_or_None)."""
    import atexit
    import shutil
    import tempfile

    import numpy as np

    from gol_tpu_torch.io.pgm import write_pgm

    cells, pw, ph, rle_rule = _parse_rle_arg(name_or_path)
    if pw > width or ph > height:
        raise ValueError(
            f"pattern extent {pw}x{ph} exceeds board {width}x{height}")
    board = np.zeros((height, width), dtype=np.uint8)
    ox, oy = (width - pw) // 2, (height - ph) // 2
    for x, y in cells:
        board[oy + y, ox + x] = 255
    d = tempfile.mkdtemp(prefix="gol_rle_")
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    write_pgm(os.path.join(d, f"{width}x{height}.pgm"), board)
    return d, rle_rule


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
        if os.environ.get("SER"):
            import warnings

            warnings.warn(
                f"--rule {rule.rulestring} has no effect with SER set: "
                "the REMOTE engine's own rule governs the run — start "
                "the server with --rule to match")
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
    images_dir = None
    if args.rle:
        # Materialise the pattern as the WxH.pgm the distributor expects
        # (in a temp images dir): the PGM board source stays the single
        # entry path. An RLE-declared rule applies unless --rule
        # overrode it.
        try:
            images_dir, rle_rule = _stage_rle_board(
                args.rle, args.width, args.height)
        except (OSError, ValueError) as e:
            print(f"gol_tpu_torch: --rle {args.rle}: {e}", file=sys.stderr)
            return 2
        if rule is None:
            rule = rle_rule
            if rle_rule is not None and os.environ.get("SER"):
                import warnings

                warnings.warn(
                    f"--rle declares rule {rle_rule.rulestring}, but with "
                    "SER set the REMOTE engine's own rule governs the "
                    "run — start the server with --rule to match")
    events_q: "queue.Queue" = queue.Queue(maxsize=10000)
    key_presses: "queue.Queue" = queue.Queue(maxsize=10)
    t = run(p, events_q, key_presses, rule=rule, device=args.device,
            images_dir=images_dir)
    _print_events(events_q, key_presses)
    t.join(30)
    return 1 if t.exception is not None else 0


if __name__ == "__main__":
    sys.exit(main())
