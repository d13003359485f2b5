"""Headless CLI — the counterpart of `gol_tpu/main.py` without its live
window (`--live` waits for ROADMAP A13(d)).

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
    python -m gol_tpu_torch -w 1048576 -h 1048576 --sparse --rle rpentomino \
        --turns 8192 --headless
    python -m gol_tpu_torch -w 512 -h 512 --turns 10000 --headless \
        --profile-dir prof --profile-turns 64 --run-report run.jsonl \
        --trace-spans spans.json --metrics-port 0

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
    ap.add_argument("--trace", metavar="DIR", default="",
                    help="write one torch.profiler Chrome trace of a "
                         "representative chunk to DIR (sets GOL_TRACE)")
    ap.add_argument("--profile-dir", metavar="DIR", default="",
                    help="capture a torch.profiler Chrome trace "
                         "(*.trace.json) of the run's first "
                         "--profile-turns turns into DIR; equivalent to "
                         "GOL_PROFILE_DIR=DIR")
    ap.add_argument("--profile-turns", type=int, default=0, metavar="N",
                    help="turns per profiler capture (sets "
                         "GOL_PROFILE_TURNS; default 256)")
    ap.add_argument("--run-report", metavar="PATH", default="",
                    help="append a JSON-lines chunk-timeline run report "
                         "(schema gol-run-report/1) to PATH; equivalent "
                         "to GOL_RUN_REPORT=PATH")
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve Prometheus text on "
                         "http://127.0.0.1:PORT/metrics, plus /healthz "
                         "and /profile (0 = ephemeral port; unset = no "
                         "endpoint)")
    ap.add_argument("--trace-spans", metavar="PATH", default="",
                    help="export controller/RPC/engine spans as Chrome "
                         "trace-event JSON to PATH when the run ends; "
                         "equivalent to GOL_TRACE_SPANS=PATH (a "
                         "directory gets one file per pid)")
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
    ap.add_argument("--sparse", action="store_true",
                    help="run on the sparse-torus engine: -w/-h give the "
                         "TORUS size (equal, multiple of 32 — e.g. "
                         "1048576 = 2^20) and --rle gives the seed; only "
                         "the live window is ever held, snapshots and the "
                         "final PGM are that window")
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
    import numpy as np

    cells, pw, ph, rle_rule = _parse_rle_arg(name_or_path)
    if pw > width or ph > height:
        raise ValueError(
            f"pattern extent {pw}x{ph} exceeds board {width}x{height}")
    board = np.zeros((height, width), dtype=np.uint8)
    ox, oy = (width - pw) // 2, (height - ph) // 2
    for x, y in cells:
        board[oy + y, ox + x] = 255
    return (_stage_tmp_pgm(board, f"{width}x{height}.pgm", "gol_rle_"),
            rle_rule)


def _stage_tmp_pgm(board, filename: str, prefix: str) -> str:
    """Write `board` as `<fresh temp dir>/<filename>` (removed at exit);
    returns the directory."""
    import atexit
    import shutil
    import tempfile

    from gol_tpu_torch.io.pgm import write_pgm

    d = tempfile.mkdtemp(prefix=prefix)
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    write_pgm(os.path.join(d, filename), board)
    return d


def _stage_sparse_seed(name_or_path: str):
    """Write an RLE pattern as `<temp dir>/seed.pgm` at its own bounding
    box's dims — the sparse controller's board source (the engine stamps
    its live cells centred on the torus). Returns (images_dir,
    rle_declared_rule_or_None)."""
    import numpy as np

    cells, pw, ph, rle_rule = _parse_rle_arg(name_or_path)
    board = np.zeros((ph, pw), dtype=np.uint8)
    for x, y in cells:
        board[y, x] = 255
    return _stage_tmp_pgm(board, "seed.pgm", "gol_sparse_"), rle_rule


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
    from gol_tpu_torch.distributor import (
        _resolve_engine,
        _resolve_sparse_engine,
    )
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
        if args.sparse and m["repr"] == "sparse" and m.get("board"):
            # A sparse manifest knows its torus size.
            args.width = args.height = int(m["board"]["w"])
        elif not args.sparse and m.get("board"):
            # The out/WxHxT.pgm name describes the RESTORED board.
            args.width = int(m["board"]["w"])
            args.height = int(m["board"]["h"])
    eng = (_resolve_sparse_engine(args.width, rule, args.device)
           if args.sparse else _resolve_engine(rule, args.device))
    return rule, eng.restore_run(target)


def _export_obs_flags(args) -> None:
    """The observability flags travel as env, read by the engine at run
    start (so a forked or remote engine inherits them), as in the JAX
    CLI; `--metrics-port` starts its endpoint here."""
    from gol_tpu_torch.engine import TRACE_ENV
    from gol_tpu_torch.obs import prof as obs_prof
    from gol_tpu_torch.obs import trace as obs_trace
    from gol_tpu_torch.obs.timeline import RUN_REPORT_ENV

    for flag, env in ((args.trace, TRACE_ENV),
                      (args.profile_dir, obs_prof.PROFILE_DIR_ENV),
                      (args.run_report, RUN_REPORT_ENV),
                      (args.trace_spans, obs_trace.TRACE_SPANS_ENV)):
        if flag:
            os.environ[env] = flag
    if args.profile_turns:
        os.environ[obs_prof.PROFILE_TURNS_ENV] = str(args.profile_turns)
    obs_trace.set_process_name("gol-controller")
    if args.metrics_port is not None:
        from gol_tpu_torch.obs.http import start_metrics_server
        from gol_tpu_torch.obs.log import log as obs_log

        msrv = start_metrics_server(args.metrics_port)
        obs_log("metrics.serving", url=msrv.url, port=msrv.port)


def main(argv=None) -> int:
    args = parse_args(argv)
    _export_obs_flags(args)
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
    if args.sparse:
        if not args.rle and os.environ.get("CONT", "") != "yes":
            print("gol_tpu_torch: --sparse needs --rle (the seed pattern) "
                  "unless CONT=yes resumes an engine-held run",
                  file=sys.stderr)
            return 2
        if args.width != args.height or args.width % 32:
            print(f"gol_tpu_torch: --sparse torus must be square and a "
                  f"multiple of 32, got {args.width}x{args.height}",
                  file=sys.stderr)
            return 2
        if args.rle:
            try:
                images_dir, rle_rule = _stage_sparse_seed(args.rle)
            except (OSError, ValueError) as e:
                print(f"gol_tpu_torch: --rle {args.rle}: {e}",
                      file=sys.stderr)
                return 2
            if rule is None:
                rule = rle_rule
    elif args.rle:
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
            images_dir=images_dir, sparse=args.sparse)
    _print_events(events_q, key_presses)
    t.join(30)
    # Export whatever spans the run recorded (no-op without
    # --trace-spans / GOL_TRACE_SPANS; never raises).
    from gol_tpu_torch.obs import trace as obs_trace

    obs_trace.export_from_env()
    return 1 if t.exception is not None else 0


if __name__ == "__main__":
    sys.exit(main())
